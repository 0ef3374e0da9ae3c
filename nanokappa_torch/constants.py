"""Physical constants in the simulation unit system.

Unit system (same convention as the reference solver, classes/Constants.py:6-13):
  length      : angstrom (A)
  time        : picosecond (ps)
  energy      : electron-volt (eV)
  frequency   : rad * THz (angular)
  velocity    : A * THz  (= 100 m/s)
  wavevector  : rad / A
  temperature : K
"""

import math

# hbar in eV*ps/rad  (6.582119569e-16 eV*s * 1e12 ps/s)
HBAR = 6.582119569e-4
# Boltzmann constant in eV/K
KB = 8.617333262e-5
# J per eV
EV_IN_J = 1.602176634e-19
# m per angstrom
A_IN_M = 1e-10
# s per ps
PS_IN_S = 1e-12
# conversion: eV / (ps * A^2)  ->  W / m^2
EVPSA2_IN_WM2 = EV_IN_J / (PS_IN_S * A_IN_M**2)
# conversion used for kappa: (eV/ps/A^2) * A / K -> W/(m K) handled via A_IN_M

PI = math.pi
