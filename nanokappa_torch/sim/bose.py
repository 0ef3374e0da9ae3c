"""Device Bose-Einstein occupation math, formulated for float32 stability.

Particle occupations are stored as deviations from a fixed reference
temperature, ``dev = n - n0(T_ref, omega_m)``; occupation differences are
evaluated analytically with expm1:

    n0(T) - n0(T0) = (expm1(x0) - expm1(x)) / (expm1(x) * expm1(x0)),
    x = hbar*omega / (kB*T).

The torch twin of nanokappa_tpu/sim/bose.py: the same masking and the same
float32 operation order.
"""

from __future__ import annotations

import torch

from nanokappa_torch.constants import HBAR, KB

_X_MAX = 80.0  # exp overflow guard; masked lanes never overflow


def _as_tensor_like(T, omega: torch.Tensor) -> torch.Tensor:
    """A python-float temperature becomes a float32 tensor of omega's shape
    (the JAX package's weak-typed scalar rounds to float32 the same way)."""
    if isinstance(T, torch.Tensor):
        return T
    return torch.full_like(omega, float(T))


def _expm1_x(T, omega):
    """expm1(hbar*omega / kB T) with masking for T<=0 / omega<=0."""
    T = _as_tensor_like(T, omega)
    ok = (T > 0) & (omega > 0)
    x = torch.where(ok, omega * HBAR / (torch.where(ok, T, 1.0) * KB), 1.0)
    x = torch.clamp(x, max=_X_MAX)
    return torch.expm1(x), ok


def occupation_delta_T(T, T_ref, omega):
    """g = n0(T, omega) - n0(T_ref, omega), elementwise, f32-stable."""
    eT, okT = _expm1_x(T, omega)
    eR, okR = _expm1_x(T_ref, omega)
    nT = torch.where(okT, 1.0 / eT, 0.0)
    nR = torch.where(okR, 1.0 / eR, 0.0)
    both = okT & okR
    return torch.where(both, (eR - eT) / (eT * eR), nT - nR)


def occupation_delta_omega(T_ref, omega_a, omega_b):
    """n0(T_ref, omega_a) - n0(T_ref, omega_b), f32-stable (specular
    reflections conserve the absolute occupation while the mode's reference
    occupation changes, classes/Population.py:941-971)."""
    eA, okA = _expm1_x(T_ref, omega_a)
    eB, okB = _expm1_x(T_ref, omega_b)
    nA = torch.where(okA, 1.0 / eA, 0.0)
    nB = torch.where(okB, 1.0 / eB, 0.0)
    both = okA & okB
    return torch.where(both, (eB - eA) / (eA * eB), nA - nB)
