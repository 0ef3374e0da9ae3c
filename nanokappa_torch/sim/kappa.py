"""Thermal conductivity from subvolume observables (host side, tiny arrays).

Reference classes/Population.py:749-788: for slice subvolumes kappa follows
the 1-D Fourier law with reservoir temperatures padded at the ends; otherwise
a per-connection kappa is computed from the centre-to-centre projected flux.
"""

from __future__ import annotations

import numpy as np

from nanokappa_torch.constants import A_IN_M


def kappa_slice(
    T_sv: np.ndarray,  # (SV,)
    phi_sv: np.ndarray,  # (SV,3) W/m^2
    Np_sv: np.ndarray,  # (SV,)
    res_T: np.ndarray,  # (2,) reservoir temperatures [first, last]
    bounds_len: float,  # domain extent along the slice axis, angstrom
    slice_axis: int,
):
    """Returns (kappa_sv (SV,), kappa_total) in W/m/K."""
    n_sv = len(T_sv)
    T = np.zeros(n_sv + 2)
    T[1:-1] = T_sv
    T[0], T[-1] = res_T[0], res_T[-1]

    phi = phi_sv[:, slice_axis]
    dx = 2 * bounds_len * A_IN_M / n_sv
    dT = T[2:] - T[:-2]
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        kappa_sv = -phi * dx / dT
    kappa_sv[~np.isfinite(kappa_sv)] = 0.0

    DX = bounds_len * A_IN_M * (1 + n_sv) / n_sv
    DT = T[-1] - T[0]
    N_p = max(Np_sv.sum(), 1)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        kappa_total = -np.sum(phi * Np_sv) * (DX / DT) / N_p
    if not np.isfinite(kappa_total):
        kappa_total = 0.0
    return kappa_sv, float(kappa_total)


def kappa_connections(
    T_sv: np.ndarray,
    phi_sv: np.ndarray,  # (SV,3) W/m^2
    centers: np.ndarray,  # (SV,3) angstrom
    connections: np.ndarray,  # (C,2)
) -> np.ndarray:
    """Per-connection kappa (W/m/K), reference classes/Population.py:773-788."""
    i, j = connections[:, 0], connections[:, 1]
    dx = centers[j] - centers[i]
    L = np.linalg.norm(dx, axis=1)
    n = dx / L[:, None]
    dT = T_sv[j] - T_sv[i]
    phi = (phi_sv[i] + phi_sv[j]) / 2
    phi_n = np.einsum("cj,cj->c", phi, n)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        k = np.where(dT == 0, 0.0, -phi_n * L * A_IN_M / dT)
    return k
