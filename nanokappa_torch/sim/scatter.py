"""Relaxation-time (RTA) scattering toward the local Bose-Einstein occupation.

n <- n0(T) + (n - n0(T)) * exp(-dt / tau(T, m))   (classes/Population.py:1701-1710)

Torch twin of nanokappa_tpu/sim/scatter.py: lifetimes are gathered from the
(nT, M) table with a linear interpolation in T, clamped at the table edges.
"""

from __future__ import annotations

import torch

from nanokappa_torch.material.tables import MaterialTables
from nanokappa_torch.sim.bose import occupation_delta_T


def _bin(mat: MaterialTables, T: torch.Tensor) -> torch.Tensor:
    nT = mat.tau_T.shape[0]
    return torch.clamp(torch.searchsorted(mat.tau_T, T) - 1, 0, max(nT - 2, 0))


def lifetime_lookup(mat: MaterialTables, T: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
    """tau(T, mode) per particle: the T-lerp of the paired (nT, M, 2)
    table at each particle's own temperature (the linear-interpolation
    path; nearest temperatures take lifetime_by_sv)."""
    nT = mat.tau_T.shape[0]
    i = _bin(mat, T)
    w = (T - mat.tau_T[i]) / torch.clamp(
        mat.tau_T[torch.clamp(i + 1, max=nT - 1)] - mat.tau_T[i], min=1e-30
    )
    w = torch.clamp(w, 0.0, 1.0)
    M = mat.tau.shape[1]
    pair = mat.tau_pair.reshape(-1, 2)[i * M + mode.long()]
    return pair[:, 0] * (1 - w) + pair[:, 1] * w


def blend_tau_sv(mat: MaterialTables, T_sv: torch.Tensor) -> torch.Tensor:
    """(SV, M) per-subvolume lifetime table: the T-lerp of the (nT, M)
    table at each subvolume temperature (hoisted out of the event rounds)."""
    nT = mat.tau_T.shape[0]
    i = _bin(mat, T_sv)
    hi = torch.clamp(i + 1, max=nT - 1)
    w = (T_sv - mat.tau_T[i]) / torch.clamp(mat.tau_T[hi] - mat.tau_T[i], min=1e-30)
    w = torch.clamp(w, 0.0, 1.0)
    return mat.tau[i] * (1.0 - w)[:, None] + mat.tau[hi] * w[:, None]


def lifetime_by_sv(
    mat: MaterialTables, T_sv: torch.Tensor, sv: torch.Tensor,
    mode: torch.Tensor, tau_sv: torch.Tensor | None = None,
) -> torch.Tensor:
    """tau(T_sv[sv], mode) via the per-subvolume blended table; bitwise
    equal to the per-particle lerp at T_sv[sv]."""
    if tau_sv is None:
        tau_sv = blend_tau_sv(mat, T_sv)
    M = mat.tau.shape[1]
    sv_c = torch.clamp(sv, 0, T_sv.shape[0] - 1).long()
    return tau_sv.reshape(-1)[sv_c * M + mode.long()]


def slope_pair(
    mat: MaterialTables, T_sv: torch.Tensor, sv: torch.Tensor,
    mode: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the piecewise-linear lifetime tau(T) = a + b*T on the
    T-grid bin containing each particle's SUBVOLUME temperature: within that
    bin a + b*T is exactly the table's lerp, so the cached pair stays
    exact while T_sv drifts inside the bin."""
    nT = mat.tau_T.shape[0]
    i_sv = _bin(mat, T_sv)  # (SV,)
    sv_c = torch.clamp(sv, 0, T_sv.shape[0] - 1).long()
    i = i_sv[sv_c]
    T_lo = mat.tau_T[i]
    T_hi = mat.tau_T[torch.clamp(i + 1, max=nT - 1)]
    M = mat.tau.shape[1]
    pair = mat.tau_pair.reshape(-1, 2)[i * M + mode.long()]
    dT = T_hi - T_lo
    b = torch.where(
        dT > 0, (pair[:, 1] - pair[:, 0]) / torch.clamp(dT, min=1e-30), 0.0
    )
    a = pair[:, 0] - b * T_lo
    return a, b


def rta_scatter(
    mat: MaterialTables,
    dev: torch.Tensor,
    mode: torch.Tensor,
    omega: torch.Tensor,
    T_local: torch.Tensor,
    alive: torch.Tensor,
    dt: float,
    t_reference: float,
    tau: torch.Tensor,  # cached per-particle lifetime
) -> torch.Tensor:
    """dev <- g + (dev - g) exp(-dt / tau) on alive lanes; tau <= 0 relaxes
    fully. The quotient is a true division (torch's `scalar / tensor` would
    round through a reciprocal)."""
    g = occupation_delta_T(T_local, t_reference, omega)
    decay = torch.where(
        tau > 0,
        torch.exp(torch.full_like(tau, -dt) / torch.clamp(tau, min=1e-12)),
        0.0,
    )
    return torch.where(alive, g + (dev - g) * decay, dev)
