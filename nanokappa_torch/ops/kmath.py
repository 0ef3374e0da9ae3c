"""Occupation math as the drift kernel evaluates it (ops/megastep.py and
csrc/megastep.cu): the twin of nanokappa_tpu/ops/kmath.py with the reference
temperature folded into one float32 constant, HBAR / (T_ref * KB), and with
expm1 where the JAX kernel carries a Taylor workaround (`expm1k`: Mosaic has
no expm1). The two differ by up to ~2e-5 relative on occupations; that is
the tolerance wherever the port is held against the JAX kernel."""

from __future__ import annotations

import torch

from nanokappa_torch.constants import HBAR, KB

_X_MAX = 80.0


def occupation_delta_T_k(T: torch.Tensor, T_ref: float, omega: torch.Tensor):
    """g = n0(T, omega) - n0(T_ref, omega), the kernel's operation order."""
    okT = (T > 0) & (omega > 0)
    okR = omega > 0  # T_ref is a positive static float
    xT = torch.where(okT, omega * HBAR / (torch.where(okT, T, 1.0) * KB), 1.0)
    xT = torch.clamp(xT, max=_X_MAX)
    xR = torch.where(okR, omega * (HBAR / (T_ref * KB)), 1.0)
    xR = torch.clamp(xR, max=_X_MAX)
    eT = torch.expm1(xT)
    eR = torch.expm1(xR)
    nT = torch.where(okT, 1.0 / eT, 0.0)
    nR = torch.where(okR, 1.0 / eR, 0.0)
    both = okT & okR
    return torch.where(both, (eR - eT) / (eT * eR), nT - nR)


def signk(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0.0, 1.0, -1.0)
