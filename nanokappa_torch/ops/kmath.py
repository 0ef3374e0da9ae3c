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


def occupation_delta_omega_k(T_ref: float, om_a: torch.Tensor, om_b: torch.Tensor):
    """n0(T_ref, om_a) - n0(T_ref, om_b), the kernel's operation order: the
    occupation re-reference of a specular swap to a partner mode of
    another frequency (nanokappa_tpu/ops/kmath.py:43)."""
    okA = om_a > 0
    okB = om_b > 0
    c = HBAR / (T_ref * KB)
    xA = torch.clamp(torch.where(okA, om_a * c, 1.0), max=_X_MAX)
    xB = torch.clamp(torch.where(okB, om_b * c, 1.0), max=_X_MAX)
    eA = torch.expm1(xA)
    eB = torch.expm1(xB)
    nA = torch.where(okA, 1.0 / eA, 0.0)
    nB = torch.where(okB, 1.0 / eB, 0.0)
    return torch.where(okA & okB, (eB - eA) / (eA * eB), nA - nB)


def signk(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0.0, 1.0, -1.0)
