"""Material data: host-side `Material` and the frozen device `MaterialTables`.

The host `Material` is the JAX package's (nanokappa_tpu/material/tables.py),
copied: full-BZ NumPy tables with (Q, J) flattened to one mode axis
m = q * n_branches + j. `Material.device_tables(device)` freezes the
per-mode tables into torch tensors on `device`, with the same field names
and the same float32 rounding as the JAX package's device tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from nanokappa_torch.constants import HBAR, KB


# --------------------------------------------------------------------------
# Host-side occupation / energy math (float64 NumPy, used to build tables and
# in tests; the device versions live in sim/bose.py)
# --------------------------------------------------------------------------


def bose_einstein(T, omega):
    """Bose-Einstein occupation n0(T, omega) (reference classes/Phonon.py:338-345)."""
    T = np.asarray(T, dtype=float)
    omega = np.asarray(omega, dtype=float)
    flag = (T > 0) & (omega > 0)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        x = omega * HBAR / (np.maximum(T, 1e-30) * KB)
        n = np.where(flag, 1.0 / np.expm1(np.where(flag, x, 1.0)), 0.0)
    return n


@dataclass(frozen=True)
class MaterialTables:
    """Device-resident phonon tables, flattened over the mode axis.

    Shapes: M = Q * J modes; nT lifetime temperatures; nE energy-table rows.
    """

    omega: torch.Tensor  # (M,)   rad*THz
    velocity: torch.Tensor  # (M,3)  A*THz
    wavevector: torch.Tensor  # (M,3)  rad/A (FBZ-folded, per q-point)
    active: torch.Tensor  # (M,)   bool: group velocity nonzero
    tau_T: torch.Tensor  # (nT,)  lifetime table temperatures, K (sorted)
    tau: torch.Tensor  # (nT,M) lifetimes, ps; 0 == no scattering
    T_grid: torch.Tensor  # (nE,)  fine temperature grid, K
    E_grid: torch.Tensor  # (nE,)  crystal energy density eV/A^3 (monotone)
    omega_vel: torch.Tensor  # (M,4)  [omega, vx, vy, vz]
    tau_pair: torch.Tensor  # (nTP,M,2) [tau[i], tau[i+1]] rows for T-lerp
    #   (nTP = max(nT-1, 1))

    n_qpoints: int = field(metadata=dict(static=True))
    n_branches: int = field(metadata=dict(static=True))
    n_active_modes: int = field(metadata=dict(static=True))
    volume_unitcell: float = field(metadata=dict(static=True))
    zero_point: float = field(metadata=dict(static=True))

    @property
    def n_modes(self) -> int:
        return self.n_qpoints * self.n_branches


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


@dataclass
class Material:
    """Host-side material: full-BZ NumPy tables + derived device tables.

    Mirrors what the reference's Phonon class exposes after
    `load_base_properties` (classes/Phonon.py:66-151), with (Q, J) flattened
    to a single mode axis.
    """

    name: str
    qpoints: np.ndarray  # (Q,3) reduced coords in [0,1)
    omega: np.ndarray  # (Q,J) rad*THz
    group_vel: np.ndarray  # (Q,J,3) A*THz
    wavevectors: np.ndarray  # (Q,3) rad/A, FBZ-folded
    tau: np.ndarray  # (nT,Q,J) ps (0 = no scattering)
    tau_T: np.ndarray  # (nT,)
    reciprocal_lattice: np.ndarray  # (3,3) columns are b_i
    volume_unitcell: float
    data_mesh: np.ndarray  # (3,) original q-mesh (for grid tolerances)

    def __post_init__(self):
        self.n_qpoints, self.n_branches = self.omega.shape
        self.n_modes = self.n_qpoints * self.n_branches
        self.inactive_mask = np.all(self.group_vel == 0, axis=2)  # (Q,J)
        self.n_active_modes = int(self.n_modes - self.inactive_mask.sum())
        self.zero_point = self.calculate_zeropoint()
        self._build_temperature_tables()
        self.degeneracies = self._find_degeneracies()

    # -- energy / temperature ------------------------------------------------

    def normalise_to_density(self, x):
        """eV -> eV/A^3 using V_solid = Q * V_unitcell (classes/Phonon.py:392-401)."""
        return x / (self.n_qpoints * self.volume_unitcell)

    def calculate_zeropoint(self) -> float:
        return float(self.normalise_to_density(HBAR * self.omega.sum() / 2.0))

    def crystal_energy(self, T) -> np.ndarray:
        """Energy density (eV/A^3) at temperature(s) T, incl. zero point
        (classes/Phonon.py:352-362).

        Uses the native C++ kernel when available (the 0.1 K inversion table
        over a 31^3 material is ~9e8 Bose-Einstein evaluations; broadcast
        NumPy would need multi-GB temporaries), with a T-chunked NumPy
        fallback."""
        T = np.atleast_1d(np.asarray(T, dtype=float))
        from nanokappa_torch import native

        e = native.crystal_energy_sums(
            self.omega, ~self.inactive_mask, T, HBAR, KB
        )
        if e is None:
            e = np.empty(len(T))
            chunk = max(1, int(2e7 // max(self.n_modes, 1)))
            for s in range(0, len(T), chunk):
                Ts = T[s : s + chunk]
                n = bose_einstein(Ts[:, None, None], self.omega[None, :, :])
                e[s : s + chunk] = (
                    HBAR * self.omega[None, :, :] * n * (~self.inactive_mask)
                ).sum(axis=(1, 2))
        return self.normalise_to_density(e) + self.zero_point

    def _build_temperature_tables(self, dT: float = 0.1):
        """Monotone E(T) table for the T = f(E) inversion
        (classes/Phonon.py:372-390 uses the same 0.1 K grid)."""
        T_min, T_max = float(self.tau_T.min()), float(self.tau_T.max())
        T_min = max(T_min, dT)  # avoid T=0 rows giving a flat (non-invertible) start
        T_grid = np.arange(T_min, T_max + dT, dT)
        E_grid = self.crystal_energy(T_grid)
        # E(T) is numerically flat at very low T (all modes frozen out);
        # keep only the strictly increasing region so T = f(E) is well defined.
        first = int(np.argmax(np.diff(E_grid) > 0))
        self.T_grid = T_grid[first:]
        self.E_grid = np.maximum.accumulate(E_grid[first:])

    def temperature_from_energy(self, E) -> np.ndarray:
        return np.interp(E, self.E_grid, self.T_grid)

    def energy_from_temperature(self, T) -> np.ndarray:
        return np.interp(T, self.T_grid, self.E_grid)

    # -- modes ---------------------------------------------------------------

    def mode_index(self, q, j):
        return np.asarray(q) * self.n_branches + np.asarray(j)

    def mode_to_qj(self, m):
        m = np.asarray(m)
        return m // self.n_branches, m % self.n_branches

    def _find_degeneracies(self) -> np.ndarray:
        """(D, 3) rows [q, j1, j2] with equal omega at the same q
        (classes/Population.py:1017-1040)."""
        om = self.omega
        eq = np.abs(om[:, :, None] - om[:, None, :]) < 1e-10
        J = self.n_branches
        eq[:, np.arange(J), np.arange(J)] = False
        q, j1, j2 = np.nonzero(eq)
        keep = j1 < j2
        return np.stack([q[keep], j1[keep], j2[keep]], axis=1)

    # -- specific heat / bulk kappa (host diagnostics) ------------------------

    def mode_heat_capacity(self, T: float) -> np.ndarray:
        """c(m) = hbar*omega * dn0/dT, eV/K, per mode (Q,J)."""
        x = self.omega * HBAR / (KB * T)
        with np.errstate(over="ignore", invalid="ignore"):
            ex = np.exp(np.minimum(x, 500.0))
            c = KB * x**2 * ex / np.expm1(np.minimum(x, 500.0)) ** 2
        c = np.where((self.omega > 0) & ~self.inactive_mask, c, 0.0)
        return c

    def bulk_kappa_rta(self, T: float) -> np.ndarray:
        """Bulk RTA conductivity tensor diag (W/m/K) — host-side sanity check.

        kappa_ab = (1/V) sum_m c_m v_a v_b tau_m with V = Q * V_uc.
        Units: eV/K * (A/ps)^2 * ps / A^3 = eV/(ps A K) -> W/(m K) via 1.602e-19/1e-12/1e-10.
        """
        c = self.mode_heat_capacity(T)  # (Q,J)
        ti = np.clip(np.searchsorted(self.tau_T, T) - 1, 0, len(self.tau_T) - 2)
        w = (T - self.tau_T[ti]) / (self.tau_T[ti + 1] - self.tau_T[ti])
        tau = (1 - w) * self.tau[ti] + w * self.tau[ti + 1]  # (Q,J)
        v2 = self.group_vel**2  # (Q,J,3)
        kappa = (c[:, :, None] * v2 * tau[:, :, None]).sum(axis=(0, 1))
        kappa /= self.n_qpoints * self.volume_unitcell
        return kappa * 1.602176634e-19 / (1e-12 * 1e-10)

    # -- device tables ---------------------------------------------------------

    def device_tables(self, device=None) -> MaterialTables:
        """The per-mode tables as float32 torch tensors on `device` (the
        card unless named; rounded from float64 exactly once, like the JAX
        package's tables)."""
        from nanokappa_torch.geometry.device import resolve_device

        device = resolve_device(device)
        Q, J = self.n_qpoints, self.n_branches
        kvec = np.repeat(self.wavevectors, J, axis=0)  # (M,3), per-mode
        om = self.omega.reshape(-1, 1)
        vel = self.group_vel.reshape(-1, 3)
        tau2d = self.tau.reshape(len(self.tau_T), -1)
        if len(self.tau_T) > 1:
            tau_pair = np.stack([tau2d[:-1], tau2d[1:]], axis=-1)
        else:
            tau_pair = np.stack([tau2d, tau2d], axis=-1)
        return MaterialTables(
            omega=_f32(self.omega.reshape(-1), device),
            velocity=_f32(self.group_vel.reshape(-1, 3), device),
            omega_vel=_f32(np.concatenate([om, vel], axis=1), device),
            tau_pair=_f32(tau_pair, device),
            wavevector=_f32(kvec, device),
            active=torch.as_tensor(
                ~self.inactive_mask.reshape(-1), device=device
            ),
            tau_T=_f32(self.tau_T, device),
            tau=_f32(self.tau.reshape(len(self.tau_T), -1), device),
            T_grid=_f32(self.T_grid, device),
            E_grid=_f32(self.E_grid, device),
            n_qpoints=Q,
            n_branches=J,
            n_active_modes=self.n_active_modes,
            volume_unitcell=float(self.volume_unitcell),
            zero_point=float(self.zero_point),
        )


# --------------------------------------------------------------------------
# FBZ folding (reference classes/Phonon.py:209-247)
# --------------------------------------------------------------------------


def fold_to_fbz(k: np.ndarray, reciprocal_lattice: np.ndarray) -> np.ndarray:
    """Minimum-image wavevectors: translate each k by reciprocal lattice
    vectors until it has the smallest possible norm (first Brillouin zone)."""
    B = reciprocal_lattice  # columns are b_i ; k_cart = B @ q
    Binv = np.linalg.inv(B)
    a = np.array([-1, 0, 1])
    shifts = np.stack(np.meshgrid(a, a, a, indexing="ij"), axis=-1).reshape(-1, 3)
    shifts_cart = shifts @ B.T  # (27,3)
    i0 = int(np.nonzero(np.all(shifts == 0, axis=1))[0][0])

    k = np.array(k, dtype=float)
    active = np.ones(k.shape[0], dtype=bool)
    while np.any(active):
        cand = k[active, None, :] + shifts_cart[None, :, :]  # (Na,27,3)
        norm = np.linalg.norm(cand, axis=-1)
        imin = np.argmin(norm, axis=1)
        # prefer the zero shift when tied (matches reference argmax-on-equality
        # stopping rule at classes/Phonon.py:235-242 within round-off)
        tied = np.abs(norm[np.arange(len(imin)), imin] - norm[:, i0]) < 1e-12
        imin = np.where(tied, i0, imin)
        k[active] = cand[np.arange(len(imin)), imin]
        active[active.nonzero()[0]] = imin != i0
    return k
