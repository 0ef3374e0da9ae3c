"""The reference's physics, written from the Nano-kappa semantics and the raw
material alone (Silva et al., CPC 294 (2024) 108954; classes/Phonon.py,
classes/Population.py of the reference repository):

* Bose-Einstein occupations n0(T, omega) = 1 / (exp(hbar omega / kB T) - 1),
  the crystal energy density E(T) = (sum over active modes of
  hbar omega n0 + sum over all modes of hbar omega / 2) / (Q V_cell), and
  its inverse T(E) by Newton's method;
* lifetimes: the raw table's linear interpolation in T;
* the velocity model's specular partner of a mode at a wall: the mode with
  the same frequency whose group velocity is the mirrored one,
  v - 2 (v . n) n;
* a box domain from the configuration's CLI words (its walls, reservoirs,
  periodic pairs and slices), and the reservoirs' entry rates
  max(v . n_in, 0) dt / thickness, thickness = N_active / (rho A).

Every quantity is float64 unless a caller asks for another precision (the
control computes in bfloat16).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

HBAR = 6.582119569e-4  # eV ps / rad
KB = 8.617333262e-5  # eV / K
EV_IN_J = 1.602176634e-19
A_IN_M = 1e-10
EVPSA2_IN_WM2 = EV_IN_J / (1e-12 * A_IN_M**2)  # eV / (ps A^2) -> W / m^2


def n0(T: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Bose-Einstein occupation; 0 where omega <= 0."""
    ok = omega > 0
    x = HBAR * omega / (KB * T)
    return torch.where(ok, 1.0 / torch.expm1(torch.where(ok, x, torch.ones_like(x))), torch.zeros_like(x))


class Crystal:
    """The mode tables of a raw material, on a device, in float64."""

    def __init__(self, raw, device):
        dev = torch.device(device)
        Q, J = raw.omega.shape
        self.M = Q * J
        self.omega_np = np.asarray(raw.omega, np.float64).reshape(-1)
        self.vel_np = np.asarray(raw.group_vel, np.float64).reshape(-1, 3)
        self.active_np = ~np.all(self.vel_np == 0, axis=1)
        self.n_active = int(self.active_np.sum())
        self.dens = 1.0 / (Q * float(raw.volume_unitcell))
        self.omega = torch.as_tensor(self.omega_np, device=dev)
        self.vel = torch.as_tensor(self.vel_np, device=dev)
        self.active = torch.as_tensor(self.active_np, device=dev)
        self.tau_T = torch.as_tensor(np.asarray(raw.tau_T, np.float64), device=dev)
        self.tau = torch.as_tensor(np.asarray(raw.tau, np.float64).reshape(len(raw.tau_T), -1), device=dev)
        self.zero_point = float(HBAR * self.omega_np.sum() / 2.0 * self.dens)
        self.device = dev
        # modes that no observable tells apart (same frequency, velocity and
        # lifetimes: the degenerate TA and TO branches of an isotropic
        # dispersion) share a class
        key = np.concatenate([self.omega_np[:, None], self.vel_np,
                              np.asarray(raw.tau, np.float64).reshape(len(raw.tau_T), -1).T], 1)
        _, inv = np.unique(key, axis=0, return_inverse=True)
        self.mode_class = torch.as_tensor(inv.reshape(-1), device=dev)

    def lifetime(self, T: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
        """tau(T) of each mode by linear interpolation in the table's T
        grid, T clamped to the grid."""
        tT = self.tau_T.to(T.dtype)
        Tc = torch.clamp(T, tT[0], tT[-1])
        i = torch.clamp(torch.searchsorted(tT, Tc.contiguous()) - 1, 0, len(tT) - 2)
        w = (Tc - tT[i]) / (tT[i + 1] - tT[i])
        m = mode.long()
        return self.tau[i, m].to(T.dtype) * (1 - w) + self.tau[i + 1, m].to(T.dtype) * w

    def energy(self, T: torch.Tensor) -> torch.Tensor:
        """E(T) in eV/A^3 with the zero point, in blocks of T (float64)."""
        T = T.to(torch.float64).reshape(-1)
        out = torch.empty_like(T)
        w = torch.where(self.active, self.omega, 0.0)
        for s in range(0, T.numel(), 32):
            n = n0(T[s:s + 32, None], w[None])
            out[s:s + 32] = (HBAR * w[None] * n).sum(1) * self.dens
        return out + self.zero_point

    def heat_capacity(self, T: torch.Tensor) -> torch.Tensor:
        T = T.to(torch.float64).reshape(-1)
        out = torch.empty_like(T)
        w = torch.where(self.active, self.omega, 0.0)
        for s in range(0, T.numel(), 32):
            Tb = T[s:s + 32, None]
            n = n0(Tb, w[None])
            x = HBAR * w[None] / (KB * Tb)
            out[s:s + 32] = (HBAR * w[None] * n * (n + 1.0) * x).sum(1) / Tb[:, 0] * self.dens
        return out

    def temperature(self, E: torch.Tensor, T0: torch.Tensor) -> torch.Tensor:
        """T with energy(T) = E, by Newton from T0."""
        T = T0.to(torch.float64).reshape(-1).clone()
        E = E.to(torch.float64).reshape(-1)
        for _ in range(8):
            T = T - (self.energy(T) - E) / self.heat_capacity(T)
        return T

    def mirror_partner(self, normal) -> torch.Tensor:
        """(M,) the specular partner of each mode that moves toward a wall of
        outward normal `normal` (-1 where none): the mode whose frequency
        equals its own and whose velocity is its mirrored velocity, both
        to a millionth of the table's largest value."""
        n = np.asarray(normal, np.float64)
        v, w = self.vel_np, self.omega_np
        h_v = 1e-6 * max(np.abs(v).max(), 1e-300)
        h_w = 1e-6 * max(np.abs(w).max(), 1e-300)

        def keys(ww, vv):
            return np.concatenate([np.round(ww / h_w)[:, None], np.round(vv / h_v)], 1).astype(np.int64)

        table = {}
        for i, k in enumerate(map(bytes, keys(w, v))):
            table.setdefault(k, i)
        vm = v - 2.0 * (v @ n)[:, None] * n[None]
        out = np.full(self.M, -1, np.int64)
        toward = np.nonzero(v @ n > 0)[0]
        km = keys(w[toward], vm[toward])
        for i, k in zip(toward, km):
            j = table.get(bytes(k))
            if j is None:  # a key on a rounding edge: the neighbours
                for d in np.ndindex(3, 3, 3, 3):
                    j = table.get(bytes(k + np.asarray(d) - 1))
                    if j is not None:
                        break
            if j is not None and np.all(np.abs(v[j] - vm[i]) <= 2 * h_v) and abs(w[j] - w[i]) <= 2 * h_w:
                out[i] = j
        return torch.as_tensor(out, device=self.device)


# ---------------------------------------------------------------------------
# the box domain from the configuration's words
# ---------------------------------------------------------------------------

COND_TEMPERATURE, COND_PERIODIC, COND_ROUGH = "T", "P", "R"


@dataclass
class Wall:
    axis: int
    side: int  # 0: the plane at 0, 1: the plane at L[axis]
    cond: str
    value: float  # the reservoir's temperature, or the wall's roughness
    reservoir: int = -1

    @property
    def outward(self) -> np.ndarray:
        n = np.zeros(3)
        n[self.axis] = 1.0 if self.side else -1.0
        return n


class Box:
    """A box [0, L] with its six walls, reservoirs and slices, from the
    CLI words of a Nano-kappa box configuration: `dimensions`, relative
    `bound_pos` probe points (each names the wall it lies outside of),
    `bound_cond` (one a probe; the last one is every other wall's),
    `bound_values` (one a probe) and slice `subvolumes`."""

    def __init__(self, args: dict):
        if str(args["geometry"][0]) not in ("box", "cuboid"):
            raise ValueError("the reference runs box domains only")
        self.L = np.asarray([float(d) for d in args["dimensions"]], np.float64)
        pos = args["bound_pos"]
        if str(pos[0]) != "relative":
            raise ValueError("the reference reads relative bound_pos only")
        pts = np.asarray([float(x) for x in pos[1:]], np.float64).reshape(-1, 3) * self.L
        conds = [str(c) for c in args["bound_cond"]]
        vals = [float(x) for x in args["bound_values"]]
        walls, probed = {}, []
        for i, p in enumerate(pts):
            out = [(-p[a], a, 0) for a in range(3)] + [(p[a] - self.L[a], a, 1) for a in range(3)]
            _, a, s = max(out)
            walls[(a, s)] = (conds[i], vals[i] if i < len(vals) else 0.0)
            probed.append((a, s))
        self.walls = []
        for a in range(3):
            for s in (0, 1):
                c, v = walls.get((a, s), (conds[-1], 0.0))
                self.walls.append(Wall(a, s, c, v))
        # reservoirs are numbered in the order of their probes
        n_res = 0
        for a, s in probed:
            w = self.wall(a, s)
            if w.cond == COND_TEMPERATURE and w.reservoir < 0:
                w.reservoir = n_res
                n_res += 1
        self.reservoirs = sorted([w for w in self.walls if w.reservoir >= 0], key=lambda w: w.reservoir)
        for w in self.walls:
            if w.cond not in (COND_TEMPERATURE, COND_PERIODIC, COND_ROUGH):
                raise ValueError(f"the reference knows no boundary condition {w.cond!r}")
            if w.cond == COND_PERIODIC and self.wall(w.axis, 1 - w.side).cond != COND_PERIODIC:
                raise ValueError("a periodic wall needs its opposite wall periodic")
        sv = args["subvolumes"]
        if str(sv[0]) != "slice":
            raise ValueError("the reference bins slices only")
        self.n_slices, self.slice_axis = int(sv[1]), int(sv[2])
        self.volume = float(np.prod(self.L))

    def wall(self, axis: int, side: int) -> Wall:
        return self.walls[2 * axis + side]

    def area(self, w: Wall) -> float:
        return float(np.prod([self.L[a] for a in range(3) if a != w.axis]))

    def slice_of(self, x: torch.Tensor) -> torch.Tensor:
        a = self.slice_axis
        return torch.clamp(torch.floor(x[..., a] / self.L[a] * self.n_slices), 0, self.n_slices - 1).long()

    def slice_edge_gap(self, x: torch.Tensor) -> torch.Tensor:
        """Distance of each position to the nearest inner slice boundary."""
        a = self.slice_axis
        h = self.L[a] / self.n_slices
        f = x[..., a] / h
        return (f - torch.round(f)).abs() * h + torch.where(
            (torch.round(f) <= 0) | (torch.round(f) >= self.n_slices), math.inf, 0.0)

    def t_reference(self) -> float:
        T = [w.value for w in self.reservoirs]
        return float(np.mean(T)) if T else 300.0

    def entry_rates(self, crystal: Crystal, n_particles: int, dt: float) -> np.ndarray:
        """(R, M) particles of each mode that enter through each reservoir
        in one step, and so the pooled scheme's rate per reservoir."""
        rho = n_particles / self.volume
        out = np.zeros((len(self.reservoirs), crystal.M))
        for w in self.reservoirs:
            thick = crystal.n_active / (rho * self.area(w))
            out[w.reservoir] = np.maximum(crystal.vel_np @ (-w.outward), 0.0) * dt / thick
        return out
