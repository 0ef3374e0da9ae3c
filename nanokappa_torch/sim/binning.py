"""Subvolume ids, temperature lookups and segment sums (torch twin of
nanokappa_tpu/sim/binning.py, slice, grid and voronoi subvolumes with
nearest or linear interpolation).

  * subvolume id: slice -> index arithmetic; grid/voronoi -> the first
    nearest centre by d = |c|^2 - 2 q.c, the drift kernel's own formula
    (csrc/megastep.cu sv_of), so one classifier serves the kernel, the
    narrow machinery and the host,
  * particle temperature: nearest (T_sv of the subvolume) or, on slices,
    linear along the slice axis with extrapolation at both ends,
  * T = f(E) and E = f(T): searchsorted + lerp over the monotone tables
    (classes/Phonon.py:372-390),
  * segment sums: `index_add_` into one overflow row that is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from nanokappa_torch.constants import HBAR
from nanokappa_torch.geometry.device import DeviceGeometry, host
from nanokappa_torch.material.tables import MaterialTables
from nanokappa_torch.sim.bose import occupation_delta_T

_CHUNK = 1 << 24  # (lanes x centres) distances held at once


def nearest_center(pos: torch.Tensor, centers: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """(N,) int32 id of the first centre with the least d = c2 - 2 q.c
    (c2 from geometry/device.py center_sq_norms), in float32 with the
    kernel's operation order; a NaN distance never wins
    (the kernel's strict `<` from +inf)."""
    n, sv = pos.shape[0], centers.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=pos.device)
    step = max(1, _CHUNK // max(sv, 1))
    cx, cy, cz = centers[:, 0][None], centers[:, 1][None], centers[:, 2][None]
    for s in range(0, n, step):
        q = pos[s : s + step]
        dot = (q[:, 0:1] * cx + q[:, 1:2] * cy) + q[:, 2:3] * cz
        d = c2[None] - 2.0 * dot
        d = torch.where(torch.isnan(d), float("inf"), d)
        out[s : s + step] = torch.argmin(d, dim=1).to(torch.int32)
    return out


def subvol_id(geo: DeviceGeometry, pos: torch.Tensor) -> torch.Tensor:
    if geo.subvol_type != "slice":
        return nearest_center(pos, geo.subvol_center, geo.subvol_c2)
    ax = geo.slice_axis
    lo = geo.bounds[0, ax]
    length = (geo.bounds[1, ax] - geo.bounds[0, ax]) / geo.n_subvols
    i = torch.floor((pos[:, ax] - lo) / length).to(torch.int32)
    return torch.clamp(i, 0, geo.n_subvols - 1)


def linear_axis(geo: DeviceGeometry) -> tuple[float, float]:
    """(c0, dc): the first slice centre and the spacing of the slice centres
    along the slice axis, in float64 from the float32 centres (the JAX
    kernel's host arithmetic, nanokappa_tpu/ops/megastep.py:1162-1165)."""
    center = host(geo.subvol_center).astype(np.float64)
    ax, sv = geo.slice_axis, geo.n_subvols
    c0 = float(center[0, ax])
    return c0, float((center[-1, ax] - center[0, ax]) / (sv - 1))


def interp_T_linear(T_sv: torch.Tensor, qa: torch.Tensor, c0: float, dc: float) -> torch.Tensor:
    """T at slice-axis coordinates `qa`: the lerp between the two slice
    centres around it, extrapolated beyond the end centres; the drift
    kernel's arithmetic (truncation with a fpos < 0 fix-up = floor)."""
    sv = T_sv.shape[0]
    fpos = (qa - c0) / torch.full_like(qa, dc)
    ilo = torch.clamp(fpos.to(torch.int32), 0, sv - 2)
    ilo = torch.where(fpos < 0, 0, ilo)
    w = fpos - ilo.to(torch.float32)
    il = ilo.long()
    return T_sv[il] * (1.0 - w) + T_sv[il + 1] * w


def interp_T_particles(
    geo: DeviceGeometry, T_sv: torch.Tensor, pos: torch.Tensor,
    sv: torch.Tensor, kind: str,
) -> torch.Tensor:
    """Temperature at particle positions from subvolume temperatures
    (reference classes/Population.py:685-702): 'nearest', or 'linear' on
    slices."""
    if kind == "linear" and geo.subvol_type == "slice":
        c0, dc = linear_axis(geo)
        return interp_T_linear(T_sv, pos[:, geo.slice_axis], c0, dc)
    if kind != "nearest":
        raise NotImplementedError(
            f"temp_interp={kind!r} on {geo.subvol_type} subvolumes is not ported yet "
            "(ROADMAP queue 1, item 11: the v1 step)"
        )
    return T_sv[sv.long()]


def _lerp_lookup(x_grid, y_grid, x):
    i = torch.clamp(
        torch.searchsorted(x_grid, x) - 1, 0, x_grid.shape[0] - 2
    )
    w = (x - x_grid[i]) / (x_grid[i + 1] - x_grid[i])
    w = torch.clamp(w, 0.0, 1.0)
    return y_grid[i] * (1 - w) + y_grid[i + 1] * w


def lookup_T_of_E(mat: MaterialTables, E: torch.Tensor) -> torch.Tensor:
    return _lerp_lookup(mat.E_grid, mat.T_grid, E)


def lookup_E_of_T(mat: MaterialTables, T: torch.Tensor) -> torch.Tensor:
    return _lerp_lookup(mat.T_grid, mat.E_grid, T)


def particle_energies(
    omega: torch.Tensor,
    dev: torch.Tensor,
    alive: torch.Tensor,
    T_local: torch.Tensor,
    t_reference: float,
) -> torch.Tensor:
    """e_p = hbar*omega*(n - n0(T_local)) per particle, eV
    (classes/Population.py:704-713 with reference_temp='local')."""
    dn = dev - occupation_delta_T(T_local, t_reference, omega)
    return torch.where(alive, HBAR * omega * dn, 0.0)


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """(n_seg, K) sums of the (E, K) rows by segment id; ids outside
    [0, n_seg) are dropped (the JAX package's one-hot matmul semantics)."""
    seg = torch.where((seg >= 0) & (seg < n_seg), seg, n_seg).long()
    out = torch.zeros(
        (n_seg + 1, vals.shape[1]), dtype=vals.dtype, device=vals.device
    )
    out.index_add_(0, seg, vals)
    return out[:n_seg]
