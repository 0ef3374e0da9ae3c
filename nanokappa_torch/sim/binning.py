"""Subvolume ids, temperature lookups and segment sums (torch twin of
nanokappa_tpu/sim/binning.py, slice, grid and voronoi subvolumes).

  * subvolume id: slice -> index arithmetic; grid/voronoi -> the first
    nearest centre by d = |c|^2 - 2 q.c, the drift kernel's own formula
    (csrc/megastep.cu sv_of), so one classifier serves the kernel, the
    narrow machinery and the host,
  * particle temperature: nearest (T_sv of the subvolume), linear along
    the slice axis with extrapolation at both ends (slices), or the cubic
    RBF through the subvolume centres ('radial', the v1 step's),
  * T = f(E) and E = f(T): searchsorted + lerp over the monotone tables
    (classes/Phonon.py:372-390),
  * segment sums: `index_add_` into one overflow row that is dropped;
    `bin_sums` is the v1 step's subvolume reduction on them, and
    `normalize_bins` both steps' normalisation of the sums
    (nanokappa_tpu/sim/binning.py bin_all :131 in two parts).
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
    (reference classes/Population.py:685-702): 'linear' on slices, 'radial'
    (the cubic RBF) on any subvolumes, 'nearest' otherwise — 'linear' on
    grid/voronoi subvolumes falls through to nearest, as in the JAX package
    (nanokappa_tpu/sim/binning.py:53-65)."""
    if kind == "linear" and geo.subvol_type == "slice":
        c0, dc = linear_axis(geo)
        return interp_T_linear(T_sv, pos[:, geo.slice_axis], c0, dc)
    if kind == "radial":
        return rbf_interp(geo.subvol_center, T_sv, pos)
    return T_sv[sv.long()]


def rbf_interp(centers: torch.Tensor, values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cubic RBF interpolation through `values` at `centers`, at the points
    x (scipy RBFInterpolator kernel='cubic' with a degree-1 polynomial;
    reference classes/Population.py:574-588; nanokappa_tpu/sim/binning.py
    _rbf_interp :66). The augmented (SV+4, SV+4) system is solved on the
    device in float64 (`solve_ex`: no host read of its status) — the
    kernel |d|^3 spans ~1e11 on Angstrom-scale centres, beyond float32's
    digits — and evaluated in float64 with the JAX package's distance
    formula |x - c| (not the expanded |x|^2 form), chunked over the points.
    Returns float32 temperatures."""
    n = centers.shape[0]
    c = centers.double()
    K = torch.linalg.vector_norm(c[:, None, :] - c[None, :, :], dim=-1) ** 3
    P = torch.cat([torch.ones((n, 1), dtype=c.dtype, device=c.device), c], dim=1)
    A = torch.zeros((n + 4, n + 4), dtype=c.dtype, device=c.device)
    A[:n, :n] = K
    A[:n, n:] = P
    A[n:, :n] = P.T
    b = torch.cat([values.double(), torch.zeros(4, dtype=c.dtype, device=c.device)])
    coef, _ = torch.linalg.solve_ex(A, b)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    step = max(1, _CHUNK // max(n, 1))
    for s in range(0, x.shape[0], step):
        q = x[s : s + step].double()
        phi = torch.linalg.vector_norm(q[:, None, :] - c[None], dim=-1) ** 3
        out[s : s + step] = (phi @ coef[:n] + coef[n] + q @ coef[n + 1 :]).float()
    return out


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


def bin_sums(geo: DeviceGeometry, energies, vel, sv, alive) -> torch.Tensor:
    """The v1 step's raw (SV, 5) subvolume sums [e, e*vx, e*vy, e*vz,
    alive] in one segment sum (reference classes/Population.py:704-747):
    what the shards of a sharded run add up before normalize_bins."""
    n_sv = geo.n_subvols
    vals = torch.cat(
        [energies[:, None], energies[:, None] * vel, alive.to(energies.dtype)[:, None]], dim=1
    )
    return segment_sum(vals, torch.where(alive, sv, n_sv), n_sv)


def normalize_bins(geo: DeviceGeometry, mat: MaterialTables, sums, energy_normal: str,
                   particle_density: float):
    """The normalisation of raw (SV, 5) sums, the v2 step's (kernel A's and
    the event rows') or the v1 step's: (E_dev_sv (SV,) eV/A^3, phi_sv
    (SV, 3) in eV/ps/A^2, Np_sv (SV,) i32)."""
    e_sv = sums[:, 0]
    phi = sums[:, 1:4]
    np_sv = sums[:, 4].to(torch.int32)
    if energy_normal == "fixed":
        norm = torch.full_like(geo.subvol_volume, float(mat.n_active_modes)) / (
            particle_density * geo.subvol_volume
        )
    else:  # 'mean'
        npf = torch.clamp(np_sv, min=1).to(e_sv.dtype)
        norm = torch.full_like(npf, float(mat.n_active_modes)) / npf
        norm = torch.where(np_sv == 0, 0.0, norm)
    dens = 1.0 / (mat.n_qpoints * mat.volume_unitcell)
    return e_sv * norm * dens, phi * (norm * dens)[:, None], np_sv
