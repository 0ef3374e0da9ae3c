"""Subvolume ids, temperature lookups and segment sums (torch twin of
nanokappa_tpu/sim/binning.py, slice subvolumes with nearest interpolation).

  * subvolume id: slice -> index arithmetic,
  * T = f(E) and E = f(T): searchsorted + lerp over the monotone tables
    (classes/Phonon.py:372-390),
  * segment sums: `index_add_` into one overflow row that is dropped.
"""

from __future__ import annotations

import torch

from nanokappa_torch.constants import HBAR
from nanokappa_torch.geometry.device import DeviceGeometry
from nanokappa_torch.material.tables import MaterialTables
from nanokappa_torch.sim.bose import occupation_delta_T

_NOT_PORTED_SV = (
    "grid/voronoi subvolumes are not ported yet (ROADMAP queue 1, item 10)"
)


def subvol_id(geo: DeviceGeometry, pos: torch.Tensor) -> torch.Tensor:
    if geo.subvol_type != "slice":
        raise NotImplementedError(_NOT_PORTED_SV)
    ax = geo.slice_axis
    lo = geo.bounds[0, ax]
    length = (geo.bounds[1, ax] - geo.bounds[0, ax]) / geo.n_subvols
    i = torch.floor((pos[:, ax] - lo) / length).to(torch.int32)
    return torch.clamp(i, 0, geo.n_subvols - 1)


def interp_T_particles(
    geo: DeviceGeometry, T_sv: torch.Tensor, pos: torch.Tensor,
    sv: torch.Tensor, kind: str,
) -> torch.Tensor:
    """Temperature at particle positions from subvolume temperatures
    (reference classes/Population.py:685-702): 'nearest'."""
    if kind != "nearest":
        raise NotImplementedError(
            f"temp_interp={kind!r} is not ported yet (ROADMAP queue 1, item 10)"
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
