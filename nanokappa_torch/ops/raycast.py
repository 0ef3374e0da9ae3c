"""Device ray casting for the axis-aligned box: time of flight to the next
wall (torch twin of nanokappa_tpu/ops/raycast.py:_raycast_box).

Returns (t_hit in ps [inf if none], facet id [-1 if none]).
"""

from __future__ import annotations

import torch

from nanokappa_torch.geometry.device import DeviceGeometry, host

# Accept slightly NEGATIVE flight times (clamped to 0): float32 round-off can
# land a particle a hair outside a corner, where the only outward-blocking
# facet is "behind" it by ~1e-3 A.
_T_BACK = -1e-4  # ps


def box_tables(geo: DeviceGeometry) -> tuple:
    """Host (axis, sign, plane) lists of the six box walls, cached on the
    geometry so a cast never copies tables back from the device."""
    cached = getattr(geo, "_box_host", None)
    if cached is None:
        cached = (
            [int(a) for a in host(geo.box_axis)],
            [float(s) for s in host(geo.box_sign)],
            [float(p) for p in host(geo.box_plane)],
        )
        object.__setattr__(geo, "_box_host", cached)
    return cached


def raycast(geo: DeviceGeometry, pos, vel, exclude_facet):
    if not geo.is_box:
        raise NotImplementedError(
            "non-box meshes are not ported yet (ROADMAP queue 1, item 9)"
        )
    return _raycast_box(geo, pos, vel, exclude_facet)


def _raycast_box(geo, pos, vel, exclude_facet):
    """Slab test: facet f is plane x[axis] = plane with outward sign s;
    a particle hits it when moving toward it, at t = (plane - x)/v."""
    axis, sign, plane = box_tables(geo)
    best_t = torch.full((pos.shape[0],), float("inf"), device=pos.device)
    best_f = torch.full((pos.shape[0],), -1, dtype=torch.int32, device=pos.device)
    for f in range(geo.n_facets):
        a = axis[f]
        v = vel[:, a]
        toward = v * sign[f] > 0.0
        t_raw = (plane[f] - pos[:, a]) / torch.where(v.abs() > 1e-30, v, 1e-30)
        t = torch.clamp(t_raw, min=0.0)
        ok = toward & (t_raw > _T_BACK) & (t < best_t) & (exclude_facet != f)
        best_t = torch.where(ok, t, best_t)
        best_f = torch.where(ok, f, best_f)
    return best_t, best_f
