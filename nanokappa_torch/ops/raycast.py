"""Device ray casting: time of flight to the next boundary.

Torch twin of nanokappa_tpu/ops/raycast.py:
  * axis-aligned box: per-axis slab arithmetic (`_raycast_box`),
  * triangle meshes of up to 256 triangles: Möller–Trumbore against every
    triangle at once (`_raycast_tri`). The JAX package computes this one
    function twice — unrolled up to UNROLL_MAX = 32 triangles
    (`_raycast_unrolled`) and as one broadcast chunk up to 256
    (`_raycast_broadcast`) — because its TPU wants a dense lane dimension;
    here one (N, F) broadcast serves both, with the nearest valid hit and
    the first triangle winning a tie, as in either JAX form,
  * larger meshes of up to 65,536 triangles: kernel E, the Morton-chunked
    plane solve (ops/raycast_large.py; the JAX package's `raycast_pallas`
    on its TPU and its `_raycast_broadcast` scan elsewhere),
  * beyond that (the v1 step's meshes): `_raycast_broadcast`, the dense
    cast over 256-triangle chunks with a running minimum in which only a
    strictly smaller t replaces the best hit (the JAX scan's tie rule,
    nanokappa_tpu/ops/raycast.py:148-186). Plain torch, as in the JAX
    package: no kernel.
The in-kernel cast of kernel A (csrc/megastep.cu) runs the same arithmetic
per triangle in the same operation order, so `tri_cast` is also its plain
twin.

Returns (t_hit in ps [inf if none], facet id [-1 if none]).
"""

from __future__ import annotations

import torch

from nanokappa_torch.geometry.device import DeviceGeometry, host

# Accept slightly NEGATIVE flight times (clamped to 0): float32 round-off can
# land a particle a hair outside a corner, where the only outward-blocking
# facet is "behind" it by ~1e-3 A.
_T_BACK = -1e-4  # ps
_EPS_DET = 1e-12
_BARY_TOL = 1e-5
CHUNK_F = 256  # the most triangles one broadcast cast takes


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
    if geo.is_box:
        return _raycast_box(geo, pos, vel, exclude_facet)
    if geo.tri_origin.shape[0] <= CHUNK_F:
        return _raycast_tri(geo, pos, vel, exclude_facet)
    from nanokappa_torch.ops.raycast_large import large_eligible, raycast_large

    if not large_eligible(geo):
        return _raycast_broadcast(geo, pos, vel, exclude_facet)
    return raycast_large(geo, pos, vel, exclude_facet)


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


def tri_table(geo: DeviceGeometry) -> torch.Tensor:
    """(F, 10) float32 triangle table [origin, e1, e2, facet id bits] on the
    geometry's device (kernel A stages it in shared memory), cached."""
    cached = getattr(geo, "_tri_table", None)
    if cached is None:
        fac = geo.tri_facet.to(torch.int32).contiguous().view(torch.float32)
        cached = torch.cat(
            [geo.tri_origin, geo.tri_e1, geo.tri_e2, fac[:, None]], dim=1
        ).contiguous()
        object.__setattr__(geo, "_tri_table", cached)
    return cached


def tri_cast(tri: torch.Tensor, p, v, exclude):
    """Nearest Möller–Trumbore hit of each ray against the (F, 10) triangle
    table: p, v are 3 lists of (N,) rows, exclude (N,) i32 a facet id to
    skip. Barycentric tolerance _BARY_TOL inclusive, hits down to _T_BACK
    accepted and clamped to 0, |det| <= _EPS_DET rejected; among valid hits
    the smallest t, the first triangle on a tie. Returns (t (N,), facet
    (N,) i32)."""
    cols = [tri[:, k][None, :] for k in range(9)]
    ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = cols
    fid = tri[:, 9].contiguous().view(torch.int32)
    px, py, pz = (x[:, None] for x in p)
    vx, vy, vz = (x[:, None] for x in v)
    # h = v x e2, q = s x e1 (s = p - origin); the kernel's order exactly
    hx = vy * e2z - vz * e2y
    hy = vz * e2x - vx * e2z
    hz = vx * e2y - vy * e2x
    det = (e1x * hx + e1y * hy) + e1z * hz
    okd = det.abs() > _EPS_DET
    # a true division (torch's `1.0 / t` goes through a reciprocal)
    inv = torch.where(okd, torch.ones_like(det) / det, 0.0)
    sx, sy, sz = px - ax, py - ay, pz - az
    u = ((sx * hx + sy * hy) + sz * hz) * inv
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    w = ((vx * qx + vy * qy) + vz * qz) * inv
    t_raw = ((e2x * qx + e2y * qy) + e2z * qz) * inv
    t = torch.clamp(t_raw, min=0.0)
    ok = (
        okd & (u >= -_BARY_TOL) & (w >= -_BARY_TOL)
        & (u + w <= 1.0 + _BARY_TOL) & (t_raw > _T_BACK)
        & (exclude[:, None] != fid[None, :])
    )
    t_ok = torch.where(ok, t, float("inf"))
    best_t, k = torch.min(t_ok, dim=1)
    best_f = torch.where(best_t < float("inf"), fid[k], -1)
    return best_t, best_f


def _raycast_tri(geo, pos, vel, exclude_facet):
    tri = tri_table(geo)
    return tri_cast(
        tri, [pos[:, k] for k in range(3)], [vel[:, k] for k in range(3)],
        exclude_facet,
    )


def _raycast_broadcast(geo, pos, vel, exclude_facet):
    """The dense cast over CHUNK_F-triangle chunks of the triangle table:
    within a chunk tri_cast's rule (the first triangle at the smallest t),
    across chunks a running minimum that only a strictly smaller t
    replaces."""
    tri = tri_table(geo)
    p = [pos[:, k] for k in range(3)]
    v = [vel[:, k] for k in range(3)]
    best_t = torch.full((pos.shape[0],), float("inf"), device=pos.device)
    best_f = torch.full((pos.shape[0],), -1, dtype=torch.int32, device=pos.device)
    for s in range(0, tri.shape[0], CHUNK_F):
        t, f = tri_cast(tri[s : s + CHUNK_F], p, v, exclude_facet)
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_f = torch.where(closer, f, best_f)
    return best_t, best_f
