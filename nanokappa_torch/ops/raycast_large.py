"""Kernel E — the large-mesh ray cast: the nearest ray–triangle hit over a
mesh of more than 256 triangles, in Morton-ordered 128-triangle chunks.

Replaces the Pallas kernel `raycast_pallas` / `_kernel` of
nanokappa_tpu/ops/raycast_pallas.py (:255 / :150), with its host table
build (`_morton` :56, `_prep` :75) kept here in NumPy. The function is the
Pallas kernel's:
  * triangles sorted by the Morton code of their centroids into chunks of
    BF = 128 (padded with degenerate rows of facet -1); the chunk order
    decides which triangle wins a tie, so it is kept;
  * per chunk, the plane solve in the chunk-local frame (the chunk box's
    centre), t = (d - x.n) / (v.n), and the dual-basis barycentrics
    u = x.T1 + t v.T1 - c1, w = x.T2 + t v.T2 - c2;
  * a hit is valid when |v.n| > _EPS_DET, u, w >= -_BARY_TOL,
    u + w <= 1 + _BARY_TOL, t > _T_BACK (clamped to 0), its facet is not the
    excluded one and not padding;
  * within a chunk the smallest t wins and, among the triangles at that t,
    the smallest facet id; across chunks only a strictly smaller t replaces
    the best hit.
Dropped with the TPU: facet ids carried as float values (an int32 row here),
the bitcast output assembly, scalar prefetch, the VMEM scratch and DMA
semaphore, and the MXU products at HIGHEST precision — here every dot
product is three products summed in a fixed order, in the kernel and in the
twin alike, so the two agree bit for bit.

CUDA design (csrc/raycast_large.cu): G threads share each ray
(`launch_shape`, chosen from the ray count), 256 threads a block. Each
thread keeps the minimum of the key (t, chunk, facet) over the pairs it
solves — the triangles k = g, g + G, ... of each chunk its ray reaches —
and the G partial minima of a ray combine by warp shuffles on that key:
the lexicographic minimum is the tie rule above, so the split gives the
twin's answer bit for bit whatever G is. Per chunk, a slab test of the ray
against the chunk's reach box while the ray can still beat the thread's
running best; a block stages (cp.async, double-buffered, one 16-float
record a triangle: `LargeMeshTables.rec`) only the chunks one of its rays
reaches, and a thread solves a chunk only when its ray reaches it. The
reach box is the chunk's box widened by the largest spill of the
barycentric tolerance over its triangles (2 * _BARY_TOL * (|e1| + |e2|),
doubled, plus 1 A for rounding), so a skipped chunk holds no hit the ray
would accept: the skip never changes a result, and the twin, which solves
every chunk for every ray, is the kernel's exact oracle.
What bounds it on the card: the float32 solve — about 46 operations per
(ray, triangle) pair of a chunk that is reached; the rays (28 bytes in, 8
out) and the chunks a block stages are small beside it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nanokappa_torch.geometry.device import host

launches = 0  # kernel launches (the CUDA path only)
launch_widths: dict[int, int] = {}  # the same launches by ray count

BF = 128  # triangles per chunk
NC_MAX = 512  # chunks: 65,536 triangles (sim/fused.py LARGE_TRI_MAX)
_EPS_DET = 1e-12
_BARY_TOL = 1e-4  # wider than the dense cast's 1e-5: the plane solve rounds
#   differently at shared edges, and a ray in a gap between two triangles'
#   tolerances would find no boundary
_T_BACK = -1e-4  # ps
OPS_PER_PAIR = 46  # float32 operations of one (ray, triangle) solve
TAB_ROWS = 13  # rows of the triangle table the solve reads
REC_W = 16  # floats of one triangle record (the table's 16 rows, transposed)
THREADS = 256  # threads per CUDA block
BOUND_GROUP = 256  # rays per group of the bound's chunk count (the first kernel's block)
_PLAIN_LANES = 1 << 16  # rays per pass of the plain twin (bounds its memory)


@dataclass(frozen=True)
class LargeMeshTables:
    """The kernel's tables for one mesh, on the geometry's device."""

    order: np.ndarray  # (F,) Morton order of the triangles (host)
    bbox: torch.Tensor  # (16, nc) f32: lo (0-2), hi (3-5), frame origin (6-8)
    tab: torch.Tensor  # (16, Fp) f32: T1, T2, n, d, c1, c2, facet (int32 bits)
    reach: torch.Tensor  # (6, nc) f32: lo, hi of each chunk's reach box
    rec: torch.Tensor | None = None  # (Fp, 16) f32: tab, one record a triangle (the kernel's)

    @property
    def nc(self) -> int:
        return int(self.bbox.shape[1])


def _morton(x: np.ndarray) -> np.ndarray:
    """Morton (Z-order) codes of points normalised to a 1024^3 grid."""
    lo, hi = x.min(axis=0), x.max(axis=0)
    q = ((x - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.uint64)

    def spread(v):
        v &= 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def large_eligible(geo) -> bool:
    """A triangle mesh of at most NC_MAX chunks."""
    F = int(geo.tri_origin.shape[0])
    return (not geo.is_box) and -(-F // BF) <= NC_MAX


def prep(geo) -> LargeMeshTables:
    """The host table build (cached on the geometry): Morton-sort the
    triangles, pad to a multiple of BF, pack the (16, Fp) triangle table and
    the (16, nc) chunk table exactly as the Pallas kernel's `_prep` does
    (facet ids as int32 bits), the same table as one 16-float record a
    triangle for the kernel, and the chunks' reach boxes."""
    cached = getattr(geo, "_large_cast", None)
    if cached is not None:
        return cached
    o = host(geo.tri_origin).astype(np.float64)
    e1 = host(geo.tri_e1).astype(np.float64)
    e2 = host(geo.tri_e2).astype(np.float64)
    tf = host(geo.tri_facet).astype(np.int32)
    F = o.shape[0]

    order = np.argsort(_morton(o + (e1 + e2) / 3.0), kind="stable")
    o, e1, e2, tf = o[order], e1[order], e2[order], tf[order]
    Fp = -(-F // BF) * BF
    pad = Fp - F
    if pad:
        o = np.concatenate([o, np.zeros((pad, 3))])
        e1 = np.concatenate([e1, np.zeros((pad, 3))])
        e2 = np.concatenate([e2, np.zeros((pad, 3))])
        tf = np.concatenate([tf, np.full(pad, -1, np.int32)])

    nc = Fp // BF
    verts = np.stack([o, o + e1, o + e2], axis=1).reshape(nc, BF * 3, 3)
    # padding rows sit at the origin: kept out of the box (only the last
    # chunk has any, and it holds at least one real triangle)
    margin = 1e-3
    bbox = np.zeros((16, nc), np.float32)
    real = np.repeat(tf.reshape(nc, BF) >= 0, 3, axis=1)
    for c in range(nc):
        pts = verts[c][real[c]]
        bbox[0:3, c] = pts.min(axis=0) - margin
        bbox[3:6, c] = pts.max(axis=0) + margin
        # the chunk-local frame: plane offsets at chunk magnitude, not at
        # |domain| * |n| (the cancellation in d - x.n costs grazing rays
        # their tolerance otherwise)
        bbox[6:9, c] = 0.5 * (bbox[0:3, c] + bbox[3:6, c])

    c0 = np.repeat(bbox[6:9].T, BF, axis=0)  # (Fp, 3) per-triangle frame
    o_loc = o - c0
    n = np.cross(e1, e2)
    nrm = np.linalg.norm(n, axis=1, keepdims=True)
    n_hat = np.where(nrm > 0, n / np.maximum(nrm, 1e-300), 0.0)
    # dual edge basis of the unit normal: u = (p - a).T1, w = (p - a).T2
    d1 = np.cross(e2, n_hat)
    d2 = np.cross(n_hat, e1)
    s1 = np.einsum("ij,ij->i", d1, e1)
    s2 = np.einsum("ij,ij->i", d2, e2)
    T1 = d1 * np.where(s1 != 0, 1.0 / np.where(s1 == 0, 1.0, s1), 0.0)[:, None]
    T2 = d2 * np.where(s2 != 0, 1.0 / np.where(s2 == 0, 1.0, s2), 0.0)[:, None]
    tab = np.zeros((16, Fp), np.float32)
    tab[0:3] = T1.T
    tab[3:6] = T2.T
    tab[6:9] = n_hat.T
    tab[9] = np.einsum("ij,ij->i", n_hat, o_loc)
    tab[10] = np.einsum("ij,ij->i", T1, o_loc)
    tab[11] = np.einsum("ij,ij->i", T2, o_loc)
    tab[12] = tf.view(np.float32)

    # reach boxes: the accepted region of a triangle reaches at most
    # 2 * _BARY_TOL * (|e1| + |e2|) beyond it
    spill = 2.0 * _BARY_TOL * (np.linalg.norm(e1, axis=1) + np.linalg.norm(e2, axis=1))
    grow = 2.0 * spill.reshape(nc, BF).max(axis=1) + 1.0
    reach = np.concatenate(
        [bbox[0:3].astype(np.float64) - grow, bbox[3:6].astype(np.float64) + grow]
    ).astype(np.float32)

    d = geo.device
    out = LargeMeshTables(
        order=order,
        bbox=torch.as_tensor(bbox, device=d),
        tab=torch.as_tensor(tab, device=d),
        rec=torch.as_tensor(np.ascontiguousarray(tab.T), device=d),
        reach=torch.as_tensor(reach, device=d),
    )
    object.__setattr__(geo, "_large_cast", out)
    return out


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------


def _pair_t(tab, frame_c, x, v, ex):
    """(t, facet) of every (ray, triangle) pair of one chunk: tab (13, BF)
    rows of the chunk, frame_c (3,) its frame origin; x, v lists of 3 (n,)
    rows, ex (n,) i32. t (n, BF) is inf where the pair is no valid hit; the
    kernel's operations in its order."""
    t1x, t1y, t1z, t2x, t2y, t2z, nx, ny, nz, d, c1, c2 = (tab[r][None, :] for r in range(12))
    fid = tab[12].contiguous().view(torch.int32)[None, :]
    xl0, xl1, xl2 = ((x[k] - frame_c[k])[:, None] for k in range(3))
    v0, v1, v2 = (v[k][:, None] for k in range(3))
    vn = (v0 * nx + v1 * ny) + v2 * nz
    den_ok = vn.abs() > _EPS_DET
    xn = (xl0 * nx + xl1 * ny) + xl2 * nz
    t_raw = (d - xn) / torch.where(den_ok, vn, 1.0)
    u = ((xl0 * t1x + xl1 * t1y) + xl2 * t1z + t_raw * ((v0 * t1x + v1 * t1y) + v2 * t1z)) - c1
    w = ((xl0 * t2x + xl1 * t2y) + xl2 * t2z + t_raw * ((v0 * t2x + v1 * t2y) + v2 * t2z)) - c2
    t = torch.where(t_raw > _T_BACK, torch.where(t_raw > 0.0, t_raw, 0.0), float("inf"))
    valid = (
        den_ok & (u >= -_BARY_TOL) & (w >= -_BARY_TOL) & (u + w <= 1.0 + _BARY_TOL)
        & (fid != ex[:, None]) & (fid >= 0)
    )
    return torch.where(valid, t, float("inf")), fid.expand(t.shape)


def _solve_chunk(tab, frame_c, x, v, ex):
    """(t, facet) of the nearest valid hit of each ray within one chunk:
    the smallest t, then the smallest facet id at that t."""
    t, fid = _pair_t(tab, frame_c, x, v, ex)
    tmin = t.min(dim=1).values
    big = torch.iinfo(torch.int32).max
    fmin = torch.where(torch.isfinite(t) & (t == tmin[:, None]), fid, big).min(dim=1).values
    return tmin, fmin


def _reach(tabs: LargeMeshTables, c: int, x, inv, bt):
    """The kernel's slab test of each ray against chunk c's reach box while
    the ray can still beat its best t (bt)."""
    lo, hi = tabs.reach[0:3, c], tabs.reach[3:6, c]
    tmin = torch.full_like(bt, -float("inf"))
    tmax = torch.full_like(bt, float("inf"))
    for k in range(3):
        nr = (lo[k] - x[k]) * inv[k]
        fr = (hi[k] - x[k]) * inv[k]
        tmin = torch.maximum(tmin, torch.minimum(nr, fr))
        tmax = torch.minimum(tmax, torch.maximum(nr, fr))
    return (tmax >= torch.clamp(tmin, min=_T_BACK)) & (tmin < bt)


def raycast_large_plain(tabs: LargeMeshTables, pos, vel, exclude, reach: bool = False):
    """The plain torch version: every chunk solved for every ray (no skip),
    in chunk order. pos, vel (N, 3) f32, exclude (N,) i32 -> (t (N,) f32 in
    ps [inf if none], facet (N,) i32 [-1 if none]); with `reach`, also the
    (nc, N) bool mask of the rays that reach each chunk's box before their
    best hit so far (the kernel's skip test; the bound counts its work)."""
    N = pos.shape[0]
    dev = pos.device
    t_out = torch.full((N,), float("inf"), dtype=torch.float32, device=dev)
    f_out = torch.full((N,), -1, dtype=torch.int32, device=dev)
    mask = torch.zeros((tabs.nc, N), dtype=torch.bool, device=dev) if reach else None
    frame = tabs.bbox[6:9]
    for s in range(0, N, _PLAIN_LANES):
        e = min(N, s + _PLAIN_LANES)
        x = [pos[s:e, k] for k in range(3)]
        v = [vel[s:e, k] for k in range(3)]
        ex = exclude[s:e]
        bt = t_out[s:e]
        bf = f_out[s:e]
        if reach:
            inv = [torch.ones_like(v[k]) / torch.where(v[k].abs() > 1e-30, v[k], 1e-30) for k in range(3)]
        for c in range(tabs.nc):
            if reach:
                mask[c, s:e] = _reach(tabs, c, x, inv, bt)
            tc, fc = _solve_chunk(tabs.tab[:TAB_ROWS, c * BF:(c + 1) * BF], frame[:, c], x, v, ex)
            closer = tc < bt
            bt = torch.where(closer, tc, bt)
            bf = torch.where(closer, fc, bf)
        t_out[s:e] = bt
        f_out[s:e] = bf
    return (t_out, f_out, mask) if reach else (t_out, f_out)


def chunks_reached(mask: torch.Tensor) -> int:
    """Chunks reached, summed over groups of BOUND_GROUP consecutive rays
    (a chunk counts once for a group when one of its rays reaches it): the
    pairs the bound counts are this times BOUND_GROUP * BF, whatever the
    kernel's launch shape."""
    nc, N = mask.shape
    pad = -N % BOUND_GROUP
    m = torch.nn.functional.pad(mask, (0, pad)).reshape(nc, -1, BOUND_GROUP)
    return int(m.any(dim=2).sum())


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

THREADS_PER_RAY = (1, 8, 16)  # the G the kernel is built for: launch_shape's choices


def launch_shape(n: int) -> int:
    """G, the threads that share each of n rays: 16 up to 4,096 rays, 8 up
    to 262,144, else 1 — the fastest G at each of the large mesh's widths
    on an H100 (PERF.md §6: 3,304 rays at G = 16, 5,120 and 52,805 at
    G = 8, the 1,277,952-ray pool at G = 1). A few thousand rays fill the
    card only when threads share them; at the pool's width a shared ray
    costs its redundant slab tests and the combine."""
    if n <= 4096:
        return 16
    if n <= 262144:
        return 8
    return 1


def launch_blocks(n: int, g: int) -> int:
    """Blocks of THREADS threads the kernel launches for n rays at G = g: a
    block holds THREADS / g rays, thread t of block b serves ray
    b * THREADS / g + t // g, and the last block masks the rays past n."""
    return -(-n // (THREADS // g))


def raycast_large(geo, pos, vel, exclude, staged: torch.Tensor | None = None):
    """(t_hit (N,) f32 in ps [inf if none], facet (N,) i32 [-1 if none]) of
    rays pos, vel (N, 3) f32 (any strides), exclude (N,) i32 against the
    geometry's mesh. A CPU ray takes the plain version, a CUDA ray launches
    kernel E with `launch_shape(N)` threads a ray. `staged`, an int32 CUDA
    tensor of at least `launch_blocks(N, launch_shape(N))` elements,
    receives the number of chunks each block staged."""
    global launches
    tabs = prep(geo)
    if pos.device.type != "cuda":
        return raycast_large_plain(tabs, pos, vel, exclude)
    from nanokappa_torch.ops import _cuda

    N = pos.shape[0]
    for name, a in (("pos", pos), ("vel", vel)):
        if a.dim() != 2 or a.shape != (N, 3) or a.dtype != torch.float32:
            raise ValueError(f"raycast_large: {name} must be (N, 3) float32")
    if exclude.shape != (N,) or exclude.dtype != torch.int32:
        raise ValueError("raycast_large: exclude must be (N,) int32")
    if tabs.rec is None or any(a.device != pos.device for a in (tabs.rec, vel, exclude)):
        raise ValueError("raycast_large: the rays and the mesh tables must share a device")
    g = launch_shape(N)
    if staged is not None and (staged.dtype != torch.int32 or staged.numel() < launch_blocks(N, g)):
        raise ValueError("raycast_large: staged must hold one int32 per block")
    exclude = exclude.contiguous()
    t = torch.empty(N, dtype=torch.float32, device=pos.device)
    f = torch.empty(N, dtype=torch.int32, device=pos.device)
    lib = _cuda.library()
    err = lib.nk_raycast_large(
        _cuda.ptr(pos), _cuda.ptr(vel), pos.stride(0), pos.stride(1), vel.stride(0),
        vel.stride(1), _cuda.ptr(exclude), N, _cuda.ptr(tabs.rec), _cuda.ptr(tabs.bbox),
        _cuda.ptr(tabs.reach), tabs.nc, g, _cuda.ptr(t), _cuda.ptr(f),
        _cuda.ptr(staged) if staged is not None else None, _cuda.stream(pos),
    )
    _cuda.check(err, "nk_raycast_large")
    launches += 1
    launch_widths[N] = launch_widths.get(N, 0) + 1
    return t, f
