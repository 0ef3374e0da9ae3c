"""DeviceGeometry: frozen SoA geometry tensors for the device step.

The torch twin of nanokappa_tpu/geometry/device.py: the same fields, built by
the same host arithmetic, as float32/int32 tensors on an explicit device.
Box fields come first in what the port uses: the film's in-kernel ray cast
and its in-kernel event rounds read only the six box facets' tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from nanokappa_torch.geometry.domain import Domain


@dataclass(frozen=True)
class DeviceGeometry:
    # axis-aligned-box fast path (zero-filled when not a box)
    box_axis: torch.Tensor  # (NF,) i32 axis of each facet plane
    box_sign: torch.Tensor  # (NF,) f32 outward direction sign
    box_plane: torch.Tensor  # (NF,) f32 plane coordinate

    # triangle soup (F triangles)
    tri_origin: torch.Tensor  # (F,3)
    tri_e1: torch.Tensor  # (F,3)
    tri_e2: torch.Tensor  # (F,3)
    tri_facet: torch.Tensor  # (F,) i32

    # per-facet data (NF facets)
    facet_normal: torch.Tensor  # (NF,3) outward unit normals
    facet_bc: torch.Tensor  # (NF,) i32 BC enum
    facet_value: torch.Tensor  # (NF,) f32 (reservoir T or roughness eta)
    facet_res: torch.Tensor  # (NF,) i32 reservoir index or -1
    facet_rough: torch.Tensor  # (NF,) i32 rough-facet index or -1
    periodic_shift: torch.Tensor  # (NF,3) translation to the paired facet
    periodic_pair: torch.Tensor  # (NF,) i32 paired facet id (-1 if none)

    # reservoir surface sampling
    res_tri_idx: torch.Tensor  # (R,K) i32 triangle ids (padded with first id)
    res_tri_cdf: torch.Tensor  # (R,K) f32 cumulative area fraction (last = 1)
    res_facet: torch.Tensor  # (R,) i32 facet id of each reservoir
    res_temperature: torch.Tensor  # (R,) f32
    res_area: torch.Tensor  # (R,) f32
    res_normal: torch.Tensor  # (R,3) outward normal of each reservoir facet
    res_rect: torch.Tensor  # (R,9) [origin, span1, span2] of each box wall

    # subvolumes
    subvol_center: torch.Tensor  # (SV,3)
    subvol_volume: torch.Tensor  # (SV,)
    bounds: torch.Tensor  # (2,3)

    n_facets: int = field(metadata=dict(static=True))
    n_reservoirs: int = field(metadata=dict(static=True))
    n_rough: int = field(metadata=dict(static=True))
    n_subvols: int = field(metadata=dict(static=True))
    subvol_type: str = field(metadata=dict(static=True))
    slice_axis: int = field(metadata=dict(static=True))
    volume: float = field(metadata=dict(static=True))
    is_box: bool = field(metadata=dict(static=True), default=False)

    @cached_property
    def subvol_c2(self) -> torch.Tensor:
        """(SV,) f32 |c|^2 of each centre for the nearest-centre classifier
        (center_sq_norms), derived once from subvol_center."""
        return torch.as_tensor(center_sq_norms(host(self.subvol_center)), device=self.device)

    @property
    def device(self) -> torch.device:
        return self.bounds.device


def host(t: torch.Tensor) -> np.ndarray:
    """NumPy copy of a (possibly CUDA) table tensor, for host-side logic."""
    return t.detach().cpu().numpy()


def center_sq_norms(centers: np.ndarray) -> np.ndarray:
    """|c|^2 of each float32 centre, summed in float64 and rounded once to
    float32: the JAX kernel's rounding up to its 32-centre unroll
    (nanokappa_tpu/ops/megastep.py:451), taken here for every centre count
    (beyond 32 the JAX kernel sums in float32, the XLA classifier takes a
    matmul: their ids differ from the port's only at near-ties)."""
    c = np.asarray(centers, np.float32).astype(np.float64)
    return ((c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]) + c[:, 2] * c[:, 2]).astype(np.float32)


def resolve_device(device=None) -> torch.device:
    """The device a builder puts its tensors on: the CUDA card unless the
    caller names another one (the CPU tests pass device="cpu"). Without a
    card and without a device, this raises instead of building on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card: pass device='cpu' to build on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def build_device_geometry(domain: Domain, device=None) -> DeviceGeometry:
    device = resolve_device(device)
    mesh = domain.mesh
    nf = mesh.n_facets

    tri = mesh.tri
    tri_origin = tri[:, 0]
    tri_e1 = tri[:, 1] - tri[:, 0]
    tri_e2 = tri[:, 2] - tri[:, 0]

    facet_res = np.full(nf, -1, dtype=np.int32)
    facet_res[domain.res_facets] = np.arange(len(domain.res_facets))
    facet_rough = np.full(nf, -1, dtype=np.int32)
    facet_rough[domain.rough_facets] = np.arange(len(domain.rough_facets))

    shifts = np.zeros((nf, 3))
    pairs = np.full(nf, -1, dtype=np.int32)
    for a, b in domain.connected_facets:
        shifts[a] = mesh.facet_centroids[b] - mesh.facet_centroids[a]
        shifts[b] = mesh.facet_centroids[a] - mesh.facet_centroids[b]
        pairs[a], pairs[b] = b, a

    # reservoir triangle tables
    R = len(domain.res_facets)
    if R > 0:
        K = max(len(mesh.facets[f]) for f in domain.res_facets)
        res_tri_idx = np.zeros((R, K), dtype=np.int32)
        res_tri_cdf = np.ones((R, K))
        for i, f in enumerate(domain.res_facets):
            fs = mesh.facets[f]
            res_tri_idx[i, : len(fs)] = fs
            res_tri_idx[i, len(fs) :] = fs[0]
            cdf = np.cumsum(mesh.face_areas[fs])
            cdf = cdf / cdf[-1]
            res_tri_cdf[i, : len(fs)] = cdf
    else:
        res_tri_idx = np.zeros((0, 1), dtype=np.int32)
        res_tri_cdf = np.ones((0, 1))

    # axis-aligned-box detection: 6 facets whose normals are +-e_i and whose
    # triangles all lie on the facet plane -> collision times become per-axis
    # slab arithmetic instead of triangle intersection
    is_box = False
    box_axis = np.zeros(nf, dtype=np.int32)
    box_sign = np.zeros(nf)
    box_plane = np.zeros(nf)
    if nf == 6:
        is_box = True
        for f in range(6):
            n = mesh.facet_normals[f]
            ax = int(np.argmax(np.abs(n)))
            if abs(abs(n[ax]) - 1.0) > 1e-9 or np.abs(np.delete(n, ax)).max() > 1e-9:
                is_box = False
                break
            pts = mesh.tri[mesh.facets[f]].reshape(-1, 3)
            if np.ptp(pts[:, ax]) > 1e-6:
                is_box = False
                break
            box_axis[f] = ax
            box_sign[f] = np.sign(n[ax])
            box_plane[f] = pts[0, ax]

    # rectangle parameterisation of reservoir facets (box walls are exact
    # rectangles: uniform (u1, u2) over [origin, origin+s1, origin+s2] is the
    # same uniform-on-facet distribution as the triangle-CDF sampler)
    if is_box and R > 0:
        res_rect = np.zeros((R, 9))
        for i, f in enumerate(domain.res_facets):
            pts = mesh.tri[mesh.facets[f]].reshape(-1, 3)
            ax = int(box_axis[f])
            a1, a2 = [a for a in range(3) if a != ax]
            lo, hi = pts.min(axis=0), pts.max(axis=0)
            s1 = np.zeros(3)
            s1[a1] = hi[a1] - lo[a1]
            s2 = np.zeros(3)
            s2[a2] = hi[a2] - lo[a2]
            res_rect[i] = np.concatenate([lo, s1, s2])
    else:
        res_rect = np.zeros((0, 9))

    def f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    def i32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int32), device=device)

    return DeviceGeometry(
        box_axis=i32(box_axis),
        box_sign=f32(box_sign),
        box_plane=f32(box_plane),
        tri_origin=f32(tri_origin),
        tri_e1=f32(tri_e1),
        tri_e2=f32(tri_e2),
        tri_facet=i32(mesh.face_facet),
        facet_normal=f32(mesh.facet_normals),
        facet_bc=i32(domain.bound_cond),
        facet_value=f32(np.nan_to_num(domain.facet_values)),
        facet_res=i32(facet_res),
        facet_rough=i32(facet_rough),
        periodic_shift=f32(shifts),
        periodic_pair=i32(pairs),
        res_tri_idx=i32(res_tri_idx),
        res_tri_cdf=f32(res_tri_cdf),
        res_facet=i32(domain.res_facets),
        res_temperature=f32(np.nan_to_num(domain.res_values)),
        res_area=f32(mesh.facet_areas[domain.res_facets]),
        res_normal=f32(mesh.facet_normals[domain.res_facets]),
        res_rect=f32(res_rect),
        subvol_center=f32(domain.subvol_center),
        subvol_volume=f32(domain.subvol_volume),
        bounds=f32(mesh.bounds),
        n_facets=nf,
        n_reservoirs=R,
        n_rough=len(domain.rough_facets),
        n_subvols=domain.n_of_subvols,
        subvol_type=domain.subvol_type,
        slice_axis=domain.slice_axis,
        volume=float(mesh.volume),
        is_box=is_box,
    )
