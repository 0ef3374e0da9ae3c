"""Primitive geometry generators.

The reference generates 8 parametric shapes (classes/Geometry.py:86-412):
cuboid/box, cylinder(rod/bar), zigzag, corrugated, castle, star, freewire,
plus STL import. Same shapes and the same dims conventions here, built from
two generic constructors: a ring-stack tube (cylinder/zigzag/corrugated/
castle/freewire are all stacks of polygonal rings along z, annular lids
falling out as zero-height segments) and a polygon extrusion (star).
"""

from __future__ import annotations

import numpy as np

from nanokappa_torch.geometry.mesh import TriMesh


def box(dims) -> TriMesh:
    """Axis-aligned box, edge lengths (lx, ly, lz), corner at origin
    (reference 'cuboid'/'box', classes/Geometry.py:87-109)."""
    lx, ly, lz = (float(d) for d in dims[:3])
    v = np.array(
        [
            [0, 0, 0], [lx, 0, 0], [0, ly, 0], [lx, ly, 0],
            [0, 0, lz], [lx, 0, lz], [0, ly, lz], [lx, ly, lz],
        ],
        dtype=float,
    )
    f = np.array(
        [
            [0, 2, 1], [1, 2, 3],
            [4, 5, 6], [5, 7, 6],
            [0, 1, 4], [1, 5, 4],
            [2, 6, 3], [3, 6, 7],
            [0, 4, 2], [2, 4, 6],
            [1, 3, 5], [3, 7, 5],
        ]
    )
    return TriMesh(v, f)


def _ring(radius: float, n: int, z: float, offset=(0.0, 0.0)) -> np.ndarray:
    ang = 2 * np.pi * np.arange(n) / n
    return np.stack(
        [radius * np.cos(ang) + offset[0], radius * np.sin(ang) + offset[1],
         np.full(n, z)],
        axis=1,
    )


def _tube(rings: list[np.ndarray]) -> TriMesh:
    """Closed surface from a stack of same-count rings along z: fan caps at
    both ends + quad side strips between consecutive rings."""
    n = rings[0].shape[0]
    c0 = rings[0].mean(axis=0)
    c1 = rings[-1].mean(axis=0)
    verts = [c0[None, :]] + rings + [c1[None, :]]
    v = np.vstack(verts)
    i_top = v.shape[0] - 1
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces.append([0, 1 + j, 1 + i])  # bottom cap
    for s in range(len(rings) - 1):
        a = 1 + s * n
        b = 1 + (s + 1) * n
        for i in range(n):
            j = (i + 1) % n
            faces.append([a + i, a + j, b + i])
            faces.append([a + j, b + j, b + i])
    last = 1 + (len(rings) - 1) * n
    for i in range(n):
        j = (i + 1) % n
        faces.append([i_top, last + i, last + j])  # top cap
    return TriMesh(v, np.array(faces))


def cylinder(dims) -> TriMesh:
    """dims = (length, radius, n_sides); axis along z
    (reference classes/Geometry.py:110-143)."""
    L, R, N = float(dims[0]), float(dims[1]), int(dims[2])
    return _tube([_ring(R, N, 0.0), _ring(R, N, L)])


def zigzag(dims) -> TriMesh:
    """dims = (section_length, radius, dx, dy, n_sides, n_sections): prism
    sections along z, odd sections displaced by (dx, dy)
    (reference classes/Geometry.py:144-180)."""
    L, R, dx, dy, Ns, Nc = (
        float(dims[0]), float(dims[1]), float(dims[2]), float(dims[3]),
        int(dims[4]), int(dims[5]),
    )
    rings = [_ring(R, Ns, 0.0)]
    for i in range(1, Nc + 1):
        off = (dx, dy) if i % 2 == 1 else (0.0, 0.0)
        rings.append(_ring(R, Ns, i * L, off))
    return _tube(rings)


def corrugated(dims) -> TriMesh:
    """dims = (section_length, outer_radius, inner_radius, n_sides,
    n_sections): radius alternates R / r per ring, conical sections
    (reference classes/Geometry.py:181-221)."""
    L, R, r, Ns, Nc = (
        float(dims[0]), float(dims[1]), float(dims[2]), int(dims[3]), int(dims[4])
    )
    rings = [_ring(R if i % 2 == 0 else r, Ns, i * L) for i in range(Nc + 1)]
    return _tube(rings)


def castle(dims) -> TriMesh:
    """dims = (L_large, l_small, outer_R, inner_r, n_sides, n_castles, start):
    piecewise-constant radius sections with annular lids at transitions
    (reference classes/Geometry.py:222-319)."""
    L, l, R, r, Ns, Nc = (
        float(dims[0]), float(dims[1]), float(dims[2]), float(dims[3]),
        int(dims[4]), int(dims[5]),
    )
    s = bool(float(dims[6])) if len(dims) > 6 else True
    if R <= r:
        raise ValueError("castle: outer radius must exceed the inner radius")
    rings = []
    z = 0.0
    large = s
    for _ in range(Nc):
        rad, ln = (R, L) if large else (r, l)
        rings += [_ring(rad, Ns, z), _ring(rad, Ns, z + ln)]
        z += ln
        large = not large
    return _tube(rings)


def star(dims) -> TriMesh:
    """dims = (height, outer_radius, inner_radius, n_points): star-polygon
    cross-section extruded along z (reference classes/Geometry.py:320-376)."""
    H, R, r, N = float(dims[0]), float(dims[1]), float(dims[2]), int(dims[3])
    if R <= r:
        raise ValueError("star: outer radius must exceed the inner radius")
    outer_ang = np.arange(N) * 2 * np.pi / N
    inner_ang = (np.arange(N) - 0.5) * 2 * np.pi / N
    poly = np.zeros((2 * N, 2))
    poly[0::2] = np.stack([r * np.cos(inner_ang), r * np.sin(inner_ang)], axis=1)
    poly[1::2] = np.stack([R * np.cos(outer_ang), R * np.sin(outer_ang)], axis=1)
    ring0 = np.concatenate([poly, np.zeros((2 * N, 1))], axis=1)
    ring1 = np.concatenate([poly, np.full((2 * N, 1), H)], axis=1)
    return _tube([ring0, ring1])


def freewire(dims) -> TriMesh:
    """dims = (R0, L1, R1, L2, R2, ..., n_sides): user-defined radius profile,
    conical sections (reference classes/Geometry.py:377-411)."""
    radii = np.array([dims[i] for i in range(0, len(dims) - 1, 2)], dtype=float)
    lengths = np.array([dims[i] for i in range(1, len(dims) - 1, 2)], dtype=float)
    N = int(dims[-1])
    z = np.concatenate([[0.0], np.cumsum(lengths)])
    rings = [_ring(radii[i], N, z[i]) for i in range(len(radii))]
    return _tube(rings)


_REGISTRY = {
    "box": box,
    "cuboid": box,
    "cylinder": cylinder,
    "rod": cylinder,
    "bar": cylinder,
    "zigzag": zigzag,
    "corrugated": corrugated,
    "castle": castle,
    "star": star,
    "freewire": freewire,
}


def make_primitive(shape: str, dimensions, **kw) -> TriMesh:
    if shape not in _REGISTRY:
        raise ValueError(
            f"unknown geometry '{shape}'; available: {sorted(_REGISTRY)} or an .stl path"
        )
    return _REGISTRY[shape](dimensions, **kw)
