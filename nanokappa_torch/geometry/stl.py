"""Minimal STL reader/writer (trimesh is not a dependency of this framework).

The reference uses trimesh only for STL loading (classes/Geometry.py:82-84)
and has its own ASCII export (classes/Mesh.py:953-975). Both binary and ASCII
STL are supported here.
"""

from __future__ import annotations

import struct

import numpy as np

from nanokappa_torch.geometry.mesh import TriMesh


def load_stl(path: str) -> TriMesh:
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        try:
            return _load_ascii(path)
        except ValueError:
            pass  # some binary files start with 'solid' too
    return _load_binary(path)


def _load_ascii(path: str) -> TriMesh:
    verts = []
    with open(path) as f:
        for line in f:
            t = line.split()
            if t and t[0] == "vertex":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
    if not verts or len(verts) % 3:
        raise ValueError("not a valid ASCII STL")
    return _dedup(np.asarray(verts))


def _load_binary(path: str) -> TriMesh:
    with open(path, "rb") as f:
        f.seek(80)
        (n,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(n * 50), dtype=np.uint8).reshape(n, 50)
    tri = data[:, 12:48].copy().view(np.float32).reshape(n, 3, 3).astype(float)
    return _dedup(tri.reshape(-1, 3))


def _dedup(verts: np.ndarray) -> TriMesh:
    uniq, inv = np.unique(np.round(verts, 6), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3)
    # drop degenerate triangles
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return TriMesh(uniq, faces[ok])


def save_stl(mesh: TriMesh, path: str):
    with open(path, "w") as f:
        f.write("solid nanokappa\n")
        for t, nrm in zip(mesh.tri, mesh.face_normals):
            f.write(f"facet normal {nrm[0]:e} {nrm[1]:e} {nrm[2]:e}\n outer loop\n")
            for v in t:
                f.write(f"  vertex {v[0]:e} {v[1]:e} {v[2]:e}\n")
            f.write(" endloop\nendfacet\n")
        f.write("endsolid nanokappa\n")
