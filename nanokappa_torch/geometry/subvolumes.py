"""Subvolume centre generation: grid placement and Lloyd (voronoi) iteration.

Reference: grid centres classes/Geometry.py:494-539; Lloyd-type iteration
routines/subvolumes.py:39-98 (sample volume, assign to nearest centre, move
centres to centroids, refine until displacement is negligible).
"""

from __future__ import annotations

import numpy as np

from nanokappa_torch.geometry.mesh import TriMesh


def grid_centers(mesh: TriMesh, grid: np.ndarray) -> np.ndarray:
    nx, ny, nz = (int(g) for g in grid)
    xs = (np.arange(nx) + 0.5) / nx
    ys = (np.arange(ny) + 0.5) / ny
    zs = (np.arange(nz) + 0.5) / nz
    g = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1).reshape(-1, 3)
    centers = g * np.ptp(mesh.bounds, axis=0) + mesh.bounds[0]
    return centers[mesh.contains(centers)]


def lloyd_centers(
    mesh: TriMesh,
    n: int,
    rng: np.random.Generator | None = None,
    max_iter: int = 60,
    tol: float = 1e-3,
) -> np.ndarray:
    """Centroidal-Voronoi centres by Lloyd iteration on volume samples."""
    rng = rng or np.random.default_rng(0)
    centers = mesh.sample_volume(n, rng)
    n_samples = 1 << 14
    scale = np.ptp(mesh.bounds, axis=0).max()
    for _ in range(max_iter):
        s = mesh.sample_volume(n_samples, rng)
        d = np.linalg.norm(s[:, None, :] - centers[None], axis=-1)
        r = np.argmin(d, axis=1)
        # centroid per region via bincount (vectorised: a 500-centre domain
        # iterates in milliseconds instead of a Python loop per centroid)
        cnt = np.bincount(r, minlength=n).astype(float)
        sums = np.stack(
            [np.bincount(r, weights=s[:, a], minlength=n) for a in range(3)],
            axis=1,
        )
        new = np.where(
            cnt[:, None] > 0, sums / np.maximum(cnt, 1.0)[:, None], centers
        )
        disp = np.linalg.norm(new - centers, axis=1).max()
        centers = new
        if disp < tol * scale:
            break
        n_samples = min(n_samples * 2, 1 << 20)
    return centers
