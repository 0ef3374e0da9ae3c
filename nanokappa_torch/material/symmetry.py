"""From-scratch crystal symmetry machinery (spglib/phonopy are not available).

The reference obtains reciprocal-space symmetry operations from phonopy
(classes/Phonon.py:74-81) and uses them to expand IBZ phonon data to the full
Brillouin zone (classes/Phonon.py:515-564). Here we derive the same group
directly:

1. lattice point group: integer matrices W (entries in {-1,0,1}, det = +-1)
   in the basis of the lattice vectors that preserve the metric tensor
   G = L L^T,
2. crystal rotations: the subgroup of (1) for which a fractional translation w
   exists such that {W x + w} maps the atomic basis onto itself
   species-by-species,
3. reciprocal operations: the set {W^T} of (2), optionally closed under time
   reversal q -> -q (phonopy's Symmetry.get_reciprocal_operations default).

All operations act on *reduced* coordinates; the cartesian action on vectors
(e.g. group velocities) is B R B^-1 with B the reciprocal lattice
(columns), exactly as the reference applies it (classes/Phonon.py:530).
"""

from __future__ import annotations

import itertools

import numpy as np

from nanokappa_torch.material.poscar import Crystal


def lattice_point_group(lattice: np.ndarray, tol: float = 1e-5) -> np.ndarray:
    """All integer rotations W with W^T G W = G for metric G = L L^T.

    Returns (n_ops, 3, 3) int array. Entries of W are in {-1, 0, 1}, which is
    sufficient for reduced (Niggli-like) cells such as primitive POSCAR cells.
    """
    G = lattice @ lattice.T
    scale = float(np.abs(G).max())
    ops = []
    cols = [np.array(c) for c in itertools.product((-1, 0, 1), repeat=3)]
    cols = [c for c in cols if np.any(c != 0)]
    for c0 in cols:
        for c1 in cols:
            for c2 in cols:
                W = np.array([c0, c1, c2]).T
                det = round(float(np.linalg.det(W)))
                if det not in (-1, 1):
                    continue
                if np.abs(W.T @ G @ W - G).max() < tol * scale:
                    ops.append(W)
    return np.array(ops, dtype=int)


def crystal_rotations(crystal: Crystal, tol: float = 1e-5) -> np.ndarray:
    """Rotation parts of the space group of the crystal (fractional basis)."""
    cand = lattice_point_group(crystal.lattice, tol)
    pos = crystal.frac_positions
    kinds = crystal.species_numbers()
    n = pos.shape[0]

    def maps_onto(W: np.ndarray) -> bool:
        xw = pos @ W.T  # W applied to every atom
        # try each translation candidate w = x_j - W x_0 with matching species
        for j in range(n):
            if kinds[j] != kinds[0]:
                continue
            w = pos[j] - xw[0]
            moved = np.mod(xw + w, 1.0)
            # match every moved atom to an original atom of the same species
            d = moved[:, None, :] - pos[None, :, :]
            d -= np.round(d)
            dist = np.abs(d).max(axis=-1)  # (n, n) max-coord distance mod 1
            ok = dist < tol
            ok &= kinds[:, None] == kinds[None, :]
            if np.all(ok.any(axis=1)) and np.all(ok.any(axis=0)):
                return True
        return False

    ops = [W for W in cand if maps_onto(W)]
    return np.array(ops, dtype=int)


def reciprocal_operations(
    crystal: Crystal, tol: float = 1e-5, time_reversal: bool = True
) -> np.ndarray:
    """Unique reciprocal-space rotations {W^T} (+ time reversal) of the crystal."""
    rots = crystal_rotations(crystal, tol)
    recs = [W.T for W in rots]
    if time_reversal:
        recs += [-W.T for W in rots]
    uniq: list[np.ndarray] = []
    for r in recs:
        if not any(np.array_equal(r, u) for u in uniq):
            uniq.append(r)
    return np.array(uniq, dtype=int)


def ir_reciprocal_mesh(
    mesh: np.ndarray | tuple[int, int, int],
    rec_ops: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Reduce a Gamma-centred n1 x n2 x n3 q-grid to its irreducible wedge.

    Used when fabricating phono3py-format data files (the inverse of the
    loader's IBZ->FBZ expansion, reference classes/Phonon.py:515-564).

    Returns (ir_qpoints (Qi,3) reduced coords in [0,1), weights (Qi,) int).
    """
    mesh = np.asarray(mesh, dtype=int)
    n1, n2, n3 = (int(x) for x in mesh)
    grid = np.stack(
        np.meshgrid(np.arange(n1), np.arange(n2), np.arange(n3), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)  # integer grid addresses
    nq = grid.shape[0]

    def addr_to_id(a: np.ndarray) -> np.ndarray:
        a = np.mod(a, mesh)
        return (a[..., 0] * n2 + a[..., 1]) * n3 + a[..., 2]

    mapping = np.arange(nq)
    for R in rec_ops:
        # q' = R q with q = a/m; a' = m * (R (a/m)) must land back on the grid
        # (always true for uniform Gamma-centred grids compatible with R);
        # ops that would leave the grid are skipped.
        qprime = (grid / mesh) @ R.T
        aprime = qprime * mesh
        if not np.allclose(aprime, np.round(aprime), atol=1e-9):
            continue
        ids = addr_to_id(np.round(aprime).astype(int))
        mapping = np.minimum(mapping, mapping[ids])
    # iterate to closure (mapping may need chasing)
    for _ in range(10):
        new = mapping[mapping]
        if np.array_equal(new, mapping):
            break
        mapping = new

    ir_ids, weights = np.unique(mapping, return_counts=True)
    ir_q = grid[ir_ids] / mesh
    return ir_q, weights
