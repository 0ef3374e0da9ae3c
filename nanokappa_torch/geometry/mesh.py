"""Host-side triangle mesh engine (NumPy; runs once at setup).

The reference implements a from-scratch mesh class with facet grouping,
winding repair, containment, sampling and ray casting
(classes/Mesh.py:20-975). Here the host mesh only *prepares* static data:
coplanar-facet grouping, outward orientation, areas/normals/volume,
point containment and sampling. Per-timestep ray casting happens on device
(ops/raycast.py) against the SoA triangle arrays this class exports.
"""

from __future__ import annotations

import numpy as np

TOL = 1e-8


class TriMesh:
    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.vertices = np.asarray(vertices, dtype=float)
        self.faces = np.asarray(faces, dtype=int)
        self.update()

    # -- core properties -----------------------------------------------------

    def update(self):
        v = self.vertices
        f = self.faces
        self.tri = v[f]  # (F,3,3)
        e1 = self.tri[:, 1] - self.tri[:, 0]
        e2 = self.tri[:, 2] - self.tri[:, 0]
        cr = np.cross(e1, e2)
        self.face_areas = 0.5 * np.linalg.norm(cr, axis=1)
        with np.errstate(invalid="ignore"):
            self.face_normals = cr / np.maximum(np.linalg.norm(cr, axis=1), 1e-300)[:, None]
        self.face_centroids = self.tri.mean(axis=1)
        self.bounds = np.stack([v.min(axis=0), v.max(axis=0)])
        self._detect_interfaces()
        self._orient_outward()
        self._group_facets()
        self._compute_volume()

    def _detect_interfaces(self):
        """Mark internal (interface) faces: coplanar membranes whose boundary
        edges are shared by >2 faces (reference get_interfaces,
        classes/Mesh.py:329-352). Runs BEFORE orientation: internal faces are
        excluded from every ray-parity count (winding, containment) and from
        the divergence-theorem volume, but stay in the face set so device ray
        casting still collides with them (reference find_boundary keeps them,
        classes/Mesh.py:806-856; only check_winding masks them out, :132)."""
        F = len(self.faces)
        self.face_is_interface = np.zeros(F, dtype=bool)
        # edge -> number of incident faces, over the whole mesh
        e0 = np.sort(self.faces[:, [0, 1]], axis=1)
        e1 = np.sort(self.faces[:, [1, 2]], axis=1)
        e2 = np.sort(self.faces[:, [2, 0]], axis=1)
        all_edges = np.concatenate([e0, e1, e2])  # (3F,2)
        uniq, inv, counts = np.unique(
            all_edges, axis=0, return_inverse=True, return_counts=True
        )
        if not np.any(counts > 2):
            return
        edge_count = counts  # per unique edge
        face_edge = inv.reshape(3, F).T  # (F,3) unique-edge ids per face

        groups = _coplanar_groups(self.faces, self.face_normals, self.tri)
        for g in np.unique(groups):
            fs = np.nonzero(groups == g)[0]
            # boundary edges of this facet: used exactly once within it.
            # np.all over an EMPTY boundary set is True — a coplanar group
            # with no free edges (e.g. a doubled membrane sheet) is internal,
            # exactly as the reference's np.isin([], ...) check behaves.
            ge = face_edge[fs].reshape(-1)
            ge_u, ge_c = np.unique(ge, return_counts=True)
            boundary = ge_u[ge_c == 1]
            if np.all(edge_count[boundary] > 2):
                self.face_is_interface[fs] = True

    def _compute_volume(self):
        """Signed volume by divergence theorem over oriented faces
        (reference computes it from the Delaunay tetrahedralisation,
        classes/Mesh.py:538-568; the surface integral is equivalent for a
        closed outward-oriented mesh). Internal membranes are excluded: they
        are not part of the closed boundary."""
        ext = ~self.face_is_interface
        a, b, c = self.tri[ext, 0], self.tri[ext, 1], self.tri[ext, 2]
        self.volume = float(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0)
        if self.volume < 0:  # globally inverted winding
            self.faces = self.faces[:, ::-1]
            self.update()
            return
        w = np.einsum("ij,ij->i", a, np.cross(b, c))
        cm = ((a + b + c) / 4.0 * w[:, None]).sum(axis=0)
        self.center_mass = cm / max(6.0 * self.volume, 1e-300)

    def _orient_outward(self):
        """Flip faces whose normal points inward.

        Uses ray-parity like the reference winding check (classes/Mesh.py:114-160):
        a face normal is outward if a ray from just outside the face along the
        normal crosses the surface an even number of times.
        """
        eps = 1e-6 * max(np.ptp(self.bounds, axis=0).max(), 1.0)
        ext = ~self.face_is_interface
        origins = self.face_centroids + self.face_normals * eps
        # jitter the ray off the normal: on symmetric meshes the exact normal
        # ray can exit through a triangle edge shared by two faces and get
        # counted twice (the reference dedupes duplicate hits instead,
        # classes/Mesh.py:149-153)
        jitter = np.array([0.5385125363, 0.3122954034, 0.7826247243])
        d = self.face_normals + 1e-3 * jitter
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        crossings = self._count_crossings(origins[ext], d[ext])
        flip = np.zeros(len(self.faces), dtype=bool)
        flip[ext] = crossings % 2 == 1  # odd -> normal points into the solid
        if np.any(flip):
            self.faces[flip] = self.faces[flip][:, ::-1]
            v = self.vertices
            self.tri = v[self.faces]
            e1 = self.tri[:, 1] - self.tri[:, 0]
            e2 = self.tri[:, 2] - self.tri[:, 0]
            cr = np.cross(e1, e2)
            with np.errstate(invalid="ignore"):
                self.face_normals = cr / np.maximum(
                    np.linalg.norm(cr, axis=1), 1e-300
                )[:, None]

    def _count_crossings(self, origins: np.ndarray, directions: np.ndarray) -> np.ndarray:
        """Number of ray-surface intersections (Moller-Trumbore, all pairs).
        Internal membrane faces are never counted: an open internal sheet
        breaks the even/odd parity of a closed boundary (reference masks them
        out of the winding parity, classes/Mesh.py:132)."""
        tri = self.tri[~self.face_is_interface]
        a = tri[:, 0]
        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        # native kernel for the uniform-direction case on large meshes
        if len(tri) * len(origins) > 1 << 22 and np.allclose(
            directions, directions[0]
        ):
            from nanokappa_torch import native

            out = native.count_crossings(origins, directions[0], a, e1, e2)
            if out is not None:
                return out.astype(int)
        n_hits = np.zeros(origins.shape[0], dtype=int)
        stride = 4096
        for s in range(0, origins.shape[0], stride):
            o = origins[s : s + stride]
            d = directions[s : s + stride]
            h = np.cross(d[:, None, :], e2[None, :, :])  # (n,F,3)
            det = np.einsum("fj,nfj->nf", e1, h)
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / det
                sv = o[:, None, :] - a[None, :, :]
                u = np.einsum("nfj,nfj->nf", sv, h) * inv
                q = np.cross(sv, e1[None, :, :])
                w = np.einsum("nj,nfj->nf", d, q) * inv
                t = np.einsum("fj,nfj->nf", e2, q) * inv
            with np.errstate(invalid="ignore"):
                hit = (
                    (np.abs(det) > 1e-12)
                    & (u >= -TOL)
                    & (w >= -TOL)
                    & (u + w <= 1 + TOL)
                    & (t > TOL)
                )
            n_hits[s : s + stride] = hit.sum(axis=1)
        return n_hits

    def _group_facets(self):
        """Group coplanar connected faces into facets
        (reference classes/Mesh.py:244-308; the coplanarity test is UNSIGNED,
        |n.n'| > 1-tol at :262, so both sheets of a doubled membrane land in
        one facet)."""
        roots = _coplanar_groups(self.faces, self.face_normals, self.tri)
        _, self.face_facet = np.unique(roots, return_inverse=True)
        self.n_facets = int(self.face_facet.max()) + 1

        self.facets = [np.nonzero(self.face_facet == i)[0] for i in range(self.n_facets)]
        self.facet_normals = np.stack(
            [self.face_normals[fs[0]] for fs in self.facets]
        )
        self.facet_areas = np.array(
            [self.face_areas[fs].sum() for fs in self.facets]
        )
        self.facet_centroids = np.stack(
            [
                (self.face_centroids[fs] * self.face_areas[fs, None]).sum(axis=0)
                / self.face_areas[fs].sum()
                for fs in self.facets
            ]
        )
        # a facet is internal iff all its faces are (reference interfacets,
        # classes/Mesh.py:343-348)
        self.facet_is_interface = np.array(
            [bool(np.all(self.face_is_interface[fs])) for fs in self.facets]
        )
        self.interfacets = np.nonzero(self.facet_is_interface)[0]

    # -- queries ---------------------------------------------------------------

    def contains(self, points: np.ndarray) -> np.ndarray:
        """Ray-parity point containment (reference classes/Mesh.py:516-536)."""
        points = np.atleast_2d(points)
        inb = np.all(
            (points >= self.bounds[0] - TOL) & (points <= self.bounds[1] + TOL), axis=1
        )
        out = np.zeros(points.shape[0], dtype=bool)
        if np.any(inb):
            # incommensurate direction: never aligned with mesh edges/faces of
            # axis-aligned or symmetric geometries (avoids double-counted
            # edge crossings; the reference disambiguates duplicate hits
            # explicitly, classes/Mesh.py:149-153)
            d = np.tile(
                np.array([0.5385125363, 0.3122954034, 0.7826247243]),
                (int(inb.sum()), 1),
            )
            out[inb] = self._count_crossings(points[inb], d) % 2 == 1
        return out

    def sample_volume(self, n: int, rng: np.random.Generator | None = None) -> np.ndarray:
        """Uniform interior samples.

        Primary path: volume-weighted Delaunay simplex sampling (reference
        sample_volume, classes/Mesh.py:890-904) — O(n) regardless of how
        sparsely the solid fills its bounding box (freewire/star/thin shells,
        where bbox rejection grinds). The tetrahedralisation is built lazily
        from vertices + interior/surface seed points, keeping tetrahedra
        whose centroid lies inside the solid; if its volume disagrees with
        the surface-integral volume by >1% (pathological concavity), samples
        fall back to bbox rejection. A final containment filter rejects the
        tiny fraction of samples a concave tetra can push outside."""
        rng = rng or np.random.default_rng()
        tet = self._tetrahedra()
        if tet is None:
            return self._sample_volume_rejection(n, rng)
        tets, cdf = tet
        out = np.zeros((0, 3))
        want = n
        for _ in range(16):
            pick = np.searchsorted(cdf, rng.uniform(size=int(want * 1.05) + 16))
            pick = np.minimum(pick, len(cdf) - 1)
            tet4 = tets[pick]  # (k,4,3)
            # uniform barycentric in a tetrahedron: cube folding
            # (Rocchini & Cignoni, JGT 2000)
            s, t, u = rng.uniform(size=(3, len(pick)))
            m1 = s + t > 1
            s = np.where(m1, 1 - s, s)
            t = np.where(m1, 1 - t, t)
            sum3 = s + t + u
            m2 = t + u > 1
            m3 = ~m2 & (sum3 > 1)
            t2 = np.where(m2, 1 - u, t)
            s2 = np.where(m3, 1 - t - u, s)
            u2 = np.where(m2 | m3, sum3 - 1, u)
            a = 1 - s2 - t2 - u2
            bary = np.stack([a, s2, t2, u2], axis=1)  # (k,4) all >= 0
            cand = np.einsum("kj,kjd->kd", bary, tet4)
            cand = cand[self.contains(cand)]
            out = np.vstack([out, cand])
            if out.shape[0] >= n:
                return out[:n]
            want = n - out.shape[0]
        # concave pathological case: top up by rejection
        rest = self._sample_volume_rejection(n - out.shape[0], rng)
        return np.vstack([out, rest])[:n]

    def _sample_volume_rejection(
        self, n: int, rng: np.random.Generator
    ) -> np.ndarray:
        """Bbox rejection sampling (reference classes/Mesh.py:906-921)."""
        lo, hi = self.bounds
        out = np.zeros((0, 3))
        while out.shape[0] < n:
            cand = rng.uniform(lo, hi, size=(max(2 * n, 1024), 3))
            cand = cand[self.contains(cand)]
            out = np.vstack([out, cand])
        return out[:n]

    def _tetrahedra(self):
        """Lazy Delaunay volume tetrahedralisation (reference
        triangulate_volume, classes/Mesh.py:354-486): vertices + seed points,
        tetrahedra kept by centroid containment, volume-weighted CDF."""
        if hasattr(self, "_tet_cache"):
            return self._tet_cache
        self._tet_cache = None
        try:
            from scipy.spatial import Delaunay, QhullError
        except Exception:  # pragma: no cover
            return None
        rng = np.random.default_rng(0)
        try:
            # seed with surface points so concave regions get fine tetrahedra
            # (the reference densifies with sampled surface/volume points)
            n_seed = min(4 * len(self.faces), 2000)
            fs = rng.integers(0, len(self.faces), n_seed)
            r1, r2 = rng.uniform(size=(2, n_seed))
            su = np.sqrt(r1)
            b = np.stack([1 - su, su * (1 - r2), su * r2], axis=1)
            surf = np.einsum("nk,nkj->nj", b, self.tri[fs])
            pts = np.vstack([self.vertices, surf])
            dela = Delaunay(pts)
        except (QhullError, ValueError):
            return None
        tets = pts[dela.simplices]  # (T,4,3)
        e1 = tets[:, 1] - tets[:, 0]
        e2 = tets[:, 2] - tets[:, 0]
        e3 = tets[:, 3] - tets[:, 0]
        vols = np.abs(np.einsum("ij,ij->i", e1, np.cross(e2, e3))) / 6.0
        keep = (vols > 1e-12) & self.contains(tets.mean(axis=1))
        tets, vols = tets[keep], vols[keep]
        if len(tets) == 0:
            return None
        total = vols.sum()
        if not (0.99 * self.volume <= total <= 1.01 * self.volume):
            return None  # concave misfit -> rejection fallback
        self._tet_cache = (tets, np.cumsum(vols) / total)
        return self._tet_cache

    def sample_surface(
        self, n: int, facet: int, rng: np.random.Generator | None = None
    ) -> np.ndarray:
        """Area-weighted uniform samples on one facet
        (reference classes/Mesh.py:923-951)."""
        rng = rng or np.random.default_rng()
        fs = self.facets[facet]
        areas = self.face_areas[fs]
        probs = areas / areas.sum()
        tri_idx = rng.choice(fs, size=n, p=probs)
        r1, r2 = rng.uniform(size=(2, n))
        su = np.sqrt(r1)
        b = np.stack([1 - su, su * (1 - r2), su * r2], axis=1)  # (n,3)
        return np.einsum("nk,nkj->nj", b, self.tri[tri_idx])

    def closest_facet(self, points: np.ndarray) -> np.ndarray:
        """Index of the facet nearest to each point
        (reference classes/Mesh.py:686-744 via closest face)."""
        points = np.atleast_2d(points)
        d = _point_triangle_distance(points, self.tri)  # (N,F)
        face = np.argmin(d, axis=1)
        return self.face_facet[face]

    def rezero(self):
        self.vertices = self.vertices - self.vertices.min(axis=0)
        self.update()


def _coplanar_groups(
    faces: np.ndarray, face_normals: np.ndarray, tri: np.ndarray
) -> np.ndarray:
    """Unsigned coplanar plane key + edge connectivity -> facet components.

    Mirrors the reference coplanarity rule |n.n'| > 1-tol with equal |k|
    (classes/Mesh.py:260-266): normals are sign-canonicalised before keying,
    so antiparallel coincident sheets group together."""
    # flip decided on the ROUNDED normal (consistent across a facet); the
    # plane offset uses the EXACT normal — n_exact.v is constant over the
    # plane to f64 precision, while a rounded normal shifts it by ~1e-6*|v|
    nr = np.round(face_normals, 6) + 0.0  # +0.0 kills -0.0 in the keys
    flip = (
        (nr[:, 0] < 0)
        | ((nr[:, 0] == 0) & (nr[:, 1] < 0))
        | ((nr[:, 0] == 0) & (nr[:, 1] == 0) & (nr[:, 2] < 0))
    )
    sign = np.where(flip, -1.0, 1.0)
    n = nr * sign[:, None]
    off = np.einsum("ij,ij->i", face_normals * sign[:, None], tri[:, 0])
    keys = np.round(np.concatenate([n, off[:, None]], axis=1), 6) + 0.0
    _, plane = np.unique(keys, axis=0, return_inverse=True)
    return _connected_components(faces, plane)


def _connected_components(faces: np.ndarray, plane: np.ndarray) -> np.ndarray:
    """Group faces into edge-connected components within each plane id.

    Returns a (F,) component label per face (union-find over shared edges,
    restricted to faces with the same `plane` key)."""
    F = len(faces)
    parent = np.arange(F)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    edge_map: dict[tuple[int, int], int] = {}
    for fi, face in enumerate(faces):
        for k in range(3):
            e = (face[k], face[(k + 1) % 3])
            e = (min(e), max(e))
            if e in edge_map:
                fj = edge_map[e]
                if plane[fi] == plane[fj]:
                    parent[find(fi)] = find(fj)
            else:
                edge_map[e] = fi
    return np.array([find(i) for i in range(F)])


def _point_triangle_distance(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Exact point-to-triangle distances, (N, F). Ericson's real-time method."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    ab = b - a
    ac = c - a
    N, F = p.shape[0], tri.shape[0]
    ap = p[:, None, :] - a[None, :, :]  # (N,F,3)
    d1 = np.einsum("fj,nfj->nf", ab, ap)
    d2 = np.einsum("fj,nfj->nf", ac, ap)
    bp = p[:, None, :] - b[None, :, :]
    d3 = np.einsum("fj,nfj->nf", ab, bp)
    d4 = np.einsum("fj,nfj->nf", ac, bp)
    cp = p[:, None, :] - c[None, :, :]
    d5 = np.einsum("fj,nfj->nf", ab, cp)
    d6 = np.einsum("fj,nfj->nf", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = np.maximum(va + vb + vc, 1e-300)
    v = vb / denom
    w = vc / denom
    # interior projection
    closest = a[None] + v[..., None] * ab[None] + w[..., None] * ac[None]

    # edge/vertex regions
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ab = np.clip(d1 / np.where(d1 - d3 == 0, 1e-300, d1 - d3), 0, 1)
        t_ac = np.clip(d2 / np.where(d2 - d6 == 0, 1e-300, d2 - d6), 0, 1)
        t_bc = np.clip(
            (d4 - d3) / np.where((d4 - d3) + (d5 - d6) == 0, 1e-300, (d4 - d3) + (d5 - d6)),
            0,
            1,
        )

    pt_a = np.broadcast_to(a[None], (N, F, 3))
    on_ab = a[None] + t_ab[..., None] * ab[None]
    on_ac = a[None] + t_ac[..., None] * ac[None]
    on_bc = b[None] + t_bc[..., None] * (c - b)[None]

    closest = np.where((vc <= 0)[..., None] & (d1 >= 0)[..., None] & (d3 <= 0)[..., None], on_ab, closest)
    closest = np.where((vb <= 0)[..., None] & (d2 >= 0)[..., None] & (d6 <= 0)[..., None], on_ac, closest)
    closest = np.where(
        (va <= 0)[..., None] & ((d4 - d3) >= 0)[..., None] & ((d5 - d6) >= 0)[..., None],
        on_bc,
        closest,
    )
    closest = np.where((d1 <= 0)[..., None] & (d2 <= 0)[..., None], pt_a, closest)
    closest = np.where((d3 >= 0)[..., None] & (d4 <= d3)[..., None], np.broadcast_to(b[None], (N, F, 3)), closest)
    closest = np.where((d6 >= 0)[..., None] & (d5 <= d6)[..., None], np.broadcast_to(c[None], (N, F, 3)), closest)

    return np.linalg.norm(p[:, None, :] - closest, axis=-1)
