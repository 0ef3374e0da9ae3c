"""Domain assembly: mesh + boundary conditions + subvolumes (host side).

Mirrors the behaviour of the reference `Geometry` class
(classes/Geometry.py:35-766): primitive generation / STL import, transform,
boundary-condition facet assignment from probe points with the
"last condition is the default" rule, periodic-facet congruence validation,
and subvolume partitioning (slice / grid / voronoi).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

from nanokappa_torch.geometry.mesh import TriMesh
from nanokappa_torch.geometry.primitives import make_primitive


class BC(IntEnum):
    NONE = 0
    TEMPERATURE = 1  # 'T' isothermal reservoir
    PERIODIC = 2  # 'P'
    ROUGH = 3  # 'R' rough wall (specular/diffuse)
    FLUX = 4  # 'F' heat-flux reservoir (plumbed, not generatable — parity
    #            with the reference, argument_parser.py:48, Population.py:499)


_BC_FROM_STR = {"T": BC.TEMPERATURE, "P": BC.PERIODIC, "R": BC.ROUGH, "F": BC.FLUX}


@dataclass
class Domain:
    mesh: TriMesh
    bound_cond: np.ndarray  # (NF,) BC enum value per facet
    facet_values: np.ndarray  # (NF,) float (T for reservoirs, eta for rough)
    connected_facets: np.ndarray  # (C,2) periodic facet pairs
    subvol_type: str  # 'slice' | 'grid' | 'voronoi'
    slice_axis: int
    subvol_center: np.ndarray  # (SV,3)
    subvol_volume: np.ndarray  # (SV,)
    subvol_connections: np.ndarray  # (NC,2)
    grid: np.ndarray | None = None  # (3,) for grid subvolumes

    # derived
    res_facets: np.ndarray = field(init=False)
    rough_facets: np.ndarray = field(init=False)

    def __post_init__(self):
        self.res_facets = np.nonzero(
            (self.bound_cond == BC.TEMPERATURE) | (self.bound_cond == BC.FLUX)
        )[0]
        self.rough_facets = np.nonzero(self.bound_cond == BC.ROUGH)[0]
        self.n_of_subvols = self.subvol_center.shape[0]
        self.n_of_reservoirs = len(self.res_facets)
        self.volume = self.mesh.volume
        self.bounds = self.mesh.bounds

    @property
    def res_values(self) -> np.ndarray:
        return self.facet_values[self.res_facets]

    @property
    def rough_values(self) -> np.ndarray:
        return self.facet_values[self.rough_facets]

    def periodic_shift(self, facet: int) -> np.ndarray:
        """Translation applied to a particle crossing periodic `facet`
        (reference classes/Population.py:1476-1477: centroid difference)."""
        pair = self._pair_of(facet)
        return (
            self.mesh.facet_centroids[pair] - self.mesh.facet_centroids[facet]
        )

    def _pair_of(self, facet: int) -> int:
        for a, b in self.connected_facets:
            if a == facet:
                return int(b)
            if b == facet:
                return int(a)
        raise ValueError(f"facet {facet} has no periodic pair")

    def find_path(self, points: np.ndarray) -> list[int]:
        """Snap a polyline of probe points to a path through the subvolume
        connection graph (reference snap_path, classes/Geometry.py:1085-1188):
        each point maps to its nearest subvolume centre; consecutive centres
        are joined by the shortest (euclidean-weighted) graph path."""
        import heapq

        centers = self.subvol_center
        n = len(centers)
        adj: dict[int, list[tuple[int, float]]] = {i: [] for i in range(n)}
        for a, b in self.subvol_connections:
            w = float(np.linalg.norm(centers[a] - centers[b]))
            adj[int(a)].append((int(b), w))
            adj[int(b)].append((int(a), w))

        def dijkstra(src: int, dst: int) -> list[int]:
            dist = {src: 0.0}
            prev: dict[int, int] = {}
            heap = [(0.0, src)]
            while heap:
                d, u = heapq.heappop(heap)
                if u == dst:
                    break
                if d > dist.get(u, np.inf):
                    continue
                for v, w in adj[u]:
                    nd = d + w
                    if nd < dist.get(v, np.inf):
                        dist[v] = nd
                        prev[v] = u
                        heapq.heappush(heap, (nd, v))
            if dst not in dist:
                raise ValueError(f"no path between subvolumes {src} and {dst}")
            path = [dst]
            while path[-1] != src:
                path.append(prev[path[-1]])
            return path[::-1]

        waypoints = [
            int(np.argmin(np.linalg.norm(centers - p, axis=1)))
            for p in np.atleast_2d(points)
        ]
        full = [waypoints[0]]
        for a, b in zip(waypoints[:-1], waypoints[1:]):
            full += dijkstra(a, b)[1:]
        return full

    def path_connections(self, path: list[int]) -> np.ndarray:
        """Connection indices along a subvolume path."""
        lut = {}
        for ci, (a, b) in enumerate(self.subvol_connections):
            lut[(int(a), int(b))] = ci
            lut[(int(b), int(a))] = ci
        return np.array(
            [lut[(path[i], path[i + 1])] for i in range(len(path) - 1)], dtype=int
        )


def _relative_to_absolute(points: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    return points * np.ptp(bounds, axis=0) + bounds[0]


def build_domain(
    geometry: str = "box",
    dimensions=(10e3, 1e3, 1e3),
    scale=(1, 1, 1),
    rotation=None,  # (angles, order)
    subvolumes=("slice", 10, 0),
    bound_pos=("relative",),
    bound_cond=("T", "T", "R", "R", "P"),
    bound_values=(302.0, 298.0, 0.0, 0.0),
    connect_pos=("relative",),
    rng: np.random.Generator | None = None,
    volume_algo: str = "mc",
) -> Domain:
    rng = rng or np.random.default_rng(0)
    if volume_algo not in ("mc", "qmc"):
        raise ValueError(f"invalid subvolume volume algorithm '{volume_algo}'")

    # ---- mesh ---------------------------------------------------------------
    if geometry.endswith(".stl"):
        from nanokappa_torch.geometry.stl import load_stl

        mesh = load_stl(geometry)
    else:
        mesh = make_primitive(geometry, dimensions)

    mesh.rezero()
    mesh.vertices = mesh.vertices * np.asarray(scale, dtype=float)
    if rotation is not None:
        from scipy.spatial.transform import Rotation as Rot

        angles, order = rotation
        mesh.vertices = Rot.from_euler(order, angles, degrees=True).apply(mesh.vertices)
    mesh.update()
    mesh.rezero()

    nf = mesh.n_facets

    # ---- boundary conditions ------------------------------------------------
    # (reference classes/Geometry.py:652-709: probe points pick facets; the
    # last condition in --bound_cond applies to every unspecified facet)
    kind = bound_pos[0]
    pts = np.asarray(bound_pos[1:], dtype=float).reshape(-1, 3)
    if kind == "relative":
        pts = _relative_to_absolute(pts, mesh.bounds)
    elif kind != "absolute":
        raise ValueError("bound_pos must start with 'relative' or 'absolute'")

    cond = np.full(nf, _BC_FROM_STR[bound_cond[-1]], dtype=int)
    values = np.full(nf, np.nan)
    if _BC_FROM_STR[bound_cond[-1]] in (BC.TEMPERATURE, BC.FLUX, BC.ROUGH):
        values[:] = bound_values[-1]

    picked = mesh.closest_facet(pts) if len(pts) else np.zeros(0, dtype=int)
    vi = 0
    for j, fct in enumerate(picked):
        cond[fct] = _BC_FROM_STR[bound_cond[j]]
        if cond[fct] != BC.PERIODIC:
            values[fct] = bound_values[vi]
            vi += 1

    # ---- periodic connections ----------------------------------------------
    # (reference classes/Geometry.py:711-766)
    connected = np.zeros((0, 2), dtype=int)
    if len(connect_pos) > 1:
        cpts = np.asarray(connect_pos[1:], dtype=float).reshape(-1, 3)
        if connect_pos[0] == "relative":
            cpts = _relative_to_absolute(cpts, mesh.bounds)
        connected = mesh.closest_facet(cpts).reshape(-1, 2)
        for a, b in connected:
            na, nb = mesh.facet_normals[a], mesh.facet_normals[b]
            if np.abs(na + nb).max() > 1e-6:
                raise ValueError(f"connected facets {a},{b}: normals not antiparallel")
            if not np.isclose(
                mesh.facet_areas[a], mesh.facet_areas[b], rtol=1e-6
            ):
                raise ValueError(f"connected facets {a},{b}: areas differ")
            # congruence: both facets must coincide after the centroid shift
            shift = mesh.facet_centroids[b] - mesh.facet_centroids[a]
            va = np.unique(
                np.round(mesh.tri[mesh.facets[a]].reshape(-1, 3) + shift, 5), axis=0
            )
            vb = np.unique(np.round(mesh.tri[mesh.facets[b]].reshape(-1, 3), 5), axis=0)
            if va.shape != vb.shape or not np.allclose(va, vb, atol=1e-4):
                raise ValueError(f"connected facets {a},{b}: shapes not congruent")
            cond[a] = BC.PERIODIC
            cond[b] = BC.PERIODIC

    # every periodic facet needs a pair
    per = np.nonzero(cond == BC.PERIODIC)[0]
    for f in per:
        if f not in connected:
            raise ValueError(f"periodic facet {f} has no connection (--connect_pos)")

    # ---- subvolumes ----------------------------------------------------------
    sv_type = str(subvolumes[0])
    grid = None
    if sv_type == "grid":
        grid = np.asarray(subvolumes[1:4], dtype=int)
        if (grid == 1).sum() == 2:  # degenerate grid -> slice (Geometry.py:497-506)
            sv_type = "slice"
            axis = int(np.nonzero(grid != 1)[0][0])
            subvolumes = ("slice", int(grid[axis]), axis)
            grid = None

    if sv_type == "slice":
        n_sv = int(subvolumes[1])
        axis = int(subvolumes[2])
        centers = np.tile(mesh.bounds.mean(axis=0), (n_sv, 1))
        arr = (np.arange(n_sv) + 0.5) / n_sv
        centers[:, axis] = arr * np.ptp(mesh.bounds[:, axis]) + mesh.bounds[0, axis]
        sv_connections = np.stack(
            [np.arange(n_sv - 1), np.arange(1, n_sv)], axis=1
        )
        if geometry in ("box", "cuboid"):
            volumes = np.full(n_sv, mesh.volume / n_sv)
        else:
            volumes = _mc_subvol_volume(mesh, centers, rng, algorithm=volume_algo)
    elif sv_type in ("grid", "voronoi"):
        from nanokappa_torch.geometry.subvolumes import grid_centers, lloyd_centers

        axis = 0
        if sv_type == "grid":
            centers = grid_centers(mesh, grid)
        else:
            centers = lloyd_centers(mesh, int(subvolumes[1]), rng)
        # the centres in (x, y, z) order BEFORE their volumes and connections
        # are taken: the JAX package sorts them after, so its volumes and
        # connections index the unsorted centres (ROADMAP queue 3)
        centers = centers[np.lexsort((centers[:, 2], centers[:, 1], centers[:, 0]))]
        volumes = _mc_subvol_volume(mesh, centers, rng, algorithm=volume_algo)
        sv_connections = _nearest_connections(centers, mesh)
    else:
        raise ValueError(f"invalid subvolume type '{sv_type}'")

    return Domain(
        mesh=mesh,
        bound_cond=cond,
        facet_values=values,
        connected_facets=connected,
        subvol_type=sv_type,
        slice_axis=axis,
        subvol_center=centers,
        subvol_volume=volumes,
        subvol_connections=sv_connections,
        grid=grid,
    )


def _mc_subvol_volume(
    mesh: TriMesh,
    centers: np.ndarray,
    rng,
    tol: float = 1e-3,
    algorithm: str = "mc",
) -> np.ndarray:
    """Subvolume volumes via nearest-centre binning of interior samples
    (reference calculate_subvol_volume, classes/Geometry.py:546-650).

    'mc' draws pseudo-random interior points; 'qmc' draws a scrambled Sobol
    sequence over the bounding box and keeps the contained points (the
    reference's qmc branch, Geometry.py:554-599) — lower-discrepancy cover
    estimates at equal sample count."""
    n_sv = centers.shape[0]
    counts = np.zeros(n_sv)
    total = 0
    err = np.ones(n_sv)
    cover = np.zeros(n_sv)
    sobol = None
    if algorithm == "qmc":
        from scipy.stats import qmc as _qmc

        sobol = _qmc.Sobol(3, scramble=True, seed=rng)
    drawn = 0  # ALL candidates count toward the sample bound: a mesh whose
    #   interior the Sobol box-samples never hit must still terminate
    while err.max() > tol and drawn < 2**22:
        if sobol is not None:
            cand = sobol.random(4096) * np.ptp(mesh.bounds, axis=0) + mesh.bounds[0]
            drawn += len(cand)
            s = cand[mesh.contains(cand)]
            if len(s) == 0:
                continue
        else:
            s = mesh.sample_volume(4096, rng)
            drawn += len(s)
        d = np.linalg.norm(s[:, None, :] - centers[None], axis=-1)
        r = np.argmin(d, axis=1)
        counts += np.bincount(r, minlength=n_sv)
        total += len(s)
        new_cover = counts / total
        with np.errstate(divide="ignore", invalid="ignore"):
            err = np.abs((new_cover - cover) / np.where(cover == 0, 1, cover))
            err[new_cover == 0] = 0
        cover = new_cover
    if total == 0:  # nothing landed inside: fall back to an equal split
        return np.full(n_sv, mesh.volume / n_sv)
    return cover * mesh.volume


def _nearest_connections(centers: np.ndarray, mesh: TriMesh | None = None) -> np.ndarray:
    """Connect each centre to its natural neighbours (midpoint closest to both
    ends), pruning connections whose midpoints fall outside the solid —
    the reference's midpoint-containment + occlusion pruning
    (classes/Geometry.py:961-1052)."""
    n = centers.shape[0]
    # natural-neighbour test for ALL pairs at once, chunked so a 500-centre
    # voronoi domain builds in seconds (the round-2 Python double loop was
    # O(SV^2) interpreted)
    iu, ju = np.triu_indices(n, k=1)
    keep = np.zeros(len(iu), dtype=bool)
    chunk = 8192
    for s in range(0, len(iu), chunk):
        ii, jj = iu[s : s + chunk], ju[s : s + chunk]
        mid = (centers[ii] + centers[jj]) / 2  # (c,3)
        d = np.linalg.norm(centers[None, :, :] - mid[:, None, :], axis=-1)
        dij = np.linalg.norm(centers[ii] - mid, axis=-1)
        keep[s : s + chunk] = np.all(d >= dij[:, None] - 1e-9, axis=1)
    pairs = np.stack([iu[keep], ju[keep]], axis=1).astype(int)
    if mesh is not None and len(pairs):
        # occlusion: probe points along each connection; all must lie inside
        # the solid (a connection across a hole is not a transport path).
        # 7 evenly spaced probes (vs 3 in round 2) so thin holes the
        # reference's pruning (classes/Geometry.py:961-1052) catches are not
        # stepped over; one vectorised contains() call for every probe.
        ts = (np.arange(1, 8) / 8.0)[None, :, None]  # (1,7,1)
        probe = (
            centers[pairs[:, 0]][:, None, :] * (1 - ts)
            + centers[pairs[:, 1]][:, None, :] * ts
        ).reshape(-1, 3)
        inside = mesh.contains(probe).reshape(len(pairs), -1)
        pairs = pairs[np.all(inside, axis=1)]
    return pairs
