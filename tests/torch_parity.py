"""Shared builders for the port's parity tests (tests/test_torch_*.py): one
configuration built by both packages — the JAX reference (`nanokappa_tpu`)
and the PyTorch port (`nanokappa_torch`, on the CPU) — from the same host
inputs, small enough for the CPU (a 4^3 or 6^3 synthetic material, a
4096-lane pool)."""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import torch


def thread_budget(workers, cores: int):
    """Torch threads for each test process: the cores shared out over
    pytest-xdist's workers (`workers` is PYTEST_XDIST_WORKER_COUNT), at
    least one; None without xdist, where a process has the cores to
    itself."""
    if not workers:
        return None
    return max(1, cores // int(workers))


# The one owner of the test workers' torch threads. Every xdist worker
# collects every test file, so it imports this module before any test runs;
# left alone, each worker's torch takes a thread a core of the cores that
# the other workers share. Only torch is set, so the JAX package's tests
# keep their defaults. A rank spawned with a function of
# tests/torch_shard_ranks.py imports this module too and takes the budget;
# other processes a test starts keep their defaults (a rank of the CLI on
# the CPU takes its share of the cores, parallel/launch.py:_rank_main).
BUDGET = thread_budget(os.environ.get("PYTEST_XDIST_WORKER_COUNT"), os.cpu_count() or 1)
if BUDGET is not None:
    torch.set_num_threads(BUDGET)
    torch.set_num_interop_threads(BUDGET)

# the Si thin film: T/T reservoirs along x, eta = 0 (specular) z walls, one
# periodic y pair (BASELINE config 1, bench.py:build_ctx), shortened
FILM = dict(
    geometry="box",
    dimensions=(2e3, 1e3, 1e3),
    subvolumes=("slice", 5, 0),
    bound_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5,
               0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
    bound_cond=("T", "T", "R", "R", "P"),
    bound_values=(302.0, 298.0, 0.0, 0.0),
    connect_pos=("relative", 0.5, -0.1, 0.5, 0.5, 1.1, 0.5),
)
# the film at its full 5000 x 1000 x 1000 A and 10 slices
FILM_FULL = dict(FILM, dimensions=(5e3, 1e3, 1e3), subvolumes=("slice", 10, 0))
# no reservoirs: periodic x and z, specular y walls (P/R/R/P)
CLOSED_FILM = dict(
    geometry="box",
    dimensions=(2e3, 1e3, 1e3),
    subvolumes=("slice", 5, 0),
    bound_pos=("relative", 0.5, -0.1, 0.5, 0.5, 1.1, 0.5),
    bound_cond=("R", "R"),
    bound_values=(0.0, 0.0),
    connect_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5,
                 0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
)
# the nanowire (bench.py:build_wire_ctx): an 8-sided cylinder 4000 A long and
# 500 A across (32 triangles, 10 facets), T caps at 305 / 295 K, rough
# eta = 2 A side walls, 5 axial slices
WIRE = dict(
    geometry="cylinder",
    dimensions=(4e3, 500.0, 8),
    subvolumes=("slice", 5, 2),
    bound_pos=("relative", 0.5, 0.5, -0.1, 0.5, 0.5, 1.1, 1.1, 0.5, 0.5),
    bound_cond=("T", "T", "R", "R"),
    bound_values=(305.0, 295.0, 2.0, 2.0),
    connect_pos=("relative",),
)


def perforated_plate(L=3e3, W=3e3, H=1e3, a=600.0):
    """The perforated plate of tests/test_porous.py (BASELINE config 4): an
    L x W x H box with a square hole of side 2a through z at its centre, 32
    triangles, as the port's TriMesh."""
    from nanokappa_torch.geometry.mesh import TriMesh

    cx, cy = L / 2, W / 2
    O = [(0, 0), (L, 0), (L, W), (0, W)]
    I = [(cx - a, cy - a), (cx + a, cy - a), (cx + a, cy + a), (cx - a, cy + a)]
    v = []
    for z in (0.0, H):
        v += [(x, y, z) for x, y in O]
    for z in (0.0, H):
        v += [(x, y, z) for x, y in I]
    v = np.array(v, dtype=float)
    OB, OT, IB, IT = 0, 4, 8, 12
    faces = []
    for k in range(4):
        k2 = (k + 1) % 4
        faces += [[OB + k, IB + k, OB + k2], [OB + k2, IB + k, IB + k2]]
        faces += [[OT + k, OT + k2, IT + k], [OT + k2, IT + k2, IT + k]]
        faces += [[OB + k, OB + k2, OT + k], [OB + k2, OT + k2, OT + k]]
        faces += [[IB + k, IT + k, IB + k2], [IB + k2, IT + k, IT + k2]]
    return TriMesh(v, np.array(faces))


# BASELINE config 3, the nanowire of tests/test_nanowire.py:22 wire_kappa: a
# 12-sided cylinder 4000 A long and 500 A across (48 triangles, 14 facets),
# T caps at 305 / 295 K, rough side walls at `eta`, 5 axial slices. Its
# side normals lie at 15 + 30 k degrees: under the velocity model the 45
# and 135 degree walls (4 of its 12 table rows) have specular partners on
# the cubic grid, the other 8 none
def wire12(eta: float) -> dict:
    return dict(
        geometry="cylinder",
        dimensions=(4e3, 500.0, 12),
        subvolumes=("slice", 5, 2),
        bound_pos=("relative", 0.5, 0.5, -0.1, 0.5, 0.5, 1.1, 1.1, 0.5, 0.5),
        bound_cond=("T", "T", "R", "R"),
        bound_values=(305.0, 295.0, float(eta), float(eta)),
        connect_pos=("relative",),
    )


def membrane_box(L=2e3, W=1e3, H=1e3, doubled=False):
    """The box of tests/test_interfaces.py:22 as the port's TriMesh: L x W x
    H with an internal wall at x = L/2 across the whole cross section (22
    triangles, 7 facets); `doubled` emits the wall as two coincident sheets
    of opposite winding (24 triangles), as a two-solid STL export does."""
    from nanokappa_torch.geometry.mesh import TriMesh
    xs = (0.0, L / 2, L)
    v = np.array([(x, y, z) for x in xs for y in (0.0, W) for z in (0.0, H)], dtype=float)

    def vid(i, j, k):
        return i * 4 + j * 2 + k

    faces = []

    def quad(a, b, c, d):
        faces.append([a, b, c])
        faces.append([a, c, d])

    quad(vid(0, 0, 0), vid(0, 0, 1), vid(0, 1, 1), vid(0, 1, 0))  # x = 0
    quad(vid(2, 0, 0), vid(2, 1, 0), vid(2, 1, 1), vid(2, 0, 1))  # x = L
    for i in range(2):  # two cells along x
        quad(vid(i, 0, 0), vid(i + 1, 0, 0), vid(i + 1, 0, 1), vid(i, 0, 1))
        quad(vid(i, 1, 0), vid(i, 1, 1), vid(i + 1, 1, 1), vid(i + 1, 1, 0))
        quad(vid(i, 0, 0), vid(i, 1, 0), vid(i + 1, 1, 0), vid(i + 1, 0, 0))
        quad(vid(i, 0, 1), vid(i + 1, 0, 1), vid(i + 1, 1, 1), vid(i, 1, 1))
    quad(vid(1, 0, 0), vid(1, 0, 1), vid(1, 1, 1), vid(1, 1, 0))  # the membrane
    if doubled:
        quad(vid(1, 0, 0), vid(1, 1, 0), vid(1, 1, 1), vid(1, 0, 1))
    return TriMesh(v, np.array(faces))


# the membrane box's domains (tests/test_interfaces.py), for an STL at
# `path`: "transport" (:80) T reservoirs at 305 / 295 K on the x faces, the
# membrane rough at eta = 2 A (picked by its interior probe point), the
# other walls eta = 0, 4 slices; "tables" (:135) the membrane at eta = 2 A,
# the rest eta = 0, 2 slices; "tight" (:176) every facet rough at eta = 10 A
# (diffuse), no reservoirs, 2 slices (one each side of the membrane)
def membrane_kw(path: str, kind: str) -> dict:
    if kind == "transport":
        return dict(
            geometry=path, subvolumes=("slice", 4, 0),
            bound_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5, 0.5, 0.5, 0.5),
            bound_cond=("T", "T", "R", "R"), bound_values=(305.0, 295.0, 2.0, 0.0),
            connect_pos=("relative",),
        )
    if kind == "tables":
        return dict(
            geometry=path, subvolumes=("slice", 2, 0), bound_pos=("relative", 0.5, 0.5, 0.5),
            bound_cond=("R", "R"), bound_values=(2.0, 0.0), connect_pos=("relative",),
        )
    assert kind == "tight"
    return dict(
        geometry=path, subvolumes=("slice", 2, 0), bound_pos=("relative",),
        bound_cond=("R",), bound_values=(10.0,), connect_pos=("relative",),
    )


def membrane_lanes(td, tabs, per_side, seed):
    """Fresh lanes just off the membrane on both sides, at random points of
    its face away from its edges, each flying at it with its own mode's
    velocity, the modes drawn by incident flux (front: v.n > 0 from the
    region behind the normal; back: v.n < 0), `per_side` a side. Returns
    (the (16, N) plain pool, side: +1 front / -1 back, the membrane facet,
    the modes)."""
    from nanokappa_torch.sim.state import C_ALIVE, C_CF, C_MODE, C_OMEGA, C_ONF, C_REM, C_TAU, STALE

    mem = int(td.mesh.interfacets[0])
    n = td.mesh.facet_normals[mem]
    x0 = float(td.mesh.facet_centroids[mem][0])
    ov = np_(tabs.omega_vel).astype(np.float64)
    rng = np.random.default_rng(seed)
    side = np.repeat([1.0, -1.0], per_side)
    modes = np.zeros(2 * per_side, np.int64)
    for s in (1.0, -1.0):
        flux = np.maximum(s * (ov[:, 1:4] @ n), 0.0)
        modes[side == s] = rng.choice(len(flux), per_side, p=flux / flux.sum())
    N = 2 * per_side
    pool = np.zeros((16, N), np.float32)
    pool[0] = x0 - side * n[0] * 1e-3
    pool[1] = rng.uniform(150.0, 850.0, N)
    pool[2] = rng.uniform(150.0, 850.0, N)
    pool[3:6] = ov[modes, 1:4].T
    pool[C_OMEGA] = ov[modes, 0]
    pool[C_TAU] = 1.0
    pool[C_MODE] = modes.astype(np.int32).view(np.float32)
    pool[C_CF] = np.full(N, STALE, np.int32).view(np.float32)
    pool[C_ONF] = np.full(N, -1, np.int32).view(np.float32)
    pool[C_REM] = 1.0
    pool[C_ALIVE] = 1.0
    return torch.as_tensor(pool), side, mem, modes


def wire_kappa(mat, dom, n_steps: int = 400):
    """tests/test_nanowire.py:22 wire_kappa on the port (on the CPU): the
    12-sided wire `dom` (the port's domain of wire12(eta)) from the JAX
    function's initial state (its pool
    n_cap = 1.8 N is not a whole number of tiles, so both packages take
    their v1 step), kappa_slice of every 10-step block from the first 60%
    on. Returns (their mean, its standard error, the last outputs)."""
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.kappa import kappa_slice
    from nanokappa_torch.sim.reservoir import build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count
    from nanokappa_torch.sim.step import build_step

    n_p, rho = particle_count(("total", 8000), mat, dom)
    params = SimParams(dt=1.0, n_cap=int(n_p * 1.8), inj_cap=8192, particle_density=rho,
                       n_active_modes=mat.n_active_modes, t_reference=300.0)
    geo = build_device_geometry(dom, device="cpu")
    btab = build_boundary_tables(mat, dom, device="cpu")
    rtab = build_reservoir_tables(mat, dom, params.dt, rho, device="cpu")
    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=5)
    run = build_step(geo, mat.device_tables("cpu"), btab, rtab, params, n_inner=10)
    ks = []
    for i in range(n_steps // 10):
        state, out = run(state)
        if i >= (n_steps // 10) * 3 // 5:
            ks.append(kappa_slice(np_(out.T_sv), np_(out.phi_sv), np_(out.Np_sv),
                                  np.array([305.0, 295.0]), 4e3, 2)[1])
    return float(np.mean(ks)), float(np.std(ks, ddof=1) / np.sqrt(len(ks))), out


# examples/voronoi_star.txt's domain: a 6-point star prism 5000 A long
# (outer radius 800 A, inner 400 A; 48 triangles, 14 facets), T caps at
# 305 / 295 K, rough eta = 2 A side walls, 12 Voronoi cells
STAR = dict(
    geometry="star",
    dimensions=(5e3, 800.0, 400.0, 6),
    subvolumes=("voronoi", 12),
    bound_pos=("relative", 0.5, 0.5, -0.1, 0.5, 0.5, 1.1, 1.1, 0.5, 0.5),
    bound_cond=("T", "T", "R", "R"),
    bound_values=(305.0, 295.0, 2.0, 2.0),
    connect_pos=("relative",),
)
# examples/corrugated_wire.txt's domain: 2 conical sections 1000 A long
# (radius 300 -> 200 -> 300 A, 20 sides; 120 triangles, 42 facets), T caps
# at 305 / 295 K, rough eta = 5 A side walls: 40 wall-table rows, past one
# 32-bit partner-mask word
CORRUGATED = dict(
    geometry="corrugated",
    dimensions=(1000.0, 300.0, 200.0, 20, 2),
    subvolumes=("slice", 5, 2),
    bound_pos=("relative", 0.5, 0.5, -0.1, 0.5, 0.5, 1.1, 1.1, 0.5, 0.5),
    bound_cond=("T", "T", "R", "R"),
    bound_values=(305.0, 295.0, 5.0, 5.0),
    connect_pos=("relative",),
)
# the star's 12 Lloyd centres (seed 0), rounded: its Lloyd iteration costs
# ~100 s of CPU
STAR_CENTERS = np.array([
    [519.9, 693.9, 2013.8], [630.2, 469.9, 1139.5], [648.7, 460.1, 3015.4],
    [651.8, 906.8, 374.7], [675.2, 935.8, 4562.7], [772.2, 611.7, 3875.6],
    [912.3, 948.5, 1149.2], [912.7, 928.0, 3333.4], [936.8, 801.7, 2538.3],
    [939.3, 473.9, 4611.0], [959.1, 476.6, 398.3], [1057.1, 621.9, 1807.3],
])


def plate_kw(path: str) -> dict:
    """The plate's domain: Voronoi 8, T reservoirs at 304 / 296 K on the two
    x faces, every other facet rough at eta = 5 A (the hole's walls too)."""
    return dict(
        geometry=path, subvolumes=("voronoi", 8),
        bound_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5),
        bound_cond=("T", "T", "R"), bound_values=(304.0, 296.0, 5.0),
        connect_pos=("relative",),
    )


# the Lloyd centres of the plate's 8 Voronoi cells (seed 0), rounded: the
# Lloyd iteration costs ~50 s of CPU, so parity tests patch it with these
PLATE_CENTERS = np.array([
    [424.2, 1482.6, 489.9], [485.9, 489.8, 501.3], [512.8, 2509.4, 476.7],
    [1514.7, 438.1, 477.3], [1537.3, 2572.6, 484.8], [2492.8, 513.7, 523.4],
    [2523.2, 2485.2, 513.9], [2584.1, 1510.1, 499.2],
])


def patch_lloyd(monkeypatch, centers=PLATE_CENTERS, equal_volumes=False):
    """Both packages' Voronoi splits take `centers` (no Lloyd run); with
    `equal_volumes` each cell takes an equal share of the mesh's volume (no
    Monte Carlo volume estimate)."""
    from nanokappa_torch.geometry import domain as t_dom, subvolumes as t_sub

    def vols(mesh, c, rng=None, **k):
        return np.full(len(c), mesh.volume / len(c))

    mods = [(t_sub, t_dom)]
    try:
        from nanokappa_tpu.geometry import domain as j_dom, subvolumes as j_sub

        mods.append((j_sub, j_dom))
    except ImportError:
        pass
    for sub, dom in mods:
        monkeypatch.setattr(sub, "lloyd_centers", lambda mesh, n, rng=None, **k: centers[:n].copy())
        if equal_volumes:
            monkeypatch.setattr(dom, "_mc_subvol_volume", vols)


def jax_fields(obj) -> dict:
    """A JAX dataclass as the dict of NumPy arrays convert.py takes."""
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def np_(x):
    """NumPy view of a torch tensor, JAX array or NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(a, b, path="obj"):
    """Bit-equal arrays (same dtype, NaNs at the same places), recursively
    through lists, tuples, dicts and plain objects."""
    if isinstance(a, (torch.Tensor, np.ndarray)) or hasattr(a, "__array__") and not isinstance(a, (int, float, str)):
        x, y = np_(a), np_(b)
        assert x.dtype == y.dtype, (path, x.dtype, y.dtype)
        assert x.shape == y.shape, (path, x.shape, y.shape)
        if x.dtype.kind in "fc":
            x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
            assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), path
        else:
            assert np.array_equal(x, y), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            assert_same(u, v, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        assert_same(vars(a), vars(b), path)
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def build_pair(
    domain_kw=FILM, mesh=(4, 4, 4), n_p=3000, n_cap=4096, inj_cap=512,
    seed=3, temp_dist="linear", subvol_temp=(), step_impl="v2",
    res_gen="pooled", scat_model="velocity",
):
    """The same configuration in both packages (host arrays bit-equal by
    construction; the JAX init_state and the port's draw the same NumPy
    numbers). The 'constant' and 'fixed_rate' schemes get the autosized
    lattice depth."""
    from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
    from nanokappa_tpu.geometry.domain import build_domain as j_dom
    from nanokappa_tpu.material import synthetic_material as j_mat
    from nanokappa_tpu.sim.boundary_tables import build_boundary_tables as j_bt
    from nanokappa_tpu.sim.reservoir import build_reservoir_tables as j_rt
    from nanokappa_tpu.sim.state import SimParams as JParams, init_state as j_init
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.reservoir import build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count

    j = SimpleNamespace()
    t = SimpleNamespace()
    from nanokappa_torch.sim.reservoir import autosize_c_max

    j.mat, t.mat = j_mat(mesh=mesh), synthetic_material(mesh=mesh)
    j.dom, t.dom = j_dom(**domain_kw), build_domain(**domain_kw)
    n_p, rho = particle_count(("total", n_p), t.mat, t.dom)
    j.rtab = j_rt(j.mat, j.dom, 1.0, rho)
    t.rtab = build_reservoir_tables(t.mat, t.dom, 1.0, rho, device="cpu")
    common = dict(
        dt=1.0, n_cap=n_cap, inj_cap=inj_cap, temp_interp="nearest",
        res_gen=res_gen, particle_density=rho,
        n_active_modes=t.mat.n_active_modes, t_reference=300.0,
        c_max=autosize_c_max(t.rtab) if res_gen in ("constant", "fixed_rate") else 3,
        scat_model=scat_model,
    )
    j.params = JParams(step_impl=step_impl, **common)
    t.params = SimParams(**common)
    j.geo, t.geo = j_geo(j.dom), build_device_geometry(t.dom, device="cpu")
    j.btab = j_bt(j.mat, j.dom, scat_model)
    t.btab = build_boundary_tables(t.mat, t.dom, scat_model, device="cpu")
    j.tabs, t.tabs = j.mat.device_tables(), t.mat.device_tables("cpu")
    init = dict(temp_dist=temp_dist, subvol_temp=subvol_temp, seed=seed)
    j.state = j_init(j.mat, j.dom, j.geo, j.params, n_p, btab=j.btab, **init)
    t.state = init_state(t.mat, t.dom, t.geo, t.params, n_p, t.btab, **init)
    j.n_p = t.n_p = n_p
    return j, t


def hazard_pool(rng, C, N, p_alive=0.6):
    """A pool whose int rows hold small ids (float32 denormals), STALE = -2
    (a NaN payload) and -1: values that any float arithmetic would corrupt."""
    pool = rng.normal(size=(C, N)).astype(np.float32)
    bits = pool.view(np.int32)
    bits[9] = rng.integers(0, 300, N)
    bits[10] = rng.integers(-2, 6, N)
    bits[12] = rng.integers(-1, 6, N)
    bits[15] = rng.integers(0, 5, N)
    if C > 16:
        bits[16] = rng.integers(-1, 300, N)
    pool[14] = (rng.random(N) < p_alive).astype(np.float32)
    return pool


def assert_bits(a, b, msg=""):
    a, b = np.ascontiguousarray(np_(a)), np.ascontiguousarray(np_(b))
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=msg)


def craft_kmirror(btab_k, btab_v):
    """The k model's tables (degenerate partners, diffuse weights) with the
    velocity model's specular correspondence: on the eta = 0 film walls that
    is the exact crystal mirror, a full-coverage involution, so the k model
    runs on the mirror path at a small grid (whose own k map covers too few
    wall-incident modes for the gate, tests/test_kmodel_mirror.py). Works on
    either package's BoundaryTables."""
    crafted = dataclasses.replace(
        btab_k, specularity=btab_v.specularity, corr=btab_v.corr, spec2=btab_v.spec2,
    )
    object.__setattr__(crafted, "_host", {
        **btab_k._host, "specularity": btab_v._host["specularity"], "corr": btab_v._host["corr"],
    })
    return crafted


def split_velocity(mat):
    """A copy of a Material (either package's) whose degenerate partner
    branches differ in velocity: the second branch of each equal-frequency
    pair (`mat.degeneracies`' j2) moves at 0.6 times its group velocity,
    its direction kept, its frequency (so the pairs) unchanged. On the
    synthetic tables partners share omega and velocity, so the k model's
    degenerate split changes no trajectory there; on this one a swap
    changes the lane's speed."""
    gv = mat.group_vel.copy()
    for q, _, j2 in mat.degeneracies:
        gv[q, j2] *= 0.6
    return dataclasses.replace(mat, group_vel=gv)


def kmirror_pair(domain_kw=FILM, mesh=(6, 6, 6), temp_dist="linear", subvol_temp=(), seed=3, **kw):
    """build_pair under the k model on craft_kmirror's tables, the initial
    states drawn again on them (the mirror cache, the split included)."""
    from nanokappa_tpu.sim.boundary_tables import build_boundary_tables as j_bt
    from nanokappa_tpu.sim.state import init_state as j_init
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.state import init_state

    j, t = build_pair(domain_kw, mesh=mesh, temp_dist=temp_dist, subvol_temp=subvol_temp, seed=seed, **kw)
    j.btab = craft_kmirror(j_bt(j.mat, j.dom, "k"), j.btab)
    t.btab = craft_kmirror(build_boundary_tables(t.mat, t.dom, "k", device="cpu"), t.btab)
    j.params = dataclasses.replace(j.params, scat_model="k")
    t.params = dataclasses.replace(t.params, scat_model="k")
    init = dict(temp_dist=temp_dist, subvol_temp=subvol_temp, seed=seed)
    j.state = j_init(j.mat, j.dom, j.geo, j.params, j.n_p, btab=j.btab, **init)
    t.state = init_state(t.mat, t.dom, t.geo, t.params, t.n_p, t.btab, **init)
    return j, t


def split_share(state, btab, mat_tables) -> tuple[int, int]:
    """(lanes whose cached partner was drawn from a degenerate pair, those
    that took the partner branch) over the alive lanes of a full-layout
    pool: the cache holds either the mirror mode or its partner branch."""
    from nanokappa_torch.sim.boundary_tables import combined_mirror_rows

    pool = np_(state.pool)
    alive = pool[14] > 0.5
    mode = pool[9].view(np.int32)[alive]
    xmode = pool[16].view(np.int32)[alive]
    corr = combined_mirror_rows(btab, mat_tables)[:, 1].view(np.int32)[mode]
    dp = np_(btab.degen_partner)
    partnered = (corr >= 0) & (dp[np.clip(corr, 0, None)] >= 0)
    took = partnered & (xmode == dp[np.clip(corr, 0, None)])
    return int(partnered.sum()), int(took.sum())


# the four shapes of tests/test_scatter_rows.py (N, E, valid updates)
SCATTER_CASES = [(40_000, 4096, 2000), (16_384, 1024, 1024), (20_000, 512, 0), (50_000, 2048, 2048)]


def scatter_case(n, e, nval, C=16, seed=0):
    """A (C, n) bit-hazard pool, (C, e) rows and the case's ascending unique
    indices (the dense case clustered at 20,000), sentinel n beyond nval."""
    rng = np.random.default_rng(seed + n)
    pool = rng.normal(size=(C, n)).astype(np.float32)
    pool.view(np.int32)[[9, 10, 12, 15]] = rng.integers(-2, 300, (4, n))
    rows = rng.normal(size=(C, e)).astype(np.float32)
    rows.view(np.int32)[[9, 10, 12, 15]] = rng.integers(-2, 300, (4, e))
    idx = np.full(e, n, np.int32)
    if nval == 2048 and n == 50_000:
        idx[:nval] = 20_000 + np.arange(nval)
    elif nval:
        idx[:nval] = np.sort(rng.choice(n, nval, replace=False))
    return pool, rows, idx


def compact_cases() -> dict:
    """Kernel C's masks and caps: the main paths' four widths (the film's
    survivors, the wire's constant lattice, the identity at inj_cap, the
    star's v1 events, each at its typical True share) and the edges."""
    rng = np.random.default_rng(8)
    return {
        "film survivors 2048->512": (rng.random(2048) < 0.3, 512),
        "wire lattice 1072476->5120": (rng.random(1_072_476) < 0.0036, 5120),
        "inj_cap 5120->5120": (np.arange(5120) < 3917, 5120),
        "star v1 1277952->79872": (rng.random(1_277_952) < 48_176 / 1_277_952, 79_872),
        "n=1": (np.ones(1, bool), 4),
        "n=4096": (rng.random(4096) < 0.5, 4096),
        "n=4097": (rng.random(4097) < 0.5, 1024),
        "all True": (np.ones(40_000, bool), 50_000),
        "all False": (np.zeros(40_000, bool), 512),
        "count > cap": (rng.random(300_000) < 0.2, 9_000),
    }


def film_params_file(folder, mat_folder: str, hdf: str, steps: int = 200, n_p: int = 3000) -> str:
    """A small film parameter file for both CLIs and drivers: the
    BASELINE film's walls and reservoirs on a 2000 x 1000 x 1000 A box in 5
    slices, 'pooled' reservoirs, nearest temperatures, a convergence
    window of the last 10 datapoints (100 steps)."""
    import os

    text = f"""--mat_folder {mat_folder}
--hdf_file {hdf}
--poscar_file POSCAR
--geometry box
--dimensions 2e3 1e3 1e3
--subvolumes slice 5 0
--bound_pos relative -0.1 0.5 0.5 1.1 0.5 0.5 0.5 0.5 -0.1 0.5 0.5 1.1
--bound_cond T T R R P
--connect_pos relative 0.5 -0.1 0.5 0.5 1.1 0.5
--bound_values 302 298 0 0
--temp_dist linear
--temp_interp nearest
--reservoir_gen pooled
--particles total {n_p}
--timestep 1
--iterations {steps}
--n_mean 10
--conv_crit 0 10
--output screen
"""
    path = os.path.join(str(folder), "film.txt")
    with open(path, "w") as f:
        f.write(text)
    return path


def run_driver(pkg: str, params_file: str, folder: str, seed: int) -> dict:
    """One driver run ('jax': nanokappa_tpu.driver.Simulation; 'torch':
    nanokappa_torch.driver.Simulation on the CPU) of a parameter file.
    Returns the convergence window's means and standard errors (10
    datapoints): T (SV,), kappa (total), eb (R,) the reservoirs' energy
    balance, and the bulk RTA kappa of the run's material."""
    import importlib

    cfg = importlib.import_module(f"nanokappa_{'tpu' if pkg == 'jax' else 'torch'}.io.config")
    drv = importlib.import_module(f"nanokappa_{'tpu' if pkg == 'jax' else 'torch'}.driver")
    argv = ["-ff", params_file]
    args = cfg.read_args(argv)
    args.seed = [seed]
    if pkg == "torch":
        args.device = ["cpu"]
    args.results_folder = folder
    sim = drv.Simulation(args)
    sim.run(verbose=False)
    W = list(sim.window)
    n = len(W)

    def stat(key):
        a = np.array([np.asarray(w[key], dtype=float) for w in W])
        return a.mean(0), a.std(0, ddof=1) / np.sqrt(n)

    out = {k: stat(src) for k, src in (("T", "T"), ("kappa", "kappa_total"), ("eb", "eb"))}
    out["bulk"] = float(sim.material.bulk_kappa_rta(300.0)[0])
    out["lost"] = int(W[-1]["lost"])
    return out


def assert_drivers_agree(runs_j: list, runs_t: list, T_hot=302.0, T_cold=298.0):
    """The film through both drivers within Monte Carlo noise: each run's
    profile between the reservoirs and falling, kappa below bulk and above
    a quarter of it (tests/test_sim_box.py:89), nothing lost; then each
    package's mean over its runs of T_sv, kappa and the reservoir energy
    balance agree within 5 standard errors (the windows' own errors and
    the runs' spread, combined)."""
    for r in runs_j + runs_t:
        T = r["T"][0]
        assert np.all((T > T_cold) & (T < T_hot)) and T[0] > T[-1], T
        assert 0.25 * r["bulk"] < r["kappa"][0] < r["bulk"], (r["kappa"], r["bulk"])
        assert r["lost"] == 0

    def pooled(runs, key):
        m = np.array([r[key][0] for r in runs])
        se = np.array([r[key][1] for r in runs])
        mean = m.mean(0)
        err2 = (se ** 2).sum(0) / len(runs) ** 2
        if len(runs) > 1:
            err2 = np.maximum(err2, m.var(0, ddof=1) / len(runs))
        return mean, err2

    for key in ("T", "kappa", "eb"):
        mj, ej = pooled(runs_j, key)
        mt, et = pooled(runs_t, key)
        assert np.all(np.abs(mj - mt) <= 5.0 * np.sqrt(ej + et)), (key, mj, mt, np.sqrt(ej + et))


def aim_at_rough_facets(pool, dom, geo, btab, per_facet: int = 48, seed: int = 1,
                        back: bool = False, facets=None):
    """Overwrite the first lanes of a plain pool with fresh lanes 2 A
    inside each rough facet (or only `facets`), flying straight at it (20
    A/ps along its outward normal), `per_facet` a facet, with random modes;
    with `back`, 2 A beyond the facet flying against its normal, i.e. at
    its back side (an internal membrane's other region). Returns (N lanes,
    their modes, the table rows their hits read — the back rows with
    `back` — and has: the mode has a specular partner at that row)."""
    from nanokappa_torch.geometry.domain import BC
    from nanokappa_torch.sim.fused import dkern_facet_tables
    from nanokappa_torch.sim.state import (
        C_ALIVE, C_CF, C_MODE, C_ONF, C_REM, C_TCOLL, STALE, as_f32,
    )

    bc = np_(geo.facet_bc)
    rough = np.nonzero(bc == int(BC.ROUGH))[0] if facets is None else np.asarray(facets)
    ft = dkern_facet_tables(geo, btab)
    row_of = ft["facet_row_back" if back else "facet_row"]
    corr = btab._host["corr"]
    lanes_f = np.repeat(rough, per_facet)
    N = len(lanes_f)
    rng = np.random.default_rng(seed)
    modes = rng.integers(0, corr.shape[1], N).astype(np.int32)
    normals = dom.mesh.facet_normals[lanes_f] * (-1.0 if back else 1.0)
    dev = pool.device
    pool[0:3, :N] = torch.as_tensor((dom.mesh.facet_centroids[lanes_f] - 2.0 * normals).T,
                                    dtype=torch.float32, device=dev)
    pool[3:6, :N] = torch.as_tensor((20.0 * normals).T, dtype=torch.float32, device=dev)
    pool[C_MODE, :N] = as_f32(torch.as_tensor(modes, device=dev))
    pool[C_CF, :N] = as_f32(torch.full((N,), STALE, dtype=torch.int32, device=dev))
    pool[C_ONF, :N] = as_f32(torch.full((N,), -1, dtype=torch.int32, device=dev))
    pool[C_TCOLL, :N] = float("inf")
    pool[C_REM, :N] = 1.0
    pool[C_ALIVE, :N] = 1.0
    rows = row_of[lanes_f]
    return N, modes, rows, corr[rows, modes] >= 0
