"""The hand-written CUDA kernels against their plain torch twins, on the card.

Needs a CUDA card and no JAX (the machine with the card has none), so the
JAX package's conftest is skipped:

    python -m pytest tests/test_torch_gpu.py -q --noconftest

Without a card every test skips. Data movement and every int row must be
bit-exact (kernel A's in-kernel draws too: kernel and twin hash the same
counters); float rows agree to rtol 2e-5 (kernel and twin round the drift
identically — nvcc --fmad=false, the same operation order — and differ at
most by the card's expf/expm1f ulps); the sums to rtol 1e-5 plus 1e-5 of the
column's absolute total (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from torch_parity import CORRUGATED, aim_at_rough_facets, compact_cases, membrane_box, membrane_kw, wire12

INT_ROWS = [9, 10, 12, 14, 15, 16]  # mode, facet, on-facet, alive, sv, partner
FLOAT_ROWS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 13, 17]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


def _close_rows(a, b, rows):
    for r in rows:
        x, y = a[r].double().cpu(), b[r].double().cpu()
        fin = torch.isfinite(y)
        assert torch.equal(fin, torch.isfinite(x)), r
        scale = y[fin].abs().max() if bool(fin.any()) else 0.0
        assert bool(((x - y).abs()[fin] <= 2e-5 * y.abs()[fin] + 2e-5 * scale).all()), r


def _film(device, layout="slim"):
    """The 4^3 film (T/T/R/R/P, eta = 0) in the port, its pool compacted,
    5% of the lanes STALE and a third without a mirror partner; on the
    "slim" layout or (the slim gate turned off by the caller) the "full"
    one, where a sixth of the lanes then cache a partner frequency 1e-3
    off their own (the swap's occupation term is not zero)."""
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.ops.compact_pool import compact_pool_plain
    from nanokappa_torch.ops.megastep import mega_config
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.fused import autosize_evt_cap
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count

    mat = synthetic_material(mesh=(4, 4, 4))
    dom = build_domain(
        geometry="box", dimensions=(2e3, 1e3, 1e3), subvolumes=("slice", 5, 0),
        bound_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5, 0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
        bound_cond=("T", "T", "R", "R", "P"), bound_values=(302.0, 298.0, 0.0, 0.0),
        connect_pos=("relative", 0.5, -0.1, 0.5, 0.5, 1.1, 0.5),
    )
    n_p, rho = particle_count(("total", 3000), mat, dom)
    params = SimParams(
        dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="pooled",
        particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0,
    )
    geo = build_device_geometry(dom, device)
    btab = build_boundary_tables(mat, dom, device=device)
    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=3)
    assert state.layout == layout
    pool, _ = compact_pool_plain(state.pool)
    alive = torch.nonzero(pool[14] > 0.5).flatten()
    pool[10, alive[::20]] = torch.tensor(-2, dtype=torch.int32, device=device).view(torch.float32)
    pool[16, alive[1::3]] = torch.tensor(-1, dtype=torch.int32, device=device).view(torch.float32)
    if layout == "full":
        pool[17, alive[2::6]] *= 1.001
    cfg = mega_config(
        geo, mat.device_tables(device), btab, params,
        autosize_evt_cap(geo, mat.device_tables(device), params, True, 4096),
        flip_axis=2 if layout == "slim" else None, layout=layout,
    )
    return pool, state.T_sv, cfg


@pytest.mark.gpu
def test_cuda_compact_matches_plain(cuda):
    from nanokappa_torch.ops.compact import compact_indices, compact_indices_plain

    for n, p, cap in ((2048, 0.05, 512), (2048, 0.6, 512), (70001, 0.3, 50000), (300, 0.0, 8)):
        m = torch.rand(n, generator=torch.Generator().manual_seed(n)) < p
        a, na = compact_indices(m.to(cuda), cap)
        b, nb = compact_indices_plain(m, cap)
        assert torch.equal(a.cpu(), b) and int(na) == int(nb)


def _compact_ref(m, cap):
    from nanokappa_torch.ops.compact import compact_indices_plain

    return compact_indices_plain(m.cpu(), cap)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(compact_cases()))
def test_cuda_compact_cases_one_launch(cuda, name):
    """Kernel C at the main paths' four widths and the edges: bit-exact,
    one launch a call on the counter, idx and n_valid views of one buffer."""
    from nanokappa_torch.ops import compact

    mask, cap = compact_cases()[name]
    m = torch.as_tensor(mask).to(cuda)
    before = compact.launches
    idx, nv = compact.compact_indices(m, cap)
    assert compact.launches == before + 1
    ref, rn = _compact_ref(m, cap)
    assert torch.equal(idx.cpu(), ref) and int(nv) == int(rn)
    assert idx.data_ptr() + 4 * cap == nv.data_ptr()


@pytest.mark.gpu
def test_cuda_compact_odd_address_slices(cuda):
    """Masks starting at every address mod 16 and of ragged lengths (the
    kernel's byte loads at the two ends)."""
    from nanokappa_torch.ops.compact import compact_indices

    base = torch.rand(70_037, generator=torch.Generator().manual_seed(3)) < 0.4
    b = base.to(cuda)
    for lo, hi in ((3, None), (1, -1), (15, -7), (16, -16), (5, 4_100), (7, 8)):
        m = b[lo:hi]
        for cap in (512, 30_000, m.shape[0] + 3):
            idx, nv = compact_indices(m, cap)
            ref, rn = _compact_ref(m, cap)
            assert torch.equal(idx.cpu(), ref) and int(nv) == int(rn), (lo, hi, cap)


@pytest.mark.gpu
def test_cuda_compact_200_alternating_calls(cuda):
    """200 calls back to back, alternating widths, one stream: each call
    finds the scratch its predecessor cleared (the self-reset)."""
    from nanokappa_torch.ops import compact

    cases = [(torch.as_tensor(m).to(cuda), cap) for m, cap in compact_cases().values()]
    before = compact.launches
    outs = [compact.compact_indices(*cases[k % len(cases)]) for k in range(200)]
    assert compact.launches == before + 200
    for k, (idx, nv) in enumerate(outs):
        m, cap = cases[k % len(cases)]
        ref, rn = _compact_ref(m, cap)
        assert torch.equal(idx.cpu(), ref) and int(nv) == int(rn), k


@pytest.mark.gpu
def test_cuda_compact_graph_replay(cuda):
    """Kernel C captured in a CUDA graph after a warm-up call, replayed on
    changed mask contents: the twin's output every time (the scratch resets
    on the device, so a replay needs nothing from the host)."""
    from nanokappa_torch.ops.compact import compact_indices

    n, cap = 1_277_952, 79_872
    m = torch.zeros(n, dtype=torch.bool, device=cuda)
    compact_indices(m, cap)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        idx, nv = compact_indices(m, cap)
    gen = torch.Generator().manual_seed(9)
    for p in (0.0377, 0.2, 0.001):
        host = torch.rand(n, generator=gen) < p
        m.copy_(host)
        g.replay()
        torch.cuda.synchronize()
        ref, rn = _compact_ref(host, cap)
        assert torch.equal(idx.cpu(), ref) and int(nv) == int(rn), p


@pytest.mark.gpu
def test_cuda_compact_pool_matches_plain(cuda):
    from nanokappa_torch.ops.compact_pool import compact_pool, compact_pool_plain

    rng = np.random.default_rng(5)
    pool = rng.normal(size=(18, 100_003)).astype(np.float32)
    bits = pool.view(np.int32)
    bits[[9, 10, 12, 15, 16]] = rng.integers(-2, 300, (5, pool.shape[1]))  # ids, STALE
    pool[14] = (rng.random(pool.shape[1]) < 0.6).astype(np.float32)
    pool = torch.as_tensor(pool)
    a, ta = compact_pool(pool.to(cuda))
    b, tb = compact_pool_plain(pool)
    assert int(ta) == int(tb)
    assert torch.equal(_bits(a), _bits(b))


def _plain_pool(device, domain_kw, scat_model="velocity", ctx=None):
    """A mirror-off configuration (rough eta > 0 walls: the "plain" pool with
    in-kernel diffuse reflection) at 4^3, its pool compacted, 5% STALE;
    `ctx`, a dict, receives the domain, geometry and boundary tables."""
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.ops.compact_pool import compact_pool_plain
    from nanokappa_torch.ops.megastep import mega_config
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.fused import build_route
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count

    mat = synthetic_material(mesh=(4, 4, 4))
    dom = build_domain(**domain_kw)
    n_p, rho = particle_count(("total", 3000), mat, dom)
    params = SimParams(
        dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="constant",
        particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0,
        scat_model=scat_model,
    )
    geo = build_device_geometry(dom, device)
    btab = build_boundary_tables(mat, dom, scat_model, device=device)
    tabs = mat.device_tables(device)
    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=3)
    assert state.layout == "plain"
    if ctx is not None:
        ctx.update(dom=dom, geo=geo, btab=btab)
    pool, _ = compact_pool_plain(state.pool)
    alive = torch.nonzero(pool[14] > 0.5).flatten()
    pool[10, alive[::20]] = torch.tensor(-2, dtype=torch.int32, device=device).view(torch.float32)
    cfg = mega_config(geo, tabs, btab, params, build_route(geo, btab, params, tabs).evt_cap)
    return pool, state.T_sv, cfg


WIRE = dict(
    geometry="cylinder", dimensions=(4e3, 500.0, 8), subvolumes=("slice", 5, 2),
    bound_pos=("relative", 0.5, 0.5, -0.1, 0.5, 0.5, 1.1, 1.1, 0.5, 0.5),
    bound_cond=("T", "T", "R", "R"), bound_values=(305.0, 295.0, 2.0, 2.0),
    connect_pos=("relative",),
)
# the film box with eta = 2 A walls: specular partners, so lanes also flag
ROUGH_BOX = dict(
    geometry="box", dimensions=(2e3, 1e3, 1e3), subvolumes=("slice", 5, 0),
    bound_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5, 0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
    bound_cond=("T", "T", "R", "R", "P"), bound_values=(302.0, 298.0, 2.0, 2.0),
    connect_pos=("relative", 0.5, -0.1, 0.5, 0.5, 1.1, 0.5),
)


@pytest.mark.gpu
@pytest.mark.parametrize("rta_on", [False, True])
@pytest.mark.parametrize("kw", [WIRE, ROUGH_BOX], ids=["wire", "rough_box"])
def test_cuda_megastep_plain_layout_matches_plain(cuda, kw, rta_on):
    """Kernel A's mirror-off branch (triangle or box cast, in-kernel
    diffuse reflection): kernel and twin draw the same numbers, so every row
    agrees as on the film."""
    from nanokappa_torch.ops.megastep import drift_megastep, drift_megastep_plain

    pool, T_sv, cfg = _plain_pool(cuda, kw)
    pk, pp = pool.clone(), pool.clone()
    rk, ik, ck, lk, bk = drift_megastep(pk, T_sv, rta_on, cfg, seed=99)
    rp, ip, cp, lp, bp = drift_megastep_plain(pp, T_sv, rta_on, cfg, seed=99)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp) and int(cp[3]) > 0, (ck, cp)
    ints = INT_ROWS[:-1]
    for r in ints:
        assert torch.equal(_bits(pk[r]), _bits(pp[r])), r
    _close_rows(pk, pp, FLOAT_ROWS[:-1])
    k = int(cp[2])
    assert torch.equal(ik, ip)
    for r in ints:
        assert torch.equal(_bits(rk[r, :k]), _bits(rp[r, :k])), r
    _close_rows(rk[:, :k], rp[:, :k], FLOAT_ROWS[:-1])
    for a, b in ((lk, lp), (bk, bp)):
        a, b = a.double().cpu(), b.double().cpu()
        scale = b.abs().sum(0, keepdim=True) + b.abs().max()
        assert bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-5 * scale).all())


@pytest.mark.gpu
@pytest.mark.parametrize("rta_on", [False, True])
def test_cuda_megastep_matches_plain(cuda, rta_on):
    from nanokappa_torch.ops.megastep import drift_megastep, drift_megastep_plain

    pool, T_sv, cfg = _film(cuda)
    pk, pp = pool.clone(), pool.clone()
    rk, _, ck, lk, bk = drift_megastep(pk, T_sv, rta_on, cfg)
    rp, _, cp, lp, bp = drift_megastep_plain(pp, T_sv, rta_on, cfg)
    assert torch.equal(ck, cp) and int(cp[2]) > 0
    for r in INT_ROWS:
        assert torch.equal(_bits(pk[r]), _bits(pp[r])), r
    _close_rows(pk, pp, FLOAT_ROWS)
    k = int(cp[2])
    for r in INT_ROWS:
        assert torch.equal(_bits(rk[r, :k]), _bits(rp[r, :k])), r
    _close_rows(rk[:, :k], rp[:, :k], FLOAT_ROWS)
    for a, b in ((lk, lp), (bk, bp)):
        a, b = a.double().cpu(), b.double().cpu()
        scale = b.abs().sum(0, keepdim=True) + b.abs().max()
        assert bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-5 * scale).all())


def _crafted_full(pool16, cfg, seed=4):
    """The wire's 16-row pool with a crafted 24-row mirror cache: two thirds
    of the alive lanes cache a random partner mode (its omega and velocity
    from the config's mode table, an intercept and two slopes from the
    lane's lifetime), the rest none; the config turned to the full layout."""
    import dataclasses

    g = torch.Generator(device=pool16.device).manual_seed(seed)
    N = pool16.shape[1]
    ov = cfg.omega_vel
    xm = torch.randint(0, ov.shape[0], (N,), generator=g, device=pool16.device, dtype=torch.int32)
    has = (torch.rand(N, generator=g, device=pool16.device) < 2 / 3) & (pool16[14] > 0.5)
    xm = torch.where(has, xm, -1)
    o = ov[xm.clamp(min=0).long()]
    tau = pool16[7]
    rows = torch.stack([
        xm.view(torch.float32), torch.where(has, o[:, 0], 0.0),
        *[torch.where(has, o[:, 1 + k], 0.0) for k in range(3)],
        torch.where(has, 0.5 * tau, 0.0), -1e-3 * tau, torch.where(has, 2e-3 * tau, 0.0),
    ])
    return torch.cat([pool16, rows]).contiguous(), dataclasses.replace(cfg, layout="full", dkern=False)


@pytest.mark.gpu
@pytest.mark.parametrize("rta_on", [False, True])
@pytest.mark.parametrize("cast", ["box", "triangle"])
def test_cuda_megastep_full_layout_matches_plain(cuda, cast, rta_on, monkeypatch):
    """Kernel A's full-mirror branch (the 24-row pool): the swap of mode,
    omega, velocity, intercept and slope with the cache, and the occupation
    re-referenced to the partner's frequency, on the film's box cast and on
    the wire's triangle cast."""
    from nanokappa_torch.ops.megastep import drift_megastep, drift_megastep_plain
    from nanokappa_torch.sim import fused

    if cast == "box":
        monkeypatch.setattr(fused, "slim_mirror_axis", lambda *a, **k: None)
        pool, T_sv, cfg = _film(cuda, "full")
    else:
        pool16, T_sv, cfg16 = _plain_pool(cuda, WIRE)
        pool, cfg = _crafted_full(pool16, cfg16)
    pk, pp = pool.clone(), pool.clone()
    rk, ik, ck, lk, bk = drift_megastep(pk, T_sv, rta_on, cfg, seed=7)
    rp, ip, cp, lp, bp = drift_megastep_plain(pp, T_sv, rta_on, cfg, seed=7)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp) and int(cp[2]) > 0, (ck, cp)
    assert not torch.equal(_bits(pp[9]), _bits(pool[9]))  # lanes swapped
    float_rows = [r for r in range(24) if r not in INT_ROWS]
    for r in INT_ROWS:
        assert torch.equal(_bits(pk[r]), _bits(pp[r])), r
    _close_rows(pk, pp, float_rows)
    k = int(cp[2])
    assert torch.equal(ik, ip)
    for r in INT_ROWS:
        assert torch.equal(_bits(rk[r, :k]), _bits(rp[r, :k])), r
    _close_rows(rk[:, :k], rp[:, :k], float_rows)
    for a, b in ((lk, lp), (bk, bp)):
        a, b = a.double().cpu(), b.double().cpu()
        scale = b.abs().sum(0, keepdim=True) + b.abs().max()
        assert bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-5 * scale).all())


def _cylinder(device, n_side=96):
    """The 96-sided cylinder (384 triangles: kernel_cast off, kernel E) at
    4^3, 2 slices, its pool compacted."""
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.ops.compact_pool import compact_pool_plain
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count

    mat = synthetic_material(mesh=(4, 4, 4))
    dom = build_domain(
        geometry="cylinder", dimensions=(2e3, 500.0, n_side), subvolumes=("slice", 2, 2),
        bound_pos=("relative", 0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
        bound_cond=("T", "T", "R"), bound_values=(302.0, 298.0, 2.0),
    )
    n_p, rho = particle_count(("total", 3000), mat, dom)
    params = SimParams(
        dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="pooled",
        particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0,
    )
    geo = build_device_geometry(dom, device)
    btab = build_boundary_tables(mat, dom, device=device)
    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=3)
    pool, _ = compact_pool_plain(state.pool)
    return mat, geo, btab, params, pool, state.T_sv


@pytest.mark.gpu
def test_cuda_raycast_large_matches_plain(cuda):
    """Kernel E against its twin: pool rays, rays with zero velocity
    components, excluded facets, and rays aimed at triangle vertices (ties
    between triangles); t and facet bit for bit."""
    from nanokappa_torch.ops import raycast_large as rl

    _, geo, _, _, pool, _ = _cylinder(cuda)
    pos = pool[0:3].T.contiguous()
    vel = pool[3:6].T.contiguous()
    vel[::7, 2] = 0.0
    vel[1::7, :2] = 0.0
    ex = pool[12].contiguous().view(torch.int32).clone()
    verts = geo.tri_origin[::3]
    vpos = pos[: verts.shape[0]].clone()
    vpos[:, 2] = verts[:, 2]  # aim across the cross-section at a vertex
    pos = torch.cat([pos, vpos])
    vel = torch.cat([vel, (verts - vpos) / 3.0])
    ex = torch.cat([ex, torch.full((verts.shape[0],), -1, dtype=torch.int32, device=cuda)])
    n0 = rl.launches
    tk, fk = rl.raycast_large(geo, pos, vel, ex)
    assert rl.launches == n0 + 1
    tp, fp = rl.raycast_large_plain(rl.prep(geo), pos, vel, ex)
    torch.cuda.synchronize()
    assert torch.equal(_bits(tk), _bits(tp)) and torch.equal(fk.cpu(), fp.cpu())
    # the strided (3, N).T view takes the same path
    tk2, fk2 = rl.raycast_large(geo, pool[0:3].T, pool[3:6].T, pool[12].contiguous().view(torch.int32))
    tp2, fp2 = rl.raycast_large_plain(rl.prep(geo), pool[0:3].T, pool[3:6].T,
                                      pool[12].contiguous().view(torch.int32))
    assert torch.equal(_bits(tk2), _bits(tp2)) and torch.equal(fk2.cpu(), fp2.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("rta_on", [False, True])
def test_cuda_megastep_precast_matches_plain(cuda, rta_on):
    """Kernel A's kernel_cast-off branch against its twin on the cylinder's
    pool with 5% of the lanes pre-cast."""
    from nanokappa_torch.ops.megastep import drift_megastep, drift_megastep_plain, mega_config
    from nanokappa_torch.ops.raycast import raycast
    from nanokappa_torch.sim.fused import build_route

    mat, geo, btab, params, pool, T_sv = _cylinder(cuda)
    tabs = mat.device_tables(cuda)
    alive = torch.nonzero(pool[14] > 0.5).flatten()
    pre = alive[::20]
    t, f = raycast(geo, pool[0:3, pre].T, pool[3:6, pre].T, pool[12, pre].contiguous().view(torch.int32))
    pool[11, pre] = -t - 1.0
    pool[10, pre] = f.view(torch.float32)
    cfg = mega_config(geo, tabs, btab, params, build_route(geo, btab, params, tabs).evt_cap)
    assert not cfg.kernel_cast
    pk, pp = pool.clone(), pool.clone()
    rk, ik, ck, lk, bk = drift_megastep(pk, T_sv, rta_on, cfg)
    rp, ip, cp, lp, bp = drift_megastep_plain(pp, T_sv, rta_on, cfg)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp) and int(cp[2]) > 0, (ck, cp)
    ints = INT_ROWS[:-1]
    for r in ints:
        assert torch.equal(_bits(pk[r]), _bits(pp[r])), r
    _close_rows(pk, pp, FLOAT_ROWS[:-1])
    k = int(cp[2])
    assert torch.equal(ik, ip)
    for r in ints:
        assert torch.equal(_bits(rk[r, :k]), _bits(rp[r, :k])), r
    _close_rows(rk[:, :k], rp[:, :k], FLOAT_ROWS[:-1])
    assert not bool(lk.any()) and not bool(lp.any())
    a, b = bk.double().cpu(), bp.double().cpu()
    scale = b.abs().sum(0, keepdim=True) + b.abs().max()
    assert bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-5 * scale).all())


@pytest.mark.gpu
def test_cuda_raycast_large_skip_keeps_results(cuda):
    """Kernel E's block-wide chunk skip on a mesh whose Morton chunks are
    local: the 96-sided cylinder cut into 16 rings along its axis (3,264
    triangles, 26 chunks). Each block of 256 rays starts near the axis and
    aims at one vertex (every other block grazes around it), so blocks skip
    most chunks; t and facet stay bit-equal to the twin, which skips none."""
    from types import SimpleNamespace

    from nanokappa_torch.geometry.primitives import make_primitive
    from nanokappa_torch.ops import raycast_large as rl

    mesh = make_primitive("zigzag", (250.0, 500.0, 0.0, 0.0, 96, 16))
    tri = mesh.tri

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=cuda)

    geo = SimpleNamespace(
        is_box=False, device=cuda, tri_origin=f32(tri[:, 0]), tri_e1=f32(tri[:, 1] - tri[:, 0]),
        tri_e2=f32(tri[:, 2] - tri[:, 0]),
        tri_facet=torch.as_tensor(mesh.face_facet.astype(np.int32), device=cuda),
    )
    rng = np.random.default_rng(17)
    pos, vel, ex = [], [], []
    for b in range(64):
        target = mesh.vertices[rng.integers(len(mesh.vertices))]
        r, a = 100.0 * np.sqrt(rng.random(256)), 2 * np.pi * rng.random(256)
        z = np.clip(target[2] + rng.normal(0.0, 30.0, 256), 1.0, 3999.0)
        p = np.stack([r * np.cos(a), r * np.sin(a), z], axis=1)
        d = target[None, :] - p
        if b % 2:
            d = d + rng.normal(0.0, 2.0, d.shape)
        e = np.full(256, -1)
        e[::5] = rng.integers(0, mesh.face_facet.max() + 1, 52)
        pos.append(p), vel.append(d / 5.0), ex.append(e)
    pos, vel = f32(np.concatenate(pos)), f32(np.concatenate(vel))
    ex = torch.as_tensor(np.concatenate(ex).astype(np.int32), device=cuda)
    tabs = rl.prep(geo)
    assert tabs.nc == 26
    tp, fp = rl.raycast_large_plain(tabs, pos, vel, ex)
    g = rl.launch_shape(len(ex))
    staged = torch.zeros(rl.launch_blocks(len(ex), g), dtype=torch.int32, device=cuda)
    tk, fk = rl.raycast_large(geo, pos, vel, ex, staged=staged)
    torch.cuda.synchronize()
    print(f"G = {g}: chunks staged per block {float(staged.float().mean()):.3f} of {tabs.nc}")
    assert float(staged.float().mean()) < tabs.nc / 2, staged
    assert torch.equal(_bits(tk), _bits(tp)) and torch.equal(fk.cpu(), fp.cpu())
    assert int((fp >= 0).sum()) > 0.99 * len(fp)


def _box_ctx(device, domain_kw):
    """A box configuration at 4^3 in the port: its tables, parameters and
    compacted initial pool (5% of the alive lanes STALE)."""
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.ops.compact_pool import compact_pool_plain
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count

    mat = synthetic_material(mesh=(4, 4, 4))
    dom = build_domain(**domain_kw)
    n_p, rho = particle_count(("total", 3000), mat, dom)
    params = SimParams(
        dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="pooled",
        particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0,
    )
    geo = build_device_geometry(dom, device)
    btab = build_boundary_tables(mat, dom, device=device)
    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=3)
    pool, _ = compact_pool_plain(state.pool)
    alive = torch.nonzero(pool[14] > 0.5).flatten()
    pool[10, alive[::20]] = torch.tensor(-2, dtype=torch.int32, device=device).view(torch.float32)
    return dom, geo, mat.device_tables(device), btab, params, pool, state.T_sv


def _kernel_vs_twin(pool, T_sv, cfg, seed, rta_on=True):
    """Kernel A and its twin on copies of one pool: every row, the exported
    rows and indices and the counts bit for bit, the sums to rtol 1e-5."""
    from nanokappa_torch.ops.megastep import drift_megastep, drift_megastep_plain

    pk, pp = pool.clone(), pool.clone()
    rk, ik, ck, lk, bk = drift_megastep(pk, T_sv, rta_on, cfg, seed=seed)
    rp, ip, cp, lp, bp = drift_megastep_plain(pp, T_sv, rta_on, cfg, seed=seed)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp), (ck, cp)
    assert torch.equal(_bits(pk), _bits(pp))
    k = int(cp[2])
    assert torch.equal(ik, ip) and torch.equal(_bits(rk[:, :k]), _bits(rp[:, :k]))
    for a, b in ((lk, lp), (bk, bp)):
        a, b = a.double().cpu(), b.double().cpu()
        scale = b.abs().sum(0, keepdim=True) + b.abs().max()
        assert bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-5 * scale).all())
    return pk


FILM4 = dict(
    geometry="box", dimensions=(2e3, 1e3, 1e3), subvolumes=("slice", 5, 0),
    bound_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5, 0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
    bound_cond=("T", "T", "R", "R", "P"), bound_values=(302.0, 298.0, 0.0, 0.0),
    connect_pos=("relative", 0.5, -0.1, 0.5, 0.5, 1.1, 0.5),
)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["slim", "plain"])
def test_cuda_megastep_nearest_centre_256_near_ties(cuda, layout):
    """Kernel A's nearest-centre instantiation at its 256-centre cap, on a
    pool whose lanes sit on the faces between neighbouring centres (the
    bisector planes: near-ties the first-minimum rule decides), bit-exact
    against its twin. The film box re-binned by a 16 x 4 x 4 grid, with
    eta = 0 walls (slim) or eta = 2 A walls (plain, in-kernel diffuse)."""
    import dataclasses

    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.subvolumes import grid_centers
    from nanokappa_torch.ops.megastep import SV_CENTER, mega_config
    from nanokappa_torch.sim.boundary_tables import slim_mirror_axis
    from nanokappa_torch.sim.fused import build_route

    kw = FILM4 if layout == "slim" else dict(FILM4, bound_values=(302.0, 298.0, 2.0, 2.0))
    dom, geo, tabs, btab, params, pool, _ = _box_ctx(cuda, kw)
    c = grid_centers(dom.mesh, np.array([16, 4, 4]))
    gdom = dataclasses.replace(dom, subvol_type="grid", subvol_center=c,
                               subvol_volume=np.full(len(c), dom.mesh.volume / len(c)))
    ggeo = build_device_geometry(gdom, cuda)
    flip = slim_mirror_axis(geo, btab, tabs) if layout == "slim" else None
    assert (flip is not None) == (layout == "slim") and pool.shape[0] == (18 if flip is not None else 16)
    cfg = mega_config(ggeo, tabs, btab, params, build_route(geo, btab, params, tabs).evt_cap, flip)
    assert cfg.sv_mode == SV_CENTER and cfg.sv == 256
    # half the alive lanes onto the bisector plane of a random pair of
    # x-neighbouring centres, jittered inside the plane
    rng = np.random.default_rng(23)
    alive = torch.nonzero(pool[14] > 0.5).flatten().cpu().numpy()
    lanes = alive[::2]
    a = rng.integers(0, len(c) - 16, len(lanes))
    b = a + 16  # the next centre along x in the grid's (x, y, z) order
    mid = 0.5 * (c[a] + c[b])
    mid[:, 1:] += rng.uniform(-20.0, 20.0, (len(lanes), 2))
    pool[0:3, torch.as_tensor(lanes, device=cuda)] = torch.as_tensor(mid.T, dtype=torch.float32, device=cuda)
    T_sv = torch.as_tensor(302.0 - 4.0 * (c[:, 0] - c[:, 0].min()) / np.ptp(c[:, 0]),
                           dtype=torch.float32, device=cuda)
    for rta_on in (False, True):
        out = _kernel_vs_twin(pool, T_sv, cfg, seed=31, rta_on=rta_on)
    sv = out[15].contiguous().view(torch.int32)
    assert int(sv.min()) >= 0 and int(sv.max()) <= 255 and len(torch.unique(sv)) > 250


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["slim", "plain"])
def test_cuda_megastep_linear_T_extrapolates(cuda, layout):
    """Kernel A's linear-temperature instantiation on the film box (slim,
    the deferred RTA at the lerped T) and on the eta = 2 A box (plain, the
    in-kernel diffuse wall temperature too), with a third of the lanes
    between a reservoir wall and the end slice centres (the lerp
    extrapolates there), bit-exact against its twin."""
    import dataclasses

    from nanokappa_torch.ops.megastep import SV_LINEAR, mega_config
    from nanokappa_torch.sim.boundary_tables import slim_mirror_axis
    from nanokappa_torch.sim.fused import build_route

    kw = FILM4 if layout == "slim" else dict(FILM4, bound_values=(302.0, 298.0, 2.0, 2.0))
    dom, geo, tabs, btab, params, pool, T_sv = _box_ctx(cuda, kw)
    params = dataclasses.replace(params, temp_interp="linear")
    flip = slim_mirror_axis(geo, btab, tabs) if layout == "slim" else None
    cfg = mega_config(geo, tabs, btab, params, build_route(geo, btab, params, tabs).evt_cap, flip)
    assert cfg.sv_mode == SV_LINEAR
    rng = np.random.default_rng(29)
    alive = torch.nonzero(pool[14] > 0.5).flatten().cpu().numpy()
    lanes = alive[::3]
    c0, c1 = float(dom.subvol_center[0, 0]), float(dom.subvol_center[-1, 0])
    lo, hi = dom.mesh.bounds[:, 0]
    x = np.where(rng.random(len(lanes)) < 0.5, rng.uniform(lo + 1.0, c0, len(lanes)),
                 rng.uniform(c1, hi - 1.0, len(lanes)))
    pool[0, torch.as_tensor(lanes, device=cuda)] = torch.as_tensor(x, dtype=torch.float32, device=cuda)
    T_sv = torch.tensor([301.5, 300.5, 300.2, 299.1, 298.4], device=cuda)
    for rta_on in (False, True):
        _kernel_vs_twin(pool, T_sv, cfg, seed=37, rta_on=rta_on)


@pytest.mark.gpu
@pytest.mark.parametrize("n,e,nval", [(40_000, 4096, 2000), (16_384, 1024, 1024), (20_000, 512, 0), (50_000, 2048, 2048)])
def test_cuda_scatter_rows_matches_plain(cuda, n, e, nval):
    from nanokappa_torch.ops import scatter_rows as sr
    from torch_parity import scatter_case

    pool, rows, idx = (torch.as_tensor(x) for x in scatter_case(n, e, nval))
    before = sr.launches
    out = sr.scatter_rows(pool.to(cuda), rows.to(cuda), idx.to(cuda))
    assert sr.launches == before + 1
    ref = sr.scatter_rows_plain(pool.clone(), rows, idx)
    assert torch.equal(_bits(out), _bits(ref))


def _star_events(E, seed=6):
    """The star's event buffer shape: a (16, 1,277,952) bit-hazard pool,
    48,176 ascending unique lanes (~26 apart) then the sentinel N, E lanes."""
    from torch_parity import hazard_pool

    rng = np.random.default_rng(seed)
    N, C, n = 1_277_952, 16, 48_176
    pool = hazard_pool(rng, C, N)
    rows = hazard_pool(rng, C, E)
    idx = np.full(E, N, np.int32)
    idx[:n] = np.sort(rng.choice(N, n, replace=False))
    return torch.as_tensor(pool), torch.as_tensor(rows), torch.as_tensor(idx)


@pytest.mark.gpu
@pytest.mark.parametrize("E", [79_872, 79_871])
def test_cuda_scatter_rows_star_shape(cuda, E):
    """Kernel D at the star's shape, and with E not a multiple of 4, then
    on a sentinel-only buffer, which must leave the pool untouched."""
    from nanokappa_torch.ops import scatter_rows as sr

    pool, rows, idx = _star_events(E)
    before = sr.launches
    out = sr.scatter_rows(pool.to(cuda), rows.to(cuda), idx.to(cuda))
    assert sr.launches == before + 1
    assert torch.equal(_bits(out), _bits(sr.scatter_rows_plain(pool.clone(), rows, idx)))
    sent = torch.full((E,), pool.shape[1], dtype=torch.int32, device=cuda)
    out = sr.scatter_rows(pool.to(cuda), rows.to(cuda), sent)
    assert torch.equal(_bits(out), _bits(pool))


@pytest.mark.gpu
def test_cuda_compact_pool_full_width(cuda):
    """Kernel B on its offsets from nk::scan_runs at the pool's width
    (1,277,952 lanes, 4,992 block counts: 5 a scan thread)."""
    from nanokappa_torch.ops.compact_pool import compact_pool, compact_pool_plain
    from torch_parity import hazard_pool

    pool = torch.as_tensor(hazard_pool(np.random.default_rng(7), 16, 1_277_952, p_alive=0.78))
    a, ta = compact_pool(pool.to(cuda))
    b, tb = compact_pool_plain(pool)
    assert int(ta) == int(tb)
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.gpu
def test_cuda_star_v1_step_matches_cpu(cuda, monkeypatch):
    """The star (examples/voronoi_star.txt's domain: radial temperatures, so
    the v1 step) on the card against the CPU from one initial state, 4
    steps: T_sv within 0.1 K (the card's and the CPU's random streams
    differ), nothing lost; kernels C and D launched on the card."""
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.ops import compact, scatter_rows
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.fused import build_route
    from nanokappa_torch.sim.reservoir import autosize_c_max, build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count
    from nanokappa_torch.sim.step import build_step
    from torch_parity import STAR, STAR_CENTERS, patch_lloyd

    patch_lloyd(monkeypatch, STAR_CENTERS, equal_volumes=True)
    dom = build_domain(**STAR)
    mat = synthetic_material(mesh=(6, 6, 6))
    n_p, rho = particle_count(("total", 3000), mat, dom)
    outs = []
    for d in (torch.device("cpu"), cuda):
        rtab = build_reservoir_tables(mat, dom, 1.0, rho, device=d)
        params = SimParams(
            dt=1.0, n_cap=4096, inj_cap=512, c_max=autosize_c_max(rtab), temp_interp="radial",
            res_gen="constant", particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0,
        )
        geo = build_device_geometry(dom, d)
        assert build_route(geo, None, params, None).step == "v1"
        btab = build_boundary_tables(mat, dom, device=d)
        state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=4)
        n_c, n_d = compact.launches, scatter_rows.launches
        _, out = build_step(geo, mat.device_tables(d), btab, rtab, params, n_inner=1, n_outer=4)(state)
        outs.append(out)
    assert compact.launches > n_c and scatter_rows.launches == n_d + 4
    a, b = outs
    np.testing.assert_allclose(b.T_sv.cpu().numpy(), a.T_sv.numpy(), atol=0.1)
    assert int(a.lost[-1]) == 0 and int(b.lost[-1]) == 0


def _instantiation(name, cuda, monkeypatch):
    """(pool, T_sv, cfg) of one kernel A instantiation at 4^3."""
    import dataclasses

    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.subvolumes import grid_centers
    from nanokappa_torch.ops.megastep import mega_config
    from nanokappa_torch.ops.raycast import raycast
    from nanokappa_torch.sim import fused
    from nanokappa_torch.sim.boundary_tables import slim_mirror_axis
    from nanokappa_torch.sim.fused import build_route

    if name == "box/slim/slice":
        return _film(cuda)
    if name == "box/full/slice":
        monkeypatch.setattr(fused, "slim_mirror_axis", lambda *a, **k: None)
        return _film(cuda, "full")
    if name in ("triangle/plain/slice", "box/plain/slice"):
        return _plain_pool(cuda, WIRE if name.startswith("triangle") else ROUGH_BOX)
    if name == "triangle/full/slice":
        pool16, T_sv, cfg16 = _plain_pool(cuda, WIRE)
        pool, cfg = _crafted_full(pool16, cfg16)
        return pool, T_sv, cfg
    if name == "precast/slice":
        mat, geo, btab, params, pool, T_sv = _cylinder(cuda)
        tabs = mat.device_tables(cuda)
        pre = torch.nonzero(pool[14] > 0.5).flatten()[::20]
        t, f = raycast(geo, pool[0:3, pre].T, pool[3:6, pre].T, pool[12, pre].contiguous().view(torch.int32))
        pool[11, pre] = -t - 1.0
        pool[10, pre] = f.view(torch.float32)
        return pool, T_sv, mega_config(geo, tabs, btab, params, build_route(geo, btab, params, tabs).evt_cap)
    kw = FILM4 if "slim" in name else dict(FILM4, bound_values=(302.0, 298.0, 2.0, 2.0))
    dom, geo, tabs, btab, params, pool, T_sv = _box_ctx(cuda, kw)
    flip = slim_mirror_axis(geo, btab, tabs) if "slim" in name else None
    if name.endswith("linear"):
        params = dataclasses.replace(params, temp_interp="linear")
        return pool, T_sv, mega_config(geo, tabs, btab, params, build_route(geo, btab, params, tabs).evt_cap, flip)
    c = grid_centers(dom.mesh, np.array([16, 4, 4]))
    gdom = dataclasses.replace(dom, subvol_type="grid", subvol_center=c,
                               subvol_volume=np.full(len(c), dom.mesh.volume / len(c)))
    T_sv = torch.as_tensor(302.0 - 4.0 * (c[:, 0] - c[:, 0].min()) / np.ptp(c[:, 0]),
                           dtype=torch.float32, device=cuda)
    cfg = mega_config(build_device_geometry(gdom, cuda), tabs, btab, params,
                      build_route(geo, btab, params, tabs).evt_cap, flip)
    return pool, T_sv, cfg


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "box/slim/slice", "box/full/slice", "box/plain/slice", "triangle/plain/slice",
    "triangle/full/slice", "precast/slice", "box/slim/linear", "box/plain/linear",
    "box/slim/centre", "box/plain/centre",
])
def test_cuda_megastep_two_launches_bit_equal(cuda, name, monkeypatch):
    """Kernel A's sums are in a fixed order (counting-sorted block sums,
    one-block-an-output reductions) and its queued triangle casts combine
    on a total order: two launches on copies of one pool give the same bits
    in every output, and the counts match the twin."""
    from nanokappa_torch.ops.megastep import drift_megastep, drift_megastep_plain

    pool, T_sv, cfg = _instantiation(name, cuda, monkeypatch)
    a, b = pool.clone(), pool.clone()
    ra = drift_megastep(a, T_sv, True, cfg, seed=41)
    rb = drift_megastep(b, T_sv, True, cfg, seed=41)
    rp = drift_megastep_plain(pool.clone(), T_sv, True, cfg, seed=41)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b))
    for x, y in zip(ra, rb):
        assert torch.equal(x.cpu().contiguous().view(torch.int32), y.cpu().contiguous().view(torch.int32))
    assert torch.equal(ra[2], rp[2]) and torch.equal(ra[1], rp[1]), (ra[2], rp[2])


def _tie_tables(cuda):
    """Kernel E's tables of copies of one triangle ((0,0,0), (10,0,0),
    (0,10,0) in z = 0) in three chunks: a ray that hits one copy hits all at
    the same t (tests/test_torch_raycast_split.py's crafted ties)."""
    from types import SimpleNamespace

    from nanokappa_torch.ops.raycast_large import BF, LargeMeshTables

    facets = [{3: 7, 90: 4, 91: 9}, {0: 2, 5: 4}, {127: 1, 64: 3}]
    nc = len(facets)
    tab = np.zeros((16, nc * BF), np.float32)
    tab[0], tab[4], tab[8] = 0.1, 0.1, 1.0
    fac = np.full(nc * BF, -1, np.int32)
    for c, fs in enumerate(facets):
        for k, f in fs.items():
            fac[c * BF + k] = f
    tab[12] = fac.view(np.float32)
    reach = np.concatenate([np.full((3, nc), -20.0), np.full((3, nc), 20.0)]).astype(np.float32)
    tabs = LargeMeshTables(
        order=np.arange(nc * BF), bbox=torch.zeros((16, nc), device=cuda),
        tab=torch.as_tensor(tab, device=cuda), reach=torch.as_tensor(reach, device=cuda),
        rec=torch.as_tensor(np.ascontiguousarray(tab.T), device=cuda),
    )
    geo = SimpleNamespace()
    geo._large_cast = tabs
    return geo, tabs


@pytest.mark.gpu
def test_cuda_raycast_large_every_shape_matches_plain(cuda):
    """Kernel E in each regime `launch_shape` picks (G = 16, 8 and 1
    threads a ray: 3,304, 52,805 and 300,000 rays), bit for bit against its
    twin: on the 96-sided cylinder's pool rays (vertex-aimed ones among
    them) and on crafted ties — equal t within a chunk and across chunks, an
    excluded facet, zero velocity components, a ray parallel to the plane
    and one moving away."""
    from nanokappa_torch.ops import raycast_large as rl

    _, geo, _, _, pool, _ = _cylinder(cuda)
    pos = pool[0:3].T.contiguous()
    vel = pool[3:6].T.contiguous()
    vel[::7, 2] = 0.0
    ex = pool[12].contiguous().view(torch.int32).clone()
    verts = geo.tri_origin[::3]
    vpos = pos[: verts.shape[0]].clone()
    vpos[:, 2] = verts[:, 2]
    pos = torch.cat([pos, vpos])
    vel = torch.cat([vel, (verts - vpos) / 3.0])
    ex = torch.cat([ex, torch.full((verts.shape[0],), -1, dtype=torch.int32, device=cuda)])
    gen = torch.Generator(device=cuda).manual_seed(3)
    for n in (3304, 52805, 300000):
        j = torch.arange(n, device=cuda)
        k = j % pos.shape[0]  # the rays again, each later copy jittered
        jitter = 0.1 * torch.rand((n, 3), generator=gen, device=cuda)
        p = pos[k] + torch.where(j[:, None] < pos.shape[0], 0.0, jitter)
        tp, fp = rl.raycast_large_plain(rl.prep(geo), p, vel[k], ex[k])
        tk, fk = rl.raycast_large(geo, p, vel[k], ex[k])
        torch.cuda.synchronize()
        assert torch.equal(_bits(tk), _bits(tp)) and torch.equal(fk.cpu(), fp.cpu()), n
    tgeo, tabs = _tie_tables(cuda)
    base_p = [[2.0, 3.0, 5.0], [2.0, 3.0, 5.0], [2.0, 3.0, 5.0], [0.0, 0.0, 5.0], [10.0, 0.0, 5.0],
              [4.0, 4.0, 1.0], [2.0, 3.0, 5.0], [3.0, 3.0, -2.0], [1.0, 1.0, 5.0]]
    base_v = [[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, -2.0], [-1.0, 0.0, -1.0],
              [1.0, 1.0, -0.5], [1.0, 0.0, 0.0], [0.0, 0.0, 3.0], [0.0, 0.0, 1.0]]
    base_e = [-1, 4, 7, -1, -1, 9, -1, 2, -1]
    shapes = set()
    for reps in (400, 6000, 30000):  # 3,600, 54,000 and 270,000 rays: G = 16, 8, 1
        p = torch.tensor(base_p * reps, device=cuda)
        v = torch.tensor(base_v * reps, device=cuda)
        e = torch.tensor(base_e * reps, dtype=torch.int32, device=cuda)
        tp, fp = rl.raycast_large_plain(tabs, p, v, e)
        assert fp[:3].tolist() == [4, 7, 4]
        tk, fk = rl.raycast_large(tgeo, p, v, e)
        torch.cuda.synchronize()
        assert torch.equal(_bits(tk), _bits(tp)) and torch.equal(fk.cpu(), fp.cpu()), reps
        shapes.add(rl.launch_shape(len(e)))
    assert shapes == set(rl.THREADS_PER_RAY)


@pytest.mark.gpu
@pytest.mark.parametrize("eta0", [False, True], ids=["eta5", "eta0"])
@pytest.mark.parametrize("rta_on", [False, True])
def test_cuda_megastep_mask_words_matches_plain(cuda, rta_on, eta0):
    """Kernel A's in-kernel diffuse branch with the partner mask in two
    words: the corrugated wire (40 wall-table rows) under the k model,
    whose rows 32-39 have partners for some modes, with 1,920 lanes aimed
    at its rough facets. Kernel and twin agree bit for bit on the int rows
    and the exported indices; with eta = 0 (p = 1 where a partner exists)
    the flagged lanes are exactly those with a partner at the row."""
    import dataclasses

    from nanokappa_torch.ops.megastep import FT_ETA, drift_megastep, drift_megastep_plain

    ctx = {}
    pool, T_sv, cfg = _plain_pool(cuda, CORRUGATED, "k", ctx)
    assert cfg.cmask_w == 2 and cfg.tris.shape[0] == 120
    N, modes, rows, has = aim_at_rough_facets(pool, ctx["dom"], ctx["geo"], ctx["btab"])
    assert has[rows >= 32].any() and (~has[rows >= 32]).any()
    if eta0:
        facets = cfg.facets.clone()
        facets[:, FT_ETA] = 0.0
        cfg = dataclasses.replace(cfg, facets=facets)
    pk, pp = pool.clone(), pool.clone()
    rk, ik, ck, lk, bk = drift_megastep(pk, T_sv, rta_on, cfg, seed=5)
    rp, ip, cp, lp, bp = drift_megastep_plain(pp, T_sv, rta_on, cfg, seed=5)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp) and int(cp[3]) > 0 and (int(cp[4]) > 0) == eta0, (ck, cp)
    ints = INT_ROWS[:-1]
    for r in ints:
        assert torch.equal(_bits(pk[r]), _bits(pp[r])), r
    _close_rows(pk, pp, FLOAT_ROWS[:-1])
    k = int(cp[2])
    assert torch.equal(ik, ip)
    for r in ints:
        assert torch.equal(_bits(rk[r, :k]), _bits(rp[r, :k])), r
    if eta0:
        ex = np.zeros(pool.shape[1], bool)
        ex[ik[:k].cpu().numpy()] = True
        assert ex[:N][has].all() and ex[:N][rows >= 32].any()


@pytest.mark.gpu
@pytest.mark.parametrize("eta0", [False, True], ids=["eta", "eta0"])
@pytest.mark.parametrize("rta_on", [False, True])
@pytest.mark.parametrize("case", ["membrane", "wire12"])
def test_cuda_megastep_two_sided_and_partial_mask_match_plain(cuda, tmp_path, case, rta_on, eta0):
    """Kernel A's triangle / plain / in-kernel-diffuse branch on the two
    paths no other card test runs: the membrane box of
    tests/test_interfaces.py (a doubled internal sheet through an STL, its
    facet table two-sided) with 512 lanes aimed at the membrane from each
    side, the back side's hits reading the back row; and the 12-sided wire
    of BASELINE config 3 (velocity model: 4 of its 12 rows have partners,
    a partial mask) at eta = 0 with lanes aimed at every side wall. Kernel
    and twin agree bit for bit on the int rows and the exported indices;
    with eta = 0 in the facet table the flagged lanes are exactly those
    whose mode has a partner at the row their hit reads."""
    import dataclasses

    from nanokappa_torch.geometry import stl
    from nanokappa_torch.ops.megastep import FT_ETA, drift_megastep, drift_megastep_plain
    from nanokappa_torch.sim.fused import dkern_facet_tables

    ctx = {}
    if case == "membrane":
        path = str(tmp_path / "membrane.stl")
        stl.save_stl(membrane_box(doubled=True), path)
        pool, T_sv, cfg = _plain_pool(cuda, membrane_kw(path, "tables"), ctx=ctx)
        assert dkern_facet_tables(ctx["geo"], ctx["btab"])["two_sided"] and cfg.tris.shape[0] == 24
        mem = [int(ctx["dom"].mesh.interfacets[0])]
        N, _, _, has_f = aim_at_rough_facets(pool, ctx["dom"], ctx["geo"], ctx["btab"], 512, facets=mem)
        Nb, _, _, has_b = aim_at_rough_facets(pool[:, N:], ctx["dom"], ctx["geo"], ctx["btab"], 512,
                                              seed=2, back=True, facets=mem)
        N, has = N + Nb, np.concatenate([has_f, has_b])
    else:
        pool, T_sv, cfg = _plain_pool(cuda, wire12(0.0 if eta0 else 2.0), ctx=ctx)
        assert not dkern_facet_tables(ctx["geo"], ctx["btab"])["two_sided"] and cfg.tris.shape[0] == 48
        N, _, rows, has = aim_at_rough_facets(pool, ctx["dom"], ctx["geo"], ctx["btab"])
        covered = (ctx["btab"]._host["corr"] >= 0).any(axis=1)
        assert covered.sum() == 4 and not has[~covered[rows]].any()
    assert has.any() and (~has).any()
    if eta0:
        facets = cfg.facets.clone()
        facets[:, FT_ETA] = 0.0
        cfg = dataclasses.replace(cfg, facets=facets)
    pk, pp = pool.clone(), pool.clone()
    rk, ik, ck, lk, bk = drift_megastep(pk, T_sv, rta_on, cfg, seed=5)
    rp, ip, cp, lp, bp = drift_megastep_plain(pp, T_sv, rta_on, cfg, seed=5)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp) and int(cp[3]) > 0, (ck, cp)
    ints = INT_ROWS[:-1]
    for r in ints:
        assert torch.equal(_bits(pk[r]), _bits(pp[r])), r
    _close_rows(pk, pp, FLOAT_ROWS[:-1])
    k = int(cp[2])
    assert torch.equal(ik, ip)
    for r in ints:
        assert torch.equal(_bits(rk[r, :k]), _bits(rp[r, :k])), r
    if eta0:
        ex = np.zeros(pool.shape[1], bool)
        ex[ik[:k].cpu().numpy()] = True
        assert ex[:N][has].all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fixed_rate lattice", "one_to_one blocks"])
def test_cuda_compact_new_reservoir_widths(cuda, name):
    """Kernel C at the two reservoir schemes' widths on the 1e6-particle
    film: the 'fixed_rate' (c_max, R*M) = (3, 2 x 178,746) lattice into
    inj_cap, and the 'one_to_one' (R, inj_cap // R) blocks, each a valid
    prefix, into inj_cap: bit-exact, one launch a call."""
    from nanokappa_torch.ops import compact

    g = torch.Generator().manual_seed(3)
    if name == "fixed_rate lattice":
        m, cap = torch.rand(1_072_476, generator=g) < 0.0036, 5120
    else:
        cap = 5120
        per = cap // 2
        lane = torch.arange(2 * per)
        m = (lane % per) < torch.tensor([1830, 2611])[lane // per]  # the second block clips
    m = m.to(cuda)
    before = compact.launches
    idx, nv = compact.compact_indices(m, cap)
    assert compact.launches == before + 1
    ref, rn = _compact_ref(m, cap)
    assert torch.equal(idx.cpu(), ref) and int(nv) == int(rn)


# the narrow rounds' crafted buffers (tests/torch_parity.py narrow_case /
# narrow_rows): (case keywords, rows keywords); each exercises a part of the
# round that the others may miss
NARROW = {
    # reservoirs, periodic pair, eta = 0 mirror rows and no-partner modes
    # (diffuse), a tenth of the rough lanes flagged by kernel A
    "film": (dict(), dict(n_live=300)),
    # eta = 2 A walls (the Bernoulli decides), linear temperatures, a dt whose
    # reciprocal is inexact, and lanes leaving their wall, with the box's two
    # rough rows swapped for the back rows
    "rough_linear_back": (dict(domain_kw=ROUGH_BOX, temp_interp="linear", dt=0.7),
                          dict(n_live=400, back=0.3, seed=1)),
    # the k model: specular lanes swap to their equal-frequency partner
    "kmodel": (dict(scat_model="k"), dict(n_live=600, seed=2)),
    # long flights: chains through rounds 2+, two lanes stuck at k_max
    "chains": (dict(dt=150.0), dict(n_live=400, seed=3)),
    # every lane live: more survivors than the 512-lane buffer, k_max = 3
    "stuck_overflow": (dict(dt=400.0, k_max=3), dict(n_live=2048, seed=4)),
    # no round 2+: round 1's survivors are stuck
    "k_max1": (dict(dt=150.0, k_max=1), dict(n_live=300, seed=5)),
}


def _narrow_case(cuda, name):
    import dataclasses

    from torch_parity import narrow_case, narrow_rows

    case_kw, rows_kw = NARROW[name]
    case = narrow_case(cuda, **case_kw)
    if rows_kw.get("back"):
        btab = dataclasses.replace(case.btab, row_back=case.btab.row_of_rough.flip(0).contiguous())
        object.__setattr__(btab, "_host", case.btab._host)
        case.btab = btab
    rows, vbuf = narrow_rows(case, **rows_kw)
    return case, rows, vbuf


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(NARROW))
def test_cuda_event_round_matches_plain(cuda, name, monkeypatch):
    """Kernel F against the torch rounds on one crafted 2,048-lane buffer
    and one generator seed: every lane's 16 rows bit for bit, the counts
    exact, the ledger to float32 rounding, the generator's state equal
    after the call, the input rows untouched, one launch a round (and one
    more where the rounds reach k_max: the quarantine)."""
    from nanokappa_torch.ops import event_round
    from nanokappa_torch.sim import cascade

    case, rows, vbuf = _narrow_case(cuda, name)
    tabs = event_round.round_tables(case.geo, case.tabs, case.btab, case.params)
    rounds = [0]
    plain_round = cascade._event_round

    def counted(*a, **k):
        rounds[0] += 1
        return plain_round(*a, **k)

    args = (case.geo, case.tabs, case.btab, case.params)
    rows0 = rows.clone()
    gk = torch.Generator(device=cuda).manual_seed(11)
    gp = torch.Generator(device=cuda).manual_seed(11)
    before = event_round.launches
    ok, lk, *ck = cascade.run_event_buffer(rows, vbuf, *args, gk, case.T_sv, 8, kernel=tabs)
    launched = event_round.launches - before
    monkeypatch.setattr(cascade, "_event_round", counted)
    op, lp, *cp = cascade.run_event_buffer(rows, vbuf, *args, gp, case.T_sv, 8)
    torch.cuda.synchronize()
    assert torch.equal(_bits(rows), _bits(rows0))
    assert torch.equal(_bits(ok), _bits(op))
    assert [int(x) for x in ck] == [int(x) for x in cp]
    assert [x.dtype for x in ck] == [x.dtype for x in cp]
    assert torch.equal(gk.get_state(), gp.get_state())
    k_max = case.params.k_max
    assert launched == rounds[0] + int(k_max <= 1 or rounds[0] >= k_max)
    a, b = lk.double().cpu(), lp.double().cpu()
    scale = b.abs().sum(0, keepdim=True)
    assert bool(((a - b).abs() <= 1e-6 * b.abs() + 1e-6 * scale).all()), (a, b)
    stuck, lost, frozen, swaps = (int(x) for x in cp)
    want = {"chains": stuck > 0 and rounds[0] > 2, "stuck_overflow": stuck > 0 and frozen > 0,
            "kmodel": swaps > 0, "k_max1": stuck > 0}
    assert want.get(name, True), (name, cp, rounds)


@pytest.mark.gpu
def test_cuda_event_round_film_steps_match_plain(cuda, monkeypatch):
    """The film's v2 step with its narrow rounds on kernel F and on the
    torch rounds, from one state, three single steps with long flights (so
    kernel A exports): the pool bit for bit after each, the same counts."""
    import dataclasses

    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.ops import event_round
    from nanokappa_torch.ops.compact_pool import compact_pool_plain
    from nanokappa_torch.sim import fused
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.reservoir import build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count
    from torch_parity import FILM

    mat = synthetic_material(mesh=(4, 4, 4))
    dom = build_domain(**FILM)
    n_p, rho = particle_count(("total", 3000), mat, dom)
    params = SimParams(
        dt=40.0, n_cap=16384, inj_cap=512, temp_interp="nearest", res_gen="pooled",
        particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0,
    )
    geo = build_device_geometry(dom, cuda)
    btab = build_boundary_tables(mat, dom, device=cuda)
    rtab = build_reservoir_tables(mat, dom, params.dt, rho, device=cuda)
    tabs = mat.device_tables(cuda)
    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=3)
    state.pool, tail = compact_pool_plain(state.pool)  # the runner's entry compaction
    state.tail = int(tail)
    step_k = fused.make_step_v2(geo, tabs, btab, rtab, params)
    monkeypatch.setattr(event_round, "covers", lambda geo, params: False)
    step_p = fused.make_step_v2(geo, tabs, btab, rtab, params)

    def copy(s):
        g = torch.Generator(device=cuda)
        g.set_state(s.gen.get_state())
        kw = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
        kw = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
        return dataclasses.replace(s, **{**kw, "res_counter": s.res_counter.copy(), "gen": g})

    exported = 0
    for _ in range(3):
        sk, sp = copy(state), copy(state)
        before = event_round.launches
        step_k(sk)
        assert event_round.launches > before
        step_p(sp)
        assert torch.equal(_bits(sk.pool), _bits(sp.pool)) and sk.tail == sp.tail
        for f in ("n_leaving", "lost", "frozen", "kernel_events"):
            assert torch.equal(getattr(sk, f), getattr(sp, f)), f
        exported += int(sk.kernel_events[3] - state.kernel_events[3])
        state = sk
    assert exported > 0
