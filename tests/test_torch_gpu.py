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


def _film(device):
    """The 4^3 film (T/T/R/R/P, eta = 0) in the port, its pool compacted,
    5% of the lanes STALE and a third without a mirror partner."""
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
    pool, _ = compact_pool_plain(state.pool)
    alive = torch.nonzero(pool[14] > 0.5).flatten()
    pool[10, alive[::20]] = torch.tensor(-2, dtype=torch.int32, device=device).view(torch.float32)
    pool[16, alive[1::3]] = torch.tensor(-1, dtype=torch.int32, device=device).view(torch.float32)
    cfg = mega_config(
        geo, mat.device_tables(device), btab, params,
        autosize_evt_cap(geo, mat.device_tables(device), params, True, 4096), flip_axis=2,
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


def _plain_pool(device, domain_kw):
    """A mirror-off configuration (rough eta > 0 walls: the "plain" pool with
    in-kernel diffuse reflection) at 4^3, its pool compacted, 5% STALE."""
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.ops.compact_pool import compact_pool_plain
    from nanokappa_torch.ops.megastep import mega_config
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.fused import event_window
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count

    mat = synthetic_material(mesh=(4, 4, 4))
    dom = build_domain(**domain_kw)
    n_p, rho = particle_count(("total", 3000), mat, dom)
    params = SimParams(
        dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="constant",
        particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0,
    )
    geo = build_device_geometry(dom, device)
    btab = build_boundary_tables(mat, dom, device=device)
    tabs = mat.device_tables(device)
    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=3)
    assert state.layout == "plain"
    pool, _ = compact_pool_plain(state.pool)
    alive = torch.nonzero(pool[14] > 0.5).flatten()
    pool[10, alive[::20]] = torch.tensor(-2, dtype=torch.int32, device=device).view(torch.float32)
    cfg = mega_config(geo, tabs, btab, params, event_window(geo, tabs, btab, params))
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
