"""The port's v1 step, module by module, against the JAX package on the CPU.

  * `run_cascade` (the JAX function's twin on the port, defined here: the
    stale lanes' cast, the full-width drift, the event compaction through
    kernel C's twin, the narrow machinery, the merge through kernel D's
    twin, the tallies settled) against the JAX one from one converted state
    and one stale set, on a box with T and P facets only (absorption and
    periodic translation: no random draw decides anything): the pool's
    int rows and liveness equal, its float rows to float32 rounding
    (rtol 1e-6 plus 1e-6 of the row's scale), the ledgers to rtol 1e-5;
  * `rbf_interp` against `_rbf_interp` on 12 random centres: within the
    JAX test's own atol 1e-2 K (the JAX package solves its system in
    float32), and against scipy's cubic RBFInterpolator within 1e-4 K (the
    port solves and evaluates in float64);
  * `bin_all` (the JAX function's twin on the port, defined here: the v1
    step's bin_sums and the steps' normalize_bins) against the JAX one,
    rtol 1e-5;
  * `_raycast_broadcast` on a 300-triangle mesh, called directly: the
    facet equal, t to rtol 1e-5 (XLA's dot products round otherwise), and
    bit-equal to the one-chunk cast on rays aimed at vertices (the tie
    rule);
  * routing: radial, linear on voronoi, 513 slices, 257 centres and 8
    reservoirs run the v1 step (the route, sim/fused.py build_route), with
    the JAX package's reason, and a step builds; items 5, 10 and 12 are
    admitted.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_parity import build_pair, np_

# a box with T reservoirs on x and periodic pairs on y and z
TP_BOX = dict(
    geometry="box",
    dimensions=(2e3, 1e3, 1e3),
    subvolumes=("slice", 5, 0),
    bound_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5),
    bound_cond=("T", "T", "P"),
    bound_values=(302.0, 298.0),
    connect_pos=("relative", 0.5, -0.1, 0.5, 0.5, 1.1, 0.5, 0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
)
INT_COLS = [9, 10, 12, 15]  # mode, coll facet, on facet, subvolume


def run_cascade(state, stale_idx, geo, mat, btab, params, gen):
    """nanokappa_tpu/sim/cascade.py run_cascade on the port: the v1
    step's drift + boundary cascade on the plain pool, IN PLACE, its
    tallies settled into the state's ledgers."""
    from nanokappa_torch.sim.cascade import cascade_tallies, settle_cascade

    return settle_cascade(state, geo.n_reservoirs, *cascade_tallies(state, stale_idx, geo, mat, btab, params, gen))


def bin_all(geo, mat, energies, vel, sv, alive, energy_normal, particle_density):
    """nanokappa_tpu/sim/binning.py bin_all on the port: (E_dev_sv, phi_sv
    in eV/ps/A^2, Np_sv) of the particles."""
    from nanokappa_torch.sim.binning import bin_sums, normalize_bins

    return normalize_bins(geo, mat, bin_sums(geo, energies, vel, sv, alive), energy_normal, particle_density)


def test_run_cascade_matches_jax():
    import jax
    import jax.numpy as jnp

    from nanokappa_tpu.sim.cascade import run_cascade as j_cascade
    from nanokappa_tpu.sim.state import SimState as JState
    from nanokappa_torch.constants import HBAR
    from nanokappa_torch.convert import state_from_jax, state_to_jax
    from nanokappa_torch.geometry.domain import BC
    from nanokappa_torch.material.tables import bose_einstein
    from nanokappa_torch.sim.state import C_CF, C_REM, STALE

    j, t = build_pair(TP_BOX, mesh=(4, 4, 4), n_p=3000, n_cap=4096, inj_cap=512,
                      step_impl="v1", res_gen="constant")
    bc = np_(t.geo.facet_bc)
    assert set(bc.tolist()) <= {int(BC.TEMPERATURE), int(BC.PERIODIC)}
    # one stale set: 300 alive lanes made fresh (STALE, a partial dt left),
    # as injections arrive
    d = state_to_jax(t.state, v1=True)
    rng = np.random.default_rng(1)
    alive = np.nonzero(d["packed"][:, 14] > 0.5)[0]
    stale = np.sort(rng.choice(alive, 300, replace=False)).astype(np.int32)
    d["packed"][stale, C_CF] = np.int32(STALE).view(np.float32)
    d["packed"][stale, C_REM] = rng.random(300).astype(np.float32)
    stale_idx = np.full(512, 4096, np.int32)
    stale_idx[:300] = stale

    js = JState(**{k: jnp.asarray(v) for k, v in d.items()}, key=jax.random.PRNGKey(0))
    jout = j_cascade(js, jnp.asarray(stale_idx), j.geo, j.tabs, j.btab, j.params, jax.random.PRNGKey(1))
    ts = state_from_jax(d, "plain", device="cpu", v1=True)
    # the v1 state's free list both ways: the tail past the last alive lane
    assert ts.tail == int(np.nonzero(d["packed"][:, 14] > 0.5)[0][-1]) + 1
    back = state_to_jax(ts, v1=True)
    for k in ("packed", "free_list", "free_count"):
        np.testing.assert_array_equal(back[k].view(np.int32), d[k].view(np.int32), err_msg=k)
    run_cascade(ts, torch.as_tensor(stale_idx), t.geo, t.tabs, t.btab, t.params, torch.Generator().manual_seed(1))

    want = np.asarray(jout.packed)
    got = np_(ts.pool).T
    np.testing.assert_array_equal(got[:, INT_COLS].view(np.int32), want[:, INT_COLS].view(np.int32))
    np.testing.assert_array_equal(got[:, 14], want[:, 14])
    for c in [0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 13]:
        x, y = got[:, c].astype(np.float64), want[:, c].astype(np.float64)
        fin = np.isfinite(y)
        np.testing.assert_array_equal(np.isfinite(x), fin)
        np.testing.assert_allclose(x[fin], y[fin], rtol=1e-6, atol=1e-6 * np.abs(y[fin]).max(), err_msg=f"col {c}")
    assert (got[:, 14] < 0.5).sum() > (d["packed"][:, 14] < 0.5).sum()  # some lanes absorbed
    np.testing.assert_array_equal(np_(ts.n_leaving), np.asarray(jout.n_leaving))
    assert np_(ts.n_leaving).sum() > 0
    # the ledgers sum signed terms that cancel: rtol 1e-5 of the absorbed
    # lanes' sums of |e| and |e v / v.n| (e = hbar omega dn) bounds float32
    # sums in another order
    gone = (d["packed"][:, 14] > 0.5) & (want[:, 14] < 0.5)
    rows = d["packed"][gone].astype(np.float64)
    om, dev, vel = rows[:, 6], rows[:, 8], rows[:, 3:6]
    dn_res = np.maximum(*(np.abs(bose_einstein(T, om) - bose_einstein(300.0, om)) for T in (302.0, 298.0)))
    e_abs = HBAR * om * (np.abs(dev) + dn_res)
    normal = np_(t.geo.facet_normal)[want[gone, 10].view(np.int32)]
    vn = np.maximum(np.abs((vel * normal).sum(1)), 1e-3 * np.linalg.norm(vel, axis=1))
    np.testing.assert_allclose(np_(ts.res_energy_balance), np.asarray(jout.res_energy_balance),
                               rtol=1e-5, atol=1e-5 * e_abs.sum())
    hf, jhf = np_(ts.res_heat_flux).astype(np.float64), np.asarray(jout.res_heat_flux, np.float64)
    lim = 1e-5 * np.abs(jhf) + 1e-5 * (e_abs[:, None] * np.abs(vel) / vn[:, None]).sum(0)
    assert (np.abs(hf - jhf) <= lim).all(), (hf - jhf, lim)
    np.testing.assert_array_equal(np_(ts.lost), np.asarray(jout.lost))
    assert int(ts.frozen) == int(jout.frozen)


def test_rbf_interp_matches_jax_and_scipy():
    import jax.numpy as jnp
    from scipy.interpolate import RBFInterpolator

    from nanokappa_tpu.sim.binning import _rbf_interp
    from nanokappa_torch.sim.binning import rbf_interp

    rng = np.random.default_rng(0)
    scale = np.array([5000.0, 800.0, 400.0])
    c = (rng.random((12, 3)) * scale).astype(np.float32)
    v = (295.0 + 10.0 * rng.random(12)).astype(np.float32)
    x = (rng.random((4000, 3)) * scale).astype(np.float32)
    got = np_(rbf_interp(torch.as_tensor(c), torch.as_tensor(v), torch.as_tensor(x)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(_rbf_interp(jnp.asarray(c), jnp.asarray(v), jnp.asarray(x))),
                               atol=1e-2)
    ref = RBFInterpolator(c.astype(np.float64), v.astype(np.float64), kernel="cubic")(x.astype(np.float64))
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # the interpolant passes through the centres
    np.testing.assert_allclose(np_(rbf_interp(torch.as_tensor(c), torch.as_tensor(v), torch.as_tensor(c))), v,
                               atol=1e-4)


@pytest.mark.parametrize("normal", ["mean", "fixed"])
def test_bin_all_matches_jax(normal):
    import jax.numpy as jnp

    from nanokappa_tpu.sim.binning import bin_all as j_bin_all

    j, t = build_pair(mesh=(4, 4, 4))
    rng = np.random.default_rng(2)
    n = 5000
    e = rng.normal(size=n).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 30
    sv = rng.integers(0, 5, n).astype(np.int32)
    alive = rng.random(n) < 0.8
    rho = float(t.params.particle_density)
    got = bin_all(t.geo, t.tabs, *(torch.as_tensor(a) for a in (e, vel, sv, alive)), normal, rho)
    want = j_bin_all(j.geo, j.tabs, *(jnp.asarray(a) for a in (e, vel, sv, alive)), normal, rho)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=1e-5, atol=1e-5 * np.abs(np.asarray(w)).max())
    np.testing.assert_array_equal(np_(got[2]), np.asarray(want[2]))


def test_raycast_broadcast_300_triangles_matches_jax():
    """The chunked dense cast (two chunks here) against JAX's
    `_raycast_broadcast` on rays from inside the mesh: the facet exact, t
    to rtol 1e-5 plus 1e-5 ps (XLA sums its dot products in another order,
    as tests/test_torch_wire_cast.py allows). Rays aimed at vertices hit
    several triangles at t equal to a few ulps, where either rounding picks
    its own winner: they are held against the port's one-chunk cast, whose
    first-triangle rule the running minimum's strict `<` across chunks
    keeps (the JAX scan's rule), bit for bit."""
    import jax.numpy as jnp

    from nanokappa_tpu.ops.raycast import _raycast_broadcast as j_broadcast
    from nanokappa_torch.geometry.primitives import make_primitive
    from nanokappa_torch.ops.raycast import _raycast_broadcast, tri_cast, tri_table

    mesh = make_primitive("cylinder", (4e3, 500.0, 75))
    tri = mesh.vertices[mesh.faces].astype(np.float32)  # (F, 3, 3)
    F = tri.shape[0]
    assert F == 300
    fac = np.arange(F, dtype=np.int32) // 2  # two triangles a facet
    geo_t = SimpleNamespace(tri_origin=torch.as_tensor(tri[:, 0]), tri_e1=torch.as_tensor(tri[:, 1] - tri[:, 0]),
                            tri_e2=torch.as_tensor(tri[:, 2] - tri[:, 0]), tri_facet=torch.as_tensor(fac))
    geo_j = SimpleNamespace(**{k: jnp.asarray(np_(v)) for k, v in vars(geo_t).items()})
    rng = np.random.default_rng(3)
    n = 3000
    pos = mesh.sample_volume(n, rng).astype(np.float32)
    d = rng.normal(size=(n, 3))
    vel = (d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(10, 80, (n, 1))).astype(np.float32)
    exclude = rng.integers(-1, F // 2, n).astype(np.int32)
    t, f = _raycast_broadcast(geo_t, *(torch.as_tensor(a) for a in (pos, vel, exclude)))
    jt, jf = (np.asarray(a) for a in j_broadcast(geo_j, *(jnp.asarray(a) for a in (pos, vel, exclude))))
    np.testing.assert_array_equal(np_(f), jf)
    fin = np.isfinite(jt)
    np.testing.assert_array_equal(np.isfinite(np_(t)), fin)
    np.testing.assert_allclose(np_(t)[fin], jt[fin], rtol=1e-5, atol=1e-5)
    assert fin.mean() > 0.8

    aim = tri[rng.integers(0, F, n), rng.integers(0, 3, n)]
    vel = torch.as_tensor((aim - pos) / 5.0)
    p, e = torch.as_tensor(pos), torch.as_tensor(exclude)
    t, f = _raycast_broadcast(geo_t, p, vel, e)
    t1, f1 = tri_cast(tri_table(geo_t), [p[:, k] for k in range(3)], [vel[:, k] for k in range(3)], e)
    assert torch.equal(t, t1) and torch.equal(f, f1)
    assert (np_(f) >= 0).mean() > 0.8


def _gate_geo(**kw):
    g = dict(is_box=True, tri_origin=torch.zeros((12, 3)), subvol_type="voronoi", n_subvols=8,
             n_reservoirs=2, n_facets=0, volume=0.0)
    g.update(kw)
    return SimpleNamespace(**g)


@pytest.mark.parametrize("geo_kw, params_kw", [
    ({}, dict(temp_interp="radial")),
    ({}, dict(temp_interp="linear")),
    (dict(subvol_type="slice", n_subvols=513), {}),
    (dict(n_subvols=257), {}),
    (dict(n_reservoirs=8), {}),
    (dict(is_box=False, tri_origin=torch.zeros((65_537, 3))), {}),
    ({}, dict(step_impl="v1")),
], ids=["radial", "voronoi_linear", "slice513", "voronoi257", "reservoirs8", "triangles65537", "forced_v1"])
def test_v1_routing_matches_jax(geo_kw, params_kw):
    from nanokappa_tpu.sim.fused import v2_fallback_reason as j_reason
    from nanokappa_tpu.sim.state import SimParams as JParams
    from nanokappa_torch.sim.fused import build_route, v2_fallback_reason
    from nanokappa_torch.sim.state import SimParams
    from nanokappa_torch.sim.step import build_step

    common = dict(dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="pooled")
    params = dataclasses.replace(SimParams(**common), **params_kw)
    jparams = dataclasses.replace(JParams(**common), **params_kw)
    geo = _gate_geo(**geo_kw)
    reason = v2_fallback_reason(geo, params)
    assert reason is not None and reason == j_reason(geo, jparams)
    route = build_route(geo, None, params, None)
    assert (route.step, route.v1_reason, route.layout) == ("v1", reason, "plain")
    assert callable(build_step(geo, None, None, None, params, n_inner=10))


def test_v2_admits_the_fused_configurations():
    """The fused step's envelope: nearest voronoi, linear slices, a box;
    "auto" takes it on the CPU too (where the JAX package falls back)."""
    from nanokappa_torch.sim.fused import build_route
    from nanokappa_torch.sim.state import SimParams

    params = SimParams(dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="pooled")
    assert build_route(_gate_geo(), None, params, None).step == "v2"
    assert build_route(_gate_geo(subvol_type="slice", n_subvols=512), None,
                       dataclasses.replace(params, temp_interp="linear"), None).step == "v2"
    assert build_route(_gate_geo(), None, dataclasses.replace(params, n_cap=5000), None).step == "v1"  # no kernel tile


@pytest.mark.parametrize("params_kw, item, dkern", [
    (dict(res_gen="fixed_rate"), 5, False),
    (dict(res_gen="one_to_one", temp_interp="radial"), 5, False),
    (dict(n_shards=2), 12, False),
    (dict(n_shards=2, temp_interp="radial"), 12, False),
    ({}, 10, True),
], ids=["fixed_rate", "one_to_one_v1", "shards", "shards_v1", "rows33"])
def test_items_5_10_12_still_raise(params_kw, item, dkern, monkeypatch):
    """Items 5 (the 'fixed_rate' and 'one_to_one' reservoirs), 10 (more
    than 32 rough-wall table rows with in-kernel diffuse reflection: kernel
    A's partner mask takes ceil(rows / 32) words) and 12 (particle shards,
    parallel/sharding.py) are ported: admitted, on the v1 step where the
    configuration is not v2-eligible (the name is kept from when all three
    raised)."""
    from nanokappa_torch.sim import fused
    from nanokappa_torch.sim.state import SimParams
    from nanokappa_torch.sim.step import make_step

    monkeypatch.setattr(fused, "_dkern", lambda *a, **k: dkern)
    params = dataclasses.replace(
        SimParams(dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="pooled"), **params_kw
    )
    route = fused.build_route(_gate_geo(), SimpleNamespace(n_rows=33), params, None)
    assert route.dkern == (dkern and route.step == "v2")
    if route.step == "v1":
        assert callable(make_step(_gate_geo(), None, SimpleNamespace(n_rows=33), None, params))
    # 33 rows on the v1 step: no kernel A, nothing to refuse
    assert fused.build_route(_gate_geo(), SimpleNamespace(n_rows=33), dataclasses.replace(
        params, res_gen="pooled", n_shards=1, temp_interp="radial"), None).step == "v1"