"""Grid and voronoi subvolumes: the port's nearest-centre classifier against
the JAX package's, on the film box with 8 Voronoi centres (inside the JAX
kernel's 32-centre unroll) and with a 10 x 2 x 2 grid (40 centres, its
SMEM table walk).

  * `sim/binning.py:subvol_id` against the XLA classifier
    (nanokappa_tpu/sim/binning.py:29-40, a float32 matmul) on random lanes
    and on lanes placed on the bisector planes between centres;
  * kernel A's nearest-centre branch (its plain twin on the CPU; the CUDA
    kernel is held against the twin bit for bit by tests/test_torch_gpu.py)
    against the Pallas kernel in interpret mode, on the film's slim pool:
    `check_branch_against_pallas`, run by tests/test_torch_subvol_kernel.py
    (8 centres) and tests/test_torch_subvol_walk.py (40 centres), one
    Pallas compile per file;
  * `sim/fused.py:build_route` admits grid and voronoi up to 256
    centres, linear T on slices and the k model off the mirror path, and
    names the ROADMAP item of every configuration it still refuses.

The three classifiers round |c|^2 - 2 q.c differently (the port folds |c|^2
in float64 once, the JAX kernel does that up to 32 centres and sums in
float32 beyond, the XLA path takes a matmul), so an id may differ only at a
near-tie: a lane whose two smallest float64 distances differ by less than
1e-5 of the largest |c|^2. Random lanes differ in at most 1e-4 of cases.
Pool rows of the other lanes: int rows exact, floats rtol 2e-5 (the JAX
kernel's Taylor expm1 twin, tests/test_torch_megastep.py).

The Lloyd iteration and the Monte Carlo volume split cost a minute of CPU
on a box, so both packages take the fixed centres and equal volumes
(`patched_domains`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import FILM, build_pair, np_

# 8 Voronoi centres in the 2000 x 1000 x 1000 A film box
BOX8 = np.array([
    [310.0, 240.0, 260.0], [420.0, 760.0, 720.0], [760.0, 300.0, 690.0],
    [980.0, 710.0, 280.0], [1190.0, 260.0, 330.0], [1330.0, 690.0, 760.0],
    [1580.0, 350.0, 610.0], [1720.0, 780.0, 300.0],
])
CASES = {
    "voronoi8": dict(FILM, subvolumes=("voronoi", 8)),
    "grid40": dict(FILM, subvolumes=("grid", 10, 2, 2)),
}
FLOAT_ROWS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 13, 17]
INT_ROWS = [9, 10, 12, 14, 16]  # mode, facet, on-facet, alive, partner


def patched_domains(mp):
    """Both packages' build_domain take BOX8 for a Voronoi split and
    equal volumes for every split (the box's cells; 'mean' energy
    normalisation never reads them)."""
    from nanokappa_torch.geometry import domain as t_dom, subvolumes as t_sub
    from nanokappa_tpu.geometry import domain as j_dom, subvolumes as j_sub

    for sub in (t_sub, j_sub):
        mp.setattr(sub, "lloyd_centers", lambda mesh, n, rng=None, **k: BOX8[:n].copy())
    for dom in (t_dom, j_dom):
        mp.setattr(dom, "_mc_subvol_volume",
                   lambda mesh, c, rng, **k: np.full(len(c), mesh.volume / len(c)))


def build_centre_pair(case: str):
    """The film box split by CASES[case] in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        patched_domains(mp)
        j, t = build_pair(CASES[case], n_p=1500, n_cap=2048)
    assert t.geo.subvol_type != "slice"
    return j, t


@pytest.fixture(scope="module", params=sorted(CASES))
def centre_pair(request):
    return build_centre_pair(request.param)


def dist64(pos, centers):
    """(N, SV) float64 squared distances."""
    p, c = np.asarray(pos, np.float64), np.asarray(centers, np.float64)
    return ((p[:, None, :] - c[None]) ** 2).sum(-1)


def near_tie(pos, centers):
    """Lanes whose two smallest float64 distances differ by less than 1e-5
    of the largest |c|^2."""
    d = np.sort(dist64(pos, centers), axis=1)
    c = np.asarray(centers, np.float64)
    return (d[:, 1] - d[:, 0]) < 1e-5 * float((c * c).sum(1).max())


def bisector_points(rng, centers, n):
    """n points on the bisector planes of random pairs of nearby centres,
    jittered inside the plane."""
    c = np.asarray(centers, np.float64)
    a = rng.integers(0, len(c), n)
    d = dist64(c[a], c)
    d[np.arange(n), a] = np.inf
    b = np.argsort(d, axis=1)[:, rng.integers(0, 2)]  # the nearest or the next
    mid = 0.5 * (c[a] + c[b])
    u = c[b] - c[a]
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    j = rng.normal(0.0, 30.0, (n, 3))
    j -= (j * u).sum(1, keepdims=True) * u
    return mid + j


def test_subvol_id_matches_xla_classifier(centre_pair):
    import jax.numpy as jnp

    from nanokappa_tpu.sim.binning import subvol_id as j_subvol_id
    from nanokappa_torch.sim.binning import subvol_id

    j, t = centre_pair
    rng = np.random.default_rng(7)
    lo, hi = t.dom.mesh.bounds
    centers = np_(t.geo.subvol_center)
    for pos, is_random in (
        (rng.uniform(lo, hi, (100_000, 3)), True),
        (np.clip(bisector_points(rng, centers, 20_000), lo, hi), False),
    ):
        pos = pos.astype(np.float32)
        ids = np_(subvol_id(t.geo, torch.as_tensor(pos)))
        jids = np.asarray(j_subvol_id(j.geo, jnp.asarray(pos)))
        truth = np.argmin(dist64(pos, centers), axis=1)
        tie = near_tie(pos, centers)
        for other in (jids, truth):
            bad = ids != other
            assert not (bad & ~tie).any(), (np.nonzero(bad & ~tie)[0][:5], bad.sum())
            if is_random:
                assert bad.mean() <= 1e-4, bad.mean()
        if not is_random:
            assert tie.mean() > 0.5  # the bisector lanes really are near-ties


def _energy_bins(pool, lanes, T_sv, sv8):
    """Per-subvolume [e, e vx, e vy, e vz, 1] of the given alive lanes."""
    from nanokappa_torch.constants import HBAR
    from nanokappa_torch.sim.bose import occupation_delta_T

    p = torch.as_tensor(pool[:, lanes & (pool[14] > 0.5)])
    sv = p[15].contiguous().view(torch.int32).long()
    e = (HBAR * p[6] * (p[8] - occupation_delta_T(T_sv[sv], 300.0, p[6]))).double()
    vals = torch.stack([e, e * p[3], e * p[4], e * p[5], torch.ones_like(e)], 1)
    out = torch.zeros((sv8, 5), dtype=torch.float64)
    out.index_add_(0, sv, vals)
    return out.numpy()


def check_branch_against_pallas(j, t):
    """Kernel A's nearest-centre branch (the port's twin) against the
    Pallas kernel on the pair's slim pool, a tenth of the lanes moved onto
    bisector planes."""
    import jax.numpy as jnp

    from nanokappa_tpu.ops.compact_pool import compact_pool
    from nanokappa_tpu.ops.megastep import drift_megastep as j_drift
    from nanokappa_tpu.sim.fused import to_transposed
    from nanokappa_torch.ops.megastep import SV_CENTER, drift_megastep, mega_config
    from nanokappa_torch.sim.fused import autosize_evt_cap

    stT = to_transposed(j.state, combined=True, slim=True)
    pool3, _, _ = compact_pool(stT.packed, None, interpret=True)
    pool = np.array(pool3).reshape(18, -1)
    N = pool.shape[1]
    alive = np.nonzero(pool[14] > 0.5)[0]
    pool[10, alive[::20]] = np.array(-2, np.int32).view(np.float32)
    pool[16, alive[1::3]] = np.array(-1, np.int32).view(np.float32)
    centers = np_(t.geo.subvol_center)
    rng = np.random.default_rng(11)
    moved = alive[5::10]
    lo, hi = t.dom.mesh.bounds
    pool[0:3, moved] = np.clip(bisector_points(rng, centers, len(moved)), lo + 1.0, hi - 1.0).T
    # a temperature per centre that varies across the box
    T_sv = (302.0 - 4.0 * (centers[:, 0] - lo[0]) / (hi[0] - lo[0])).astype(np.float32)
    T_sv = T_sv + 0.05 * np.arange(len(centers), dtype=np.float32)

    ecap = autosize_evt_cap(t.geo, t.tabs, t.params, True, N)
    tau_T = np_(t.tabs.tau_T)
    L = N // 8
    jp, jrows, ecnt, acnt, _s, kept, jled, jbins = j_drift(
        jnp.asarray(pool.reshape(18, N // L, L)), jnp.asarray(T_sv), jnp.asarray(1),
        j.geo, j.params, ecap=ecap, interpret=True, export_rows=True,
        w_exp=min(256, ecap), tau_bounds=(float(tau_T[0]), float(tau_T[-1])),
    )
    jp = np.asarray(jp).reshape(18, N)
    cfg = mega_config(t.geo, t.tabs, t.btab, t.params, ecap, flip_axis=2)
    assert cfg.sv_mode == SV_CENTER and cfg.layout == "slim"
    tp = torch.as_tensor(pool.copy())
    rows, _, counts, led, bins = drift_megastep(tp, torch.as_tensor(T_sv), True, cfg)
    tp = np_(tp)

    # near-ties before the drift (the deferred RTA's temperature) or after
    # it (the lane's new subvolume) may classify differently
    tie = near_tie(pool[0:3].T, centers) | near_tie(tp[0:3].T, centers)
    live = pool[14] > 0.5
    sv_t, sv_j = tp[15].view(np.int32), jp[15].view(np.int32)
    diff = live & (sv_t != sv_j)
    assert not (diff & ~tie).any(), np.nonzero(diff & ~tie)[0][:5]
    unmoved = np.ones(N, bool)
    unmoved[moved] = False
    assert (diff & unmoved).sum() <= 1e-4 * (live & unmoved).sum()  # random lanes
    quiet = ~tie
    for r in INT_ROWS + [15]:
        np.testing.assert_array_equal(tp[r, quiet].view(np.int32), jp[r, quiet].view(np.int32), err_msg=f"row {r}")
    for r in FLOAT_ROWS:
        x, y = tp[r, quiet].astype(np.float64), jp[r, quiet].astype(np.float64)
        fin = np.isfinite(y)
        np.testing.assert_array_equal(np.isfinite(x), fin, err_msg=f"row {r}")
        scale = np.abs(y[fin]).max(initial=0.0)
        np.testing.assert_allclose(x[fin], y[fin], rtol=2e-5, atol=2e-5 * scale, err_msg=f"row {r}")
    k = int(np.asarray(kept).sum())
    assert counts.tolist() == [int(np.asarray(ecnt).sum()), int(np.asarray(acnt).sum()), k, 0, 0]
    # the subvolume sums of the lanes away from a tie, and the ledger
    sv8 = cfg.sv8
    Tt = torch.as_tensor(T_sv)
    a = np_(bins).astype(np.float64) - _energy_bins(tp, tie, Tt, sv8)
    b = np.asarray(jbins, np.float64) - _energy_bins(jp, tie, Tt, sv8)
    for x, y in ((a, b), (np_(led).astype(np.float64), np.asarray(jled, np.float64))):
        scale = np.abs(y).sum(axis=0, keepdims=True) + np.abs(y).max()
        assert (np.abs(x - y) <= 1e-5 * np.abs(y) + 1e-5 * scale).all(), (x, y)


def _gate_geo(**kw):
    from types import SimpleNamespace

    g = dict(is_box=True, tri_origin=torch.zeros((12, 3)), subvol_type="voronoi", n_subvols=8,
             n_reservoirs=2, n_facets=0, volume=0.0)
    g.update(kw)
    return SimpleNamespace(**g)


@pytest.mark.parametrize("geo_kw, params_kw, item", [
    (dict(n_subvols=257), {}, 11),
    (dict(subvol_type="grid", n_subvols=257), {}, 11),
    ({}, dict(temp_interp="linear"), 11),
    ({}, dict(temp_interp="radial"), 11),
    (dict(subvol_type="slice", n_subvols=513), {}, 11),
    (dict(subvol_type="slice", n_subvols=5), dict(temp_interp="radial"), 11),
    (dict(n_reservoirs=8), {}, 11),
    (dict(is_box=False, tri_origin=torch.zeros((65_537, 3))), {}, 11),
    # (item 5, the 'fixed_rate' and 'one_to_one' reservoirs, is ported:
    # admitted on the fused step, 0 below)
    ({}, dict(res_gen="fixed_rate"), 0),
    ({}, dict(res_gen="one_to_one"), 0),
    # (item 12, particle shards, is ported: admitted on the fused step, 0)
    ({}, dict(n_shards=2), 0),
], ids=["voronoi257", "grid257", "voronoi_linear", "voronoi_radial", "slice513", "slice_radial",
        "reservoirs8", "triangles65537", "fixed_rate", "one_to_one", "shards2"])
def test_require_slice_names_the_item(geo_kw, params_kw, item):
    """The configurations the port still refuses raise NotImplementedError
    naming the ROADMAP item that ports them; those of item 11 (the v1 step,
    ported) are admitted and routed to the v1 step, those of item 5 (the
    reservoir schemes, ported: 0 here) admitted on the fused step."""
    from nanokappa_torch.sim.fused import build_route
    from nanokappa_torch.sim.state import SimParams

    params = SimParams(dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="pooled")
    params = dataclasses.replace(params, **params_kw)
    geo = _gate_geo(**geo_kw)
    if item in (0, 11):
        assert build_route(geo, None, params, None).step == ("v2" if item == 0 else "v1")
        return
    with pytest.raises(NotImplementedError, match=rf"item {item}\b"):
        build_route(geo, None, params, None)


@pytest.mark.parametrize("geo_kw, params_kw", [
    (dict(n_subvols=256), {}),
    (dict(subvol_type="grid", n_subvols=256), {}),
    (dict(subvol_type="slice", n_subvols=512), dict(temp_interp="linear")),
    ({}, dict(scat_model="k", res_gen="constant")),
], ids=["voronoi256", "grid256", "slice512_linear", "kmodel_off_mirror"])
def test_require_slice_admits(geo_kw, params_kw):
    from nanokappa_torch.sim.fused import build_route
    from nanokappa_torch.sim.state import SimParams

    params = SimParams(dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="pooled")
    assert build_route(_gate_geo(**geo_kw), None, dataclasses.replace(params, **params_kw), None).step == "v2"


def test_convert_carries_centres_and_state(centre_pair):
    """convert.py both ways on a centre geometry: the JAX DeviceGeometry's
    centres give the port's geometry and |c|^2 (so the same ids), and the
    JAX initial state comes back bit for bit through the port's."""
    from nanokappa_torch.convert import state_from_jax, state_to_jax, tables_from_jax
    from nanokappa_torch.geometry.device import DeviceGeometry
    from nanokappa_torch.sim.binning import subvol_id
    from torch_parity import assert_same, jax_fields

    j, t = centre_pair
    geo = tables_from_jax(DeviceGeometry, jax_fields(j.geo), device="cpu")
    assert geo.subvol_type == t.geo.subvol_type and geo.n_subvols == t.geo.n_subvols
    assert torch.equal(geo.subvol_c2, t.geo.subvol_c2)
    pos = torch.as_tensor(np.random.default_rng(2).uniform(*t.dom.mesh.bounds, (5000, 3)), dtype=torch.float32)
    assert torch.equal(subvol_id(geo, pos), subvol_id(t.geo, pos))
    for layout in ("slim", "plain"):
        s = state_from_jax(jax_fields(j.state), layout, device="cpu")
        back = state_to_jax(s, flip_axis=2)
        assert_same(back["packed"], np.asarray(j.state.packed))
        assert_same(back["sv_id"], np.asarray(j.state.sv_id))
    assert_same(state_to_jax(t.state)["packed"], np.asarray(j.state.packed))
