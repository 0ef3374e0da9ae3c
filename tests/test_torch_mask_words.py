"""Kernel A's per-mode partner mask past 32 wall-table rows
(nanokappa_torch/ops/megastep.py partner_bitmask, csrc/megastep.cu): an
(M, W) int32 table with W = ceil(rows / 32), bit r & 31 of word r >> 5 set
where the mode has a specular partner at row r. Held on the corrugated
wire of examples/corrugated_wire.txt (40 rows, two words; under the k
model a quarter of each row's modes have a partner on the 6^3 grid) and on
a crafted 70-row table (three words): the words against `corr >= 0`, and
kernel A's plain twin, which reads the mask as the kernel does, reflecting
specularly exactly where a partner exists (eta = 0 there, so p = 1) and
diffusely where none does (p = 0), on every row, rows 32-39 included."""

from types import SimpleNamespace

import numpy as np

from torch_parity import CORRUGATED, aim_at_rough_facets, np_


def _wire(mesh=(6, 6, 6)):
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables

    mat = synthetic_material(mesh=mesh)
    dom = build_domain(**CORRUGATED)
    return SimpleNamespace(
        mat=mat, dom=dom, geo=build_device_geometry(dom, device="cpu"),
        btab=build_boundary_tables(mat, dom, "k", device="cpu"), tabs=mat.device_tables("cpu"),
    )


def test_mask_words_equal_the_partner_table():
    from nanokappa_torch.ops.megastep import partner_bitmask
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables

    w = _wire()
    corr = w.btab._host["corr"]
    assert w.btab.n_rows == 40 and w.geo.tri_origin.shape[0] == 120
    assert (corr[32:] >= 0).any() and (corr[32:] < 0).any()
    # why the wire runs the k model: under the velocity model its tilted
    # walls have no specular partner (the mask would be all zeros)
    for m in ((6, 6, 6), (8, 8, 8)):
        mat = w.mat if m == (6, 6, 6) else _wire(m).mat
        assert (build_boundary_tables(mat, w.dom, device="cpu")._host["corr"] < 0).all(), m
    rng = np.random.default_rng(0)
    crafted = np.where(rng.random((70, 50)) < 0.3, rng.integers(0, 50, (70, 50)), -1).astype(np.int32)
    for c, W in ((corr, 2), (corr[:32], 1), (corr[:33], 2), (crafted, 3)):
        cm = partner_bitmask(SimpleNamespace(_host={"corr": c}))
        assert cm.dtype == np.int32 and cm.shape == (c.shape[1], W)
        u = cm.view(np.uint32)
        for r in range(c.shape[0]):
            bit = (u[:, r >> 5] >> np.uint32(r & 31)) & 1
            np.testing.assert_array_equal(bit == 1, c[r] >= 0, err_msg=f"row {r}")
        # no bit beyond the last row
        extra = np.arange(32 * W) >= c.shape[0]
        for b in np.nonzero(extra)[0]:
            assert not ((u[:, b >> 5] >> np.uint32(b & 31)) & 1).any()


def test_twin_reflects_specularly_exactly_where_a_partner_exists():
    """Lanes placed 2 A inside each rough facet, flying straight at it:
    with eta = 0 in the facet table the Ziman probability is 1, so the
    Bernoulli keeps (flags and exports) a lane exactly where its mode has a
    partner at the facet's row, and diffuses it (a new mode) elsewhere."""
    import dataclasses

    from nanokappa_torch.geometry.domain import BC
    from nanokappa_torch.ops.megastep import FT_ETA, drift_megastep_plain, mega_config
    from nanokappa_torch.sim.fused import build_route, dkern_facet_tables
    from nanokappa_torch.sim.state import C_MODE, SimParams, init_state, particle_count

    w = _wire()
    n_p, rho = particle_count(("total", 2000), w.mat, w.dom)
    params = SimParams(
        dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="constant",
        particle_density=rho, n_active_modes=w.mat.n_active_modes, t_reference=300.0,
        scat_model="k",
    )
    route = build_route(w.geo, w.btab, params, w.tabs)
    assert route.step == "v2" and route.dkern
    state = init_state(w.mat, w.dom, w.geo, params, n_p, w.btab, temp_dist="linear", seed=3)
    assert state.layout == "plain"
    cfg = mega_config(w.geo, w.tabs, w.btab, params, 4096)
    assert cfg.dkern and cfg.cmask_w == 2
    facets = cfg.facets.clone()
    facets[:, FT_ETA] = 0.0
    cfg = dataclasses.replace(cfg, facets=facets)

    assert sorted(set(dkern_facet_tables(w.geo, w.btab)["facet_row"][
        np_(w.geo.facet_bc) == int(BC.ROUGH)])) == list(range(40))
    pool = state.pool.clone()
    N, modes, rows, has = aim_at_rough_facets(pool, w.dom, w.geo, w.btab)
    pool = pool[:, :N].contiguous()
    assert has.any() and (~has).any() and has[rows >= 32].any()

    rows_x, idx, counts, _, _ = drift_megastep_plain(pool, state.T_sv, False, cfg, seed=7)
    kept = int(counts[2])
    ex_idx = np_(idx[:kept]).astype(np.int64)
    exported = np.zeros(N, bool)
    exported[ex_idx] = True
    ex_mode = np.full(N, -1, np.int32)
    ex_mode[ex_idx] = np_(rows_x[C_MODE, :kept]).view(np.int32)
    # every lane with a partner is flagged at its first hit, its mode kept
    assert exported[has].all() and (ex_mode[has] == modes[has]).all()
    # every lane without one diffused (a new mode) at its first hit; a few
    # diffused lanes reach a second wall within the step and flag there
    second = exported & ~has
    assert (ex_mode[second] != modes[second]).all() and second.sum() <= 0.01 * N
    assert int(counts[4]) == exported.sum()  # flagged: the specular winners
    assert int(counts[3]) >= (~has).sum()  # every other lane diffused
    hi = rows >= 32
    assert (exported & hi & has).sum() == (hi & has).sum() > 0
