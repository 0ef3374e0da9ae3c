"""The nanowire slice against the JAX package: the gates and sizing, the
initial state, the 'constant' reservoirs and the builders' device default;
and the statistics of kernel A's in-kernel diffuse draws (the ray casts are
in tests/test_torch_wire_cast.py).

On the CPU the port's kernels run their plain torch twins (the CUDA kernels
are held against those twins on the card by tests/test_torch_gpu.py and
chip_smoke.py). Tolerances:
  * the initial pool (bar the first cast's flight times) and the reservoir
    counts, modes and facets: exact;
  * copy-0 arrival times of the 'constant' lattice: rtol 1e-6;
  * diffuse statistics: the specular share within 4 binomial sigma of the
    flux-weighted Ziman specularity of the incident lanes; the re-emitted
    modes within 3x the expected total-variation distance of the wall
    row's creation weights (tests/test_diffuse_kernel.py:91-116).
"""

import numpy as np
import pytest
import torch

from torch_parity import FILM, WIRE, build_pair, jax_fields, np_


@pytest.fixture(scope="module")
def wire():
    return build_pair(WIRE, mesh=(6, 6, 6), res_gen="constant")


def test_wire_gates_and_sizing_match_jax(wire):
    """Off the mirror path with rough walls: the in-kernel diffuse gate, the
    per-facet tables and the kinetic event window agree with the JAX
    package's; the pool layout is "plain"."""
    from nanokappa_tpu.sim.fused import (
        _dkern_facet_tables, autosize_evt_cap as j_evt, dkern_active as j_dkern,
        kernel_cast_ok as j_kc, mirror_eligible as j_me,
    )
    from nanokappa_torch.sim.fused import (
        autosize_evt_cap, dkern_active, dkern_facet_tables, kernel_cast_ok,
        mirror_eligible, pool_layout,
    )

    j, t = wire
    assert j_kc(j.geo) and kernel_cast_ok(t.geo)
    assert not j_me(j.geo, j.btab, j.params, j.tabs)
    assert not mirror_eligible(t.geo, t.btab, t.params, t.tabs)
    assert j_dkern(j.geo, j.btab, j.params, j.tabs, j.params.n_cap) is not None
    assert dkern_active(t.geo, t.btab, t.params, t.tabs)
    assert pool_layout(t.geo, t.btab, t.params, t.tabs) == "plain"
    jd, td = _dkern_facet_tables(j.geo, j.btab), dkern_facet_tables(t.geo, t.btab)
    for k in ("facet_eta", "facet_row", "facet_row_back", "two_sided"):
        np.testing.assert_array_equal(np.asarray(jd[k]), np.asarray(td[k]), err_msg=k)
    N = t.params.n_cap
    assert j_evt(j.geo, j.tabs, j.params, False, N, btab=j.btab) == autosize_evt_cap(
        t.geo, t.tabs, t.params, False, N, btab=t.btab
    )


def test_wire_init_matches_jax(wire):
    """Same seed, same NumPy draws: the port's plain (16, N) pool is the JAX
    package's packed rows bit for bit (full lifetimes included), except the
    first Möller–Trumbore cast's flight times (C_TCOLL), which sum in
    another order: rtol 1e-5 plus 1e-5 of a step, the hit facets exact."""
    from nanokappa_torch.convert import state_from_jax, state_to_jax
    from nanokappa_torch.sim.state import C_TCOLL

    j, t = wire
    assert t.state.layout == "plain" and t.state.pool.shape == (16, t.params.n_cap)
    conv = state_from_jax(jax_fields(j.state), "plain", device="cpu")
    a, b = np_(conv.pool), np_(t.state.pool)
    rows = [r for r in range(16) if r != C_TCOLL]
    np.testing.assert_array_equal(a[rows].view(np.int32), b[rows].view(np.int32))
    np.testing.assert_allclose(a[C_TCOLL], b[C_TCOLL], rtol=1e-5, atol=1e-5)
    back = state_to_jax(t.state)
    jp = np.asarray(j.state.packed)
    np.testing.assert_array_equal(back["packed"][:, rows].view(np.int32), jp[:, rows].view(np.int32))
    # a JAX in-kernel-diffuse pool carries two derived columns (|k|^2, the
    # partner bitmask) that the plain layout drops
    d = jax_fields(j.state)
    d["packed"] = np.concatenate([d["packed"], np.ones((jp.shape[0], 2), np.float32)], axis=1)
    conv18 = state_from_jax(d, "plain", device="cpu")
    assert torch.equal(conv18.pool.view(torch.int32), conv.pool.view(torch.int32))


def test_constant_injections_match_jax(wire):
    """The 'constant' scheme is deterministic in its counts: over several
    steps the per-step count, the drops, the accumulator, and the modes,
    reservoirs and facets of the injected lanes (lattice order) equal the
    JAX package's; so do the copy-0 arrival times (the accumulator's
    fraction)."""
    import dataclasses

    import jax

    from nanokappa_tpu.sim.reservoir import sample_injections as j_sample
    from nanokappa_torch.sim.reservoir import constant_counts, sample_injections
    from nanokappa_torch.sim.state import C_MODE, C_ONF, C_REM

    j, t = wire
    counter = t.state.res_counter.copy()
    jstate = j.state
    gen = torch.Generator().manual_seed(5)
    n_total = 0
    for k in range(4):
        counts, _, _ = constant_counts(counter, t.rtab, 1, t.params.c_max)
        k0 = int((counts > 0).sum())  # lanes of copy 0 lead the lattice order
        jrows, jn, jcounter, jdrop, _ = j_sample(
            jstate, j.geo, j.tabs, j.rtab, j.params, jax.random.PRNGKey(k)
        )
        rows, n, counter, drop, _ = sample_injections(counter, t.geo, t.rtab, t.params, gen)
        jstate = dataclasses.replace(jstate, res_counter=jcounter)
        assert (n, drop) == (int(jn), int(jdrop))
        np.testing.assert_array_equal(counter, np.asarray(jcounter))
        jr = np.asarray(jrows).T
        for r in (C_MODE, C_ONF):
            np.testing.assert_array_equal(np_(rows[r, :n]).view(np.int32), jr[r, :n].view(np.int32))
        np.testing.assert_allclose(np_(rows[C_REM, :k0]), jr[C_REM, :k0], rtol=1e-6)
        n_total += n
    assert n_total > 0


def test_constant_positions_cover_the_caps_by_area(wire):
    """Injected positions lie on their reservoir facet and fall on its
    triangles in proportion to their areas (chi-square)."""
    from scipy.stats import chi2

    from nanokappa_torch.sim.reservoir import sample_injections
    from nanokappa_torch.sim.state import C_ONF, C_POS

    _, t = wire
    mesh = t.dom.mesh
    counter = t.state.res_counter.copy()
    gen = torch.Generator().manual_seed(9)
    pos, fac = [], []
    for _ in range(30):
        rows, n, counter, _, _ = sample_injections(counter, t.geo, t.rtab, t.params, gen)
        pos.append(np_(rows[C_POS, :n]).T)
        fac.append(np_(rows[C_ONF, :n]).view(np.int32))
    pos, fac = np.concatenate(pos).astype(np.float64), np.concatenate(fac)
    for f in np.unique(fac):
        p = pos[fac == f]
        n_f, c_f = mesh.facet_normals[f], mesh.facet_centroids[f]
        assert np.abs((p - c_f) @ n_f).max() < 1e-2  # on the facet's plane
        tris = mesh.facets[f]
        hits = np.zeros(len(tris), np.int64)
        for k, tri in enumerate(tris):
            a, b, c = mesh.tri[tri]
            m = np.stack([b - a, c - a], axis=1)
            uv = np.linalg.lstsq(m, (p - a).T, rcond=None)[0]
            hits[k] = ((uv >= -1e-6).all(0) & (uv.sum(0) <= 1 + 1e-6)).sum()
        assert hits.sum() >= len(p)  # every point lies on one of them
        area = mesh.face_areas[tris] / mesh.face_areas[tris].sum()
        exp = area * hits.sum()
        stat = ((hits - exp) ** 2 / exp).sum()
        assert stat < chi2.ppf(0.999, len(tris) - 1), (f, hits, exp)


@pytest.mark.parametrize("change, item", [
    # (the ids are kept from when the port refused the 'fixed_rate' and
    # 'one_to_one' reservoirs, item 5; both now run on the fused step: 0)
    (dict(params=dict(res_gen="fixed_rate")), 0),
    (dict(params=dict(res_gen="one_to_one")), 0),
    # (the ids are kept from when the port refused every linear, k-model
    # and grid configuration; it now runs linear T on slices, the k model
    # off the mirror path and up to 256 grid centres, and refuses the rest)
    (dict(params=dict(temp_interp="linear"), geo=dict(subvol_type="grid")), 11),
    # (the id is kept from when the port refused the k model on the mirror
    # path; it now runs it on the full 24-row mirror layout, and particle
    # shards beside it: item 12 is ported too, 0)
    (dict(params=dict(scat_model="k", n_shards=2), mirror=True), 0),
    (dict(params=dict(n_shards=2)), 0),
    (dict(geo=dict(subvol_type="grid", n_subvols=257)), 11),
    # (the id is kept from when meshes over 128 triangles raised; they now
    # run kernel A with kernel_cast off, and only meshes beyond kernel E's
    # 65,536 triangles raise)
    (dict(geo=dict(tri_origin=torch.zeros((65537, 3)))), 11),
], ids=["fixed_rate", "one_to_one", "linear_interp", "k_model", "two_shards", "grid", "200_triangles"])
def test_configs_outside_the_ported_paths_raise(wire, change, item, monkeypatch):
    """Every configuration the port does not run yet raises, naming the
    ROADMAP item that ports it (a k-model configuration on the mirror path:
    the wire's walls are not, so the gate is forced); those of item 11 (the
    v1 step, ported) are admitted and routed to the v1 step."""
    import dataclasses

    from nanokappa_torch.sim import fused
    from nanokappa_torch.sim.fused import require_slice, v2_eligible

    _, t = wire
    geo = dataclasses.replace(t.geo, **change.get("geo", {}))
    params = dataclasses.replace(t.params, **change.get("params", {}))
    if change.get("mirror"):
        monkeypatch.setattr(fused, "mirror_eligible", lambda *a, **k: True)
    if item in (0, 11):
        require_slice(geo, t.btab, params, t.tabs)
        assert v2_eligible(geo, params) == (item == 0)
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        require_slice(geo, t.btab, params, t.tabs)


def test_builders_default_to_the_card(monkeypatch, wire):
    """Without a card and without `device=`, every builder raises instead of
    quietly building CPU tensors."""
    from nanokappa_torch.convert import state_from_jax, tables_from_jax
    from nanokappa_torch.geometry.device import DeviceGeometry, build_device_geometry
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.reservoir import build_reservoir_tables

    j, t = wire
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: build_device_geometry(t.dom),
        lambda: t.mat.device_tables(),
        lambda: build_boundary_tables(t.mat, t.dom),
        lambda: build_reservoir_tables(t.mat, t.dom, 1.0, t.params.particle_density),
        lambda: tables_from_jax(DeviceGeometry, jax_fields(j.geo)),
        lambda: state_from_jax(jax_fields(j.state), "plain"),
    ):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_diffuse_draw_statistics():
    """Kernel A's in-kernel diffuse reflection (plain twin) on a box with
    eta = 2 A walls, which, unlike the 6^3 octagon, has specular partners:
    lanes sit just inside the two rough walls, far from every edge, moving
    into the wall with modes drawn by incident flux, so each has exactly
    one event — the rough-wall Bernoulli. The specular share matches the
    incident lanes' flux-weighted Ziman specularity, the re-emitted modes
    per wall row follow the creation weights, and every diffused lane
    carries its new mode's table row, the Bose-Einstein occupation and the
    lifetime at the wall temperature."""
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import BC, build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.ops.kmath import occupation_delta_T_k
    from nanokappa_torch.ops.megastep import drift_megastep, mega_config
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.fused import dkern_active
    from nanokappa_torch.sim.scatter import lifetime_by_sv
    from nanokappa_torch.sim.state import (
        C_ALIVE, C_CF, C_DEV, C_MODE, C_OMEGA, C_ONF, C_REM, C_TAU, C_TCOLL,
        SimParams, STALE,
    )

    mat = synthetic_material(mesh=(4, 4, 4))
    dom = build_domain(**dict(FILM, bound_values=(302.0, 298.0, 2.0, 2.0)))
    geo = build_device_geometry(dom, device="cpu")
    btab = build_boundary_tables(mat, dom, device="cpu")
    tabs = mat.device_tables("cpu")
    N = 16384
    params = SimParams(dt=1.0, n_cap=N, inj_cap=512, temp_interp="nearest", t_reference=300.0)
    assert dkern_active(geo, btab, params, tabs)
    cfg = mega_config(geo, tabs, btab, params, ecap=N)

    rng = np.random.default_rng(0)
    ov = np_(tabs.omega_vel).astype(np.float64)
    bc = np_(geo.facet_bc)
    lo, hi = dom.mesh.bounds
    rough = np.nonzero(bc == int(BC.ROUGH))[0]
    pool = np.zeros((16, N), np.float32)
    wall = np.repeat(rough, N // len(rough))
    modes = np.zeros(N, np.int64)
    for f in rough:
        n_f = dom.mesh.facet_normals[f]
        flux = np.maximum(ov[:, 1:4] @ n_f, 0.0)  # incident flux weights
        sel = wall == f
        modes[sel] = rng.choice(len(flux), size=sel.sum(), p=flux / flux.sum())
        ax = int(np.argmax(np.abs(n_f)))
        p = rng.uniform(lo + 150.0, hi - 150.0, size=(sel.sum(), 3))
        p[:, ax] = (hi if n_f[ax] > 0 else lo)[ax] - 1e-3 * n_f[ax]
        pool[0:3, sel] = p.T
    T_sv = torch.full((geo.n_subvols,), 300.0)
    pool[3:6] = ov[modes, 1:4].T
    pool[C_OMEGA] = ov[modes, 0]
    pool[C_TAU] = 1.0
    pool[C_MODE] = modes.astype(np.int32).view(np.float32)
    pool[C_CF] = np.full(N, STALE, np.int32).view(np.float32)
    pool[C_ONF] = np.full(N, -1, np.int32).view(np.float32)
    pool[C_REM] = 1.0
    pool[C_ALIVE] = 1.0
    tp = torch.as_tensor(pool)
    rows, idx, counts, _, _ = drift_megastep(tp, T_sv, False, cfg, seed=11)
    k = int(counts[2])
    flagged = np.zeros(N, bool)
    flagged[np_(idx[:k])] = True
    assert (np_(rows[C_TCOLL, :k]) == -2.0).all()
    out = np_(tp)
    onf = out[C_ONF].view(np.int32)
    diffused = (onf == wall) & ~flagged
    assert (flagged | diffused).all()  # one rough-wall event per lane
    assert int(counts[3]) == diffused.sum() and int(counts[4]) == flagged.sum()

    # the specular share against the incident lanes' specularity
    spec = btab._host["specularity"]
    row = np_(btab.row_of_rough)[np_(geo.facet_rough)[wall]]
    p = spec[row, modes].astype(np.float64)
    assert (p > 0).mean() > 0.1  # premise: the walls have specular partners
    sigma = np.sqrt((p * (1 - p)).sum()) / N
    assert abs(flagged.mean() - p.mean()) < 4 * sigma, (flagged.mean(), p.mean(), sigma)

    # re-emitted modes per wall row against the creation weights
    creation = btab._host["creation"]
    new_mode = out[C_MODE].view(np.int32)
    M = creation.shape[1]
    nbins = 24
    edges = np.linspace(0, M, nbins + 1)
    for r in np.unique(row):
        m = new_mode[diffused & (row == r)]
        assert (creation[r, m] > 0).all()
        h, _ = np.histogram(m, bins=edges)
        p_emp = h / h.sum()
        p_true = np.add.reduceat(creation[r] / creation[r].sum(), edges[:-1].astype(int))
        tv = 0.5 * np.abs(p_emp - p_true).sum()
        assert tv < 3.0 * np.sqrt(nbins / (2 * np.pi * len(m))), (r, tv, len(m))

    # each diffused row: its new mode's table row, BE(T_wall) and tau(T_wall)
    d = torch.as_tensor(diffused)
    mode_t = torch.as_tensor(new_mode.astype(np.int64))
    assert torch.equal(tp[C_OMEGA][d], tabs.omega_vel[mode_t[d], 0])
    assert torch.equal(tp[3:6][:, d], tabs.omega_vel[mode_t[d], 1:4].T)
    T_w = torch.full((int(d.sum()),), 300.0)
    assert torch.equal(tp[C_DEV][d], occupation_delta_T_k(T_w, 300.0, tp[C_OMEGA][d]))
    sv = torch.zeros(int(d.sum()), dtype=torch.int64)
    np.testing.assert_allclose(
        np_(tp[C_TAU][d]), np_(lifetime_by_sv(tabs, T_sv, sv, mode_t[d])), rtol=1e-6
    )
