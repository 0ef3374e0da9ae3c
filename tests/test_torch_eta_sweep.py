"""BASELINE config 3, the nanowire specularity sweep (tests/test_nanowire.py),
in the port on the CPU, on the 6^3 synthetic table:

  * the 12-sided wire's boundary tables at eta = 0, 2 and 10 A bit-equal
    to the JAX package's, and its per-row specular-partner coverage: its
    side normals lie at 15 + 30 k degrees, so under the velocity model the
    four rows of the 45 and 135 degree walls cover 0.389 of the modes and
    the other eight none (the 8-sided wire's rows all cover none);
  * the in-kernel-diffuse gate and the facet rows: off the mirror path at
    every eta in both packages, one-sided (no membrane);
  * kernel A's plain twin at eta = 0 on lanes aimed at every side wall
    (tests/torch_parity.py aim_at_rough_facets): a lane is flagged
    specular exactly where its mode has a partner at its wall's row — only
    on the four covered rows — and diffuses everywhere else;
  * the sweep: tests/torch_parity.py:wire_kappa (the port's counterpart of
    the JAX test's function, its sizes: 8000 particles, n_cap = 1.8 N, so
    the v1 step, as in the JAX package) at eta = 0, 2 and 10 A gives the
    JAX test's inequalities, kappa(0) > kappa(2) > kappa(10) > 0 and
    kappa(10) < 0.8 kappa(0), with under 50 particles lost.
One cut: 80 steps a run instead of the JAX test's 400 (kappa from the
blocks of steps 50-80): a 400-step run takes ~15 s on the CPU, three
would not fit a file's 30 s. At 80 steps the three values (22.00, 19.56,
17.06 W/m/K) stand 9-12 standard errors of their blocks apart, and the
test asks for 3 (at 60 steps they stood only 3-4 apart).
tests/test_torch_eta_sweep_jax.py holds one eta against the JAX
wire_kappa.
"""

import numpy as np
import pytest

from torch_parity import aim_at_rough_facets, np_, wire12, wire_kappa


ETAS = (0.0, 2.0, 10.0)
KEYS = ("row_back", "row_of_rough", "diffuse_cdf", "specularity", "corr")
SWEEP_STEPS = 80


@pytest.fixture(scope="module")
def wires():
    """{eta: (JAX domain, geometry, tables; the port's)} on the 6^3 table,
    and the two materials. Each package builds the wire's domain once
    (~1 s) and sets its rough facets' eta for each run."""
    import dataclasses

    from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
    from nanokappa_tpu.geometry.domain import build_domain as j_dom
    from nanokappa_tpu.material import synthetic_material as j_mat
    from nanokappa_tpu.sim.boundary_tables import build_boundary_tables as j_bt
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import BC, build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables

    def at(dom, eta):
        rough = dom.bound_cond == int(BC.ROUGH)
        return dataclasses.replace(dom, facet_values=np.where(rough, eta, dom.facet_values))

    jm, tm = j_mat(mesh=(6, 6, 6)), synthetic_material(mesh=(6, 6, 6))
    jd0, td0 = j_dom(**wire12(0.0)), build_domain(**wire12(0.0))
    out = {}
    for eta in ETAS:
        jd, td = at(jd0, eta), at(td0, eta)
        out[eta] = (jd, j_geo(jd), j_bt(jm, jd), td, build_device_geometry(td, device="cpu"),
                    build_boundary_tables(tm, td, device="cpu"))
    return out, jm, tm


@pytest.mark.parametrize("eta", ETAS)
@pytest.mark.parametrize("key", KEYS)
def test_wire12_tables_bit_equal_jax(wires, eta, key):
    w, _, _ = wires
    jb, tb = w[eta][2], w[eta][5]
    a, b = np.ascontiguousarray(np.asarray(getattr(jb, key))), np.ascontiguousarray(np_(getattr(tb, key)))
    assert a.dtype == b.dtype and a.shape == b.shape, (key, a.shape, b.shape)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), key


def test_wire12_domain_at_each_eta(wires):
    """The domains the fixture derives are the ones build_domain gives."""
    from nanokappa_torch.geometry.domain import build_domain

    w, _, _ = wires
    d = build_domain(**wire12(10.0))
    for dom in (w[10.0][3], w[10.0][0]):
        np.testing.assert_array_equal(np.asarray(dom.facet_values), d.facet_values)
        np.testing.assert_array_equal(np.asarray(dom.bound_cond), d.bound_cond)


def test_wire12_coverage_per_row(wires):
    """Four rows of twelve covered (the 45 and 135 degree walls), equally
    in both packages; eta does not move the partner table."""
    w, _, _ = wires
    td, tb = w[0.0][3], w[0.0][5]
    assert tb.n_rough == 12 and tb.n_rows == 12
    normals = tb._host["u_normals"]
    cov = (tb._host["corr"] >= 0).mean(axis=1)
    jcov = (np.asarray(w[0.0][2].corr) >= 0).mean(axis=1)
    np.testing.assert_array_equal(cov, jcov)
    angle = np.degrees(np.arctan2(normals[:, 1], normals[:, 0])) % 180.0
    covered = cov > 0
    assert covered.sum() == 4
    np.testing.assert_allclose(np.sort(np.unique(np.round(angle[covered], 6))), [45.0, 135.0])
    np.testing.assert_allclose(cov[covered], 0.389, atol=5e-4)
    for eta in ETAS[1:]:
        np.testing.assert_array_equal(w[eta][5]._host["corr"], tb._host["corr"])


def test_wire12_gates_and_facet_rows_match_jax(wires):
    from nanokappa_tpu.sim.fused import _dkern_facet_tables, mirror_eligible as j_me
    from nanokappa_torch.sim.fused import dkern_active, dkern_facet_tables, mirror_eligible
    from nanokappa_torch.sim.state import SimParams

    w, jm, tm = wires
    tabs = tm.device_tables("cpu")
    params = SimParams(dt=1.0, n_cap=8192, inj_cap=512, t_reference=300.0)
    jtabs = jm.device_tables()
    for eta in ETAS:
        jd, jg, jb, td, tg, tb = w[eta]
        assert not mirror_eligible(tg, tb, params, tabs)
        assert not j_me(jg, jb, params, jtabs)
        assert dkern_active(tg, tb, params, tabs)
        jt, tt = _dkern_facet_tables(jg, jb), dkern_facet_tables(tg, tb)
        for k in ("facet_eta", "facet_row", "facet_row_back", "two_sided"):
            np.testing.assert_array_equal(np.asarray(jt[k]), np.asarray(tt[k]), err_msg=f"{k} eta {eta}")
        assert tt["two_sided"] is False


def test_twin_specular_exactly_on_the_covered_rows(wires):
    """Kernel A's twin at eta = 0 (the Ziman probability 1 wherever a
    partner exists, 0 elsewhere): lanes flying straight at every side wall
    are flagged exactly where their mode has a partner at that wall's row,
    the flags fall on the four covered rows only, and every other lane
    diffuses at its first hit."""
    import torch

    from nanokappa_torch.geometry.domain import BC
    from nanokappa_torch.ops.megastep import drift_megastep_plain, mega_config
    from nanokappa_torch.sim.state import C_ALIVE, C_MODE, C_ONF, SimParams

    w, _, tm = wires
    _, _, _, td, tg, tb = w[0.0]
    tabs = tm.device_tables("cpu")
    pool = torch.zeros((16, 4096))
    pool[C_ALIVE] = 0.0
    N, modes, rows, has = aim_at_rough_facets(pool, td, tg, tb, per_facet=300, seed=2)
    pool = pool[:, :N].contiguous()
    cfg = mega_config(tg, tabs, tb, SimParams(dt=1.0, n_cap=N, inj_cap=512, t_reference=300.0), ecap=N)
    assert cfg.dkern and cfg.cmask_w == 1 and cfg.tris.shape[0] == 48
    _, idx, counts, _, _ = drift_megastep_plain(pool, torch.full((5,), 300.0), False, cfg, seed=9)
    flagged = np.zeros(N, bool)
    flagged[np_(idx[: int(counts[2])])] = True
    covered = (tb._host["corr"] >= 0).any(axis=1)
    np.testing.assert_array_equal(flagged, has)
    assert has.any() and not has[~covered[rows]].any() and (~has[covered[rows]]).any()
    # the others diffused at their wall: a new mode drawn there (the same
    # one at times, 1 in 1296), the wall their last facet
    walls = np.repeat(np.nonzero(np_(tg.facet_bc) == int(BC.ROUGH))[0], 300)
    assert (np_(pool[C_ONF]).view(np.int32)[~has] == walls[~has]).all()
    assert (np_(pool[C_MODE]).view(np.int32)[~has] != modes[~has]).mean() > 0.99
    assert int(counts[4]) == flagged.sum() and int(counts[3]) >= (~has).sum()


@pytest.fixture(scope="module")
def sweep(wires):
    w, _, tm = wires
    return {eta: wire_kappa(tm, w[eta][3], n_steps=SWEEP_STEPS) for eta in ETAS}


def test_specularity_sweep(sweep):
    """tests/test_nanowire.py:60's inequalities on the port."""
    (k0, s0, out0), (k2, s2, _), (k10, s10, out10) = (sweep[e] for e in ETAS)
    print(f"kappa(eta) {k0:.4f} +- {s0:.4f}, {k2:.4f} +- {s2:.4f}, {k10:.4f} +- {s10:.4f}; "
          f"kappa(10) / kappa(0) {k10 / k0:.4f}")
    assert k0 > k2 > k10 > 0, (k0, k2, k10)
    assert k10 < 0.8 * k0, (k10, k0)
    assert int(out0.lost) < 50 and int(out10.lost) < 50
    # the three values stand apart by several of their standard errors
    for (a, sa), (b, sb) in (((k0, s0), (k2, s2)), ((k2, s2), (k10, s10))):
        assert a - b > 3.0 * np.hypot(sa, sb), (a, sa, b, sb)
