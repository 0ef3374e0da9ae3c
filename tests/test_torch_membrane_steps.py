"""Two-sided internal membranes (tests/test_interfaces.py) through the
port's narrow rounds and step, against the JAX package on the CPU (the
mesh, the domain, the tables, kernel A's twin, the watertight steps and
the CLI are in tests/test_torch_membrane.py; this file holds the two
checks that run the JAX package's own machinery, about 10 s each, and a
cast of two lanes):

  * sim/cascade.py's narrow rounds (the back row, :381, against JAX
    sim/cascade.py:553): event rows sitting on the membrane from both
    sides, each forced specular as kernel A flags it, take the partner of
    their side's row in both packages, bit for bit;
  * the transport domain of tests/test_interfaces.py:80 from one initial
    state: the port's fused step (kernel A's two-sided in-kernel-diffuse
    branch on the 24-triangle cast, the narrow rounds) against the JAX v1
    step for 4 steps, T_sv within 0.05 K (tests/test_torch_kmodel.py's
    tolerance: both steps from the same pool, the Monte Carlo draws
    differ);
  * a reference fault both share: the cast's backward slack (no facing
    test) lets a lane just in front of the membrane, moving away from it,
    hit it, and so cross at the rim (chip_smoke.py's watertight phase).
The material is the 6^3 synthetic table.
"""

import numpy as np
import pytest
import torch

from torch_parity import membrane_box, membrane_kw, membrane_lanes, np_


@pytest.fixture(scope="module")
def stl_path(tmp_path_factory):
    from nanokappa_torch.geometry import stl

    path = str(tmp_path_factory.mktemp("membrane") / "membrane.stl")
    stl.save_stl(membrane_box(doubled=True), path)
    return path


@pytest.fixture(scope="module")
def mats():
    from nanokappa_tpu.material import synthetic_material as j_mat
    from nanokappa_torch.material import synthetic_material

    return j_mat(mesh=(6, 6, 6)), synthetic_material(mesh=(6, 6, 6))


def _domains(path, kind):
    from nanokappa_tpu.geometry.domain import build_domain as j_dom
    from nanokappa_torch.geometry.domain import build_domain

    kw = membrane_kw(path, kind)
    return j_dom(**kw), build_domain(**kw)


def test_narrow_rounds_back_row_matches_jax(stl_path, mats):
    """Event rows sitting on the membrane from both sides, every lane
    forced specular (the kernel's flag): both packages' narrow rounds give
    each lane the partner of its mode at its side's row, bit for bit, and
    every lane leaves on its own side."""
    import jax

    from nanokappa_tpu.sim.cascade import run_event_buffer as j_reb
    from nanokappa_tpu.sim.state import SimParams as JParams
    from nanokappa_torch.sim.cascade import run_event_buffer
    from nanokappa_torch.sim.state import C_CF, C_REM, C_TCOLL, SimParams

    from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
    from nanokappa_tpu.sim.boundary_tables import build_boundary_tables as j_bt
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables

    jd, td = _domains(stl_path, "tables")
    jg, jb = j_geo(jd), j_bt(mats[0], jd)
    tg, tb = build_device_geometry(td, device="cpu"), build_boundary_tables(mats[1], td, device="cpu")
    tabs = mats[1].device_tables("cpu")
    pool, side, mem, modes = membrane_lanes(td, tabs, 1024, seed=8)
    E = pool.shape[1]
    rows = pool.clone()
    x0 = float(td.mesh.facet_centroids[mem][0])
    rows[0] = x0
    rows[C_CF] = torch.full((E,), mem, dtype=torch.int32).view(torch.float32)
    rows[C_REM] = 1e-3
    rows[C_TCOLL] = -2.0  # flagged by the kernel's Bernoulli
    T_sv = torch.full((2,), 300.0)
    common = dict(dt=1.0, n_cap=4096, inj_cap=256, t_reference=300.0, temp_interp="nearest")
    out_t = run_event_buffer(rows, torch.ones(E, dtype=torch.bool), tg, tabs, tb, SimParams(**common),
                             torch.Generator().manual_seed(2), T_sv, 8)[0]
    jparams = JParams(**common)
    jtabs = mats[0].device_tables()
    # jitted: the eager narrow loop dispatches op by op (~3x longer)
    out_j = jax.jit(lambda r, v, k, T: j_reb(r, v, jg, jtabs, jb, jparams, k, T, 8)[0])(
        jax.numpy.asarray(np_(rows).T), jax.numpy.ones(E, bool), jax.random.PRNGKey(2),
        jax.numpy.asarray(np_(T_sv)),
    )
    new_t = np_(out_t[9]).view(np.int32)
    new_j = np.asarray(out_j)[:, 9].view(np.int32)
    i_rough = int(np.nonzero(td.rough_facets == mem)[0][0])
    row = np.where(side > 0, np_(tb.row_of_rough)[i_rough], np_(tb.row_back)[i_rough])
    corr = tb._host["corr"][row, modes]
    spec = corr >= 0
    # every incident mode has a partner at its side's row on this
    # axis-aligned wall; the other side's row would give most of them none
    other = np.where(side > 0, np_(tb.row_back)[i_rough], np_(tb.row_of_rough)[i_rough])
    assert spec.all() and (tb._host["corr"][other, modes] < 0).mean() > 0.5
    np.testing.assert_array_equal(new_t[spec], corr[spec])
    np.testing.assert_array_equal(new_j[spec], corr[spec])
    n = td.mesh.facet_normals[mem]
    for new in (new_t, new_j):
        v_new = np_(tabs.omega_vel)[new, 1:4].astype(np.float64) @ n
        assert np.all(side * v_new < 0.0)  # every lane leaves on its own side


def test_membrane_transport_matches_jax_v1(stl_path, mats):
    """tests/test_interfaces.py:80's domain from one initial state: the
    port's fused step (kernel A's two-sided dkern branch on the 24-triangle
    cast) against the JAX v1 step, 4 steps, T_sv within 0.05 K, nothing
    lost, the profile falling hot to cold."""
    import jax

    from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
    from nanokappa_tpu.sim.boundary_tables import build_boundary_tables as j_bt
    from nanokappa_tpu.sim.reservoir import build_reservoir_tables as j_rt
    from nanokappa_tpu.sim.state import SimParams as JParams, SimState as JState
    from nanokappa_tpu.sim.step import make_step
    from nanokappa_torch.convert import state_to_jax
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.fused import dkern_active, v2_eligible
    from nanokappa_torch.sim.reservoir import build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count, round_pool_cap
    from nanokappa_torch.sim.step import build_step

    jd, td = _domains(stl_path, "transport")
    jmat, mat = mats
    n_p, rho = particle_count(("total", 4000), mat, td)
    common = dict(dt=1.0, n_cap=round_pool_cap(int(n_p * 1.25)), inj_cap=1 << 10, particle_density=rho,
                  n_active_modes=mat.n_active_modes, t_reference=300.0, temp_interp="nearest",
                  res_gen="pooled")
    params = SimParams(**common)
    geo = build_device_geometry(td, device="cpu")
    btab = build_boundary_tables(mat, td, device="cpu")
    rtab = build_reservoir_tables(mat, td, 1.0, rho, device="cpu")
    tabs = mat.device_tables("cpu")
    assert v2_eligible(geo, params) and dkern_active(geo, btab, params, tabs)
    state = init_state(mat, td, geo, params, n_p, btab, temp_dist="linear", seed=3)
    d = state_to_jax(state)
    dead = np.nonzero(np_(state.pool[14]) < 0.5)[0].astype(np.int32)
    d["free_list"][: len(dead)] = dead  # the v1 step injects into free slots
    d["free_count"] = np.array([len(dead)], np.int32)
    js = JState(**{k: jax.numpy.asarray(v) for k, v in d.items()}, key=jax.random.PRNGKey(3))
    state, out = build_step(geo, tabs, btab, rtab, params, n_inner=1, n_outer=4)(state)
    step = jax.jit(make_step(j_geo(jd), jmat.device_tables(), j_bt(jmat, jd), j_rt(jmat, jd, 1.0, rho),
                             JParams(step_impl="v1", **common)))
    for k in range(4):
        js, jo = step(js)
        np.testing.assert_allclose(np_(out.T_sv[k]), np.asarray(jo.T_sv), atol=0.05, err_msg=f"T_sv step {k}")
        assert int(out.lost[k]) == 0 and int(jo.lost) == 0
    T = np_(out.T_sv[-1])
    assert T[0] > T[-1]
    assert int(state.kernel_events[0]) > 0


def test_backward_slack_reaches_through_the_membrane_in_both_packages(stl_path):
    """A reference fault both packages share (ROADMAP queue 3, the edge
    ping-pong): the cast takes a hit up to 1e-4 ps behind a lane, with no
    facing test, so a lane a few thousandths of an A in front of the
    membrane, moving AWAY from it, hits it at once, and the narrow rounds
    and kernel A then read the back row (its velocity is against the
    normal) and re-emit it into the other region. Only a lane that reaches
    the plane without reflecting off the membrane gets there (at the rim,
    off the wall it meets), which is why chip_smoke.py's watertight phase
    follows every lane and finds its few side changes there. Both packages'
    casts give the same facet and time for such lanes, and none for a
    lane farther away."""
    import jax

    from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
    from nanokappa_tpu.ops.raycast import raycast as j_cast
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.ops.raycast import raycast

    jd, td = _domains(stl_path, "tight")
    mem = int(td.mesh.interfacets[0])
    # 0.0026 A in front of the plane at 30 A/ps: 8.7e-5 ps behind the lane;
    # 0.0040 A: 1.3e-4 ps, beyond the slack
    pos = np.array([[999.9974, 500.0, 500.0], [999.9960, 500.0, 500.0]], np.float32)
    vel = np.array([[-30.0, 0.0, 0.0], [-30.0, 0.0, 0.0]], np.float32)
    exc = np.array([4, 4], np.int32)
    t_t, f_t = raycast(build_device_geometry(td, device="cpu"), torch.as_tensor(pos), torch.as_tensor(vel),
                       torch.as_tensor(exc))
    t_j, f_j = j_cast(j_geo(jd), jax.numpy.asarray(pos), jax.numpy.asarray(vel), jax.numpy.asarray(exc))
    np.testing.assert_array_equal(np_(f_t), np.asarray(f_j))
    np.testing.assert_array_equal(np_(t_t), np.asarray(t_j))
    assert int(f_t[0]) == mem and float(t_t[0]) == 0.0  # a hit behind the lane, clamped to now
    assert int(f_t[1]) != mem  # beyond the slack: the far wall at x = 0
