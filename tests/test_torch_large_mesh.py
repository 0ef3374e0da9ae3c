"""The large-mesh path end to end on the CPU: meshes beyond kernel A's
in-kernel cast (TRI_KERNEL_MAX = 128 triangles) run the fused step with
kernel_cast off — injections pre-cast through kernel E's twin, every
boundary event exported to the narrow machinery, which re-casts through it.

  * The port's step against the JAX package's v1 step on a 96-sided
    cylinder (384 triangles) at 4^3 with 3000 particles, from one initial
    state, as tests/test_fused.py::test_v2_large_mesh_matches_v1 holds the
    JAX v2 step: step 0's absorptions (n_leaving) exact, T_sv within 0.05 K
    over 4 steps, nothing lost, populations within 30. The cylinder has 2
    slices (the JAX test's has 5): the Monte Carlo subvolume split costs
    seconds per slice on the CPU, and the JAX domain reuses the port's
    volumes (bit-equal by construction) instead of drawing them again. Both
    steps start from the port's initial state (its NumPy draws are the JAX
    package's; its first cast is kernel E's twin).
The imported STL is run in tests/test_torch_stl.py.
"""

import numpy as np

from torch_parity import np_

CYL = dict(
    geometry="cylinder", dimensions=(2e3, 500.0, 96), subvolumes=("slice", 2, 2),
    bound_pos=("relative", 0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
    bound_cond=("T", "T", "R"), bound_values=(302.0, 298.0, 0.0),
)


def test_large_mesh_step_matches_jax_v1(monkeypatch):
    import jax

    from nanokappa_tpu.geometry import domain as jdom_mod
    from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
    from nanokappa_tpu.material import synthetic_material as j_mat
    from nanokappa_tpu.sim.boundary_tables import build_boundary_tables as j_bt
    from nanokappa_tpu.sim.reservoir import build_reservoir_tables as j_rt
    from nanokappa_tpu.sim.state import SimParams as JParams, SimState as JState
    from nanokappa_tpu.sim.step import make_step
    from nanokappa_torch.convert import state_to_jax
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.ops.raycast_large import large_eligible
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.fused import TRI_KERNEL_MAX, kernel_cast_ok, mirror_eligible, require_slice
    from nanokappa_torch.sim.reservoir import build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count
    from nanokappa_torch.sim.step import build_step

    dom = build_domain(**CYL)
    monkeypatch.setattr(jdom_mod, "_mc_subvol_volume", lambda *a, **k: dom.subvol_volume.copy())
    jdom = jdom_mod.build_domain(**CYL)
    mat, jmat = synthetic_material(mesh=(4, 4, 4)), j_mat(mesh=(4, 4, 4))
    n_p, rho = particle_count(("total", 3000), mat, dom)
    common = dict(
        dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="pooled",
        particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0,
    )
    geo, jg = build_device_geometry(dom, device="cpu"), j_geo(jdom)
    btab, jbt = build_boundary_tables(mat, dom, device="cpu"), j_bt(jmat, jdom)
    tabs = mat.device_tables("cpu")
    params, jparams = SimParams(**common), JParams(step_impl="v1", **common)
    assert geo.tri_origin.shape[0] > TRI_KERNEL_MAX and not kernel_cast_ok(geo) and large_eligible(geo)
    assert btab.n_rows > 32 and not mirror_eligible(geo, btab, params, tabs)
    require_slice(geo, btab, params, tabs)  # admitted: no raise

    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=3)
    d = state_to_jax(state)
    dead = np.nonzero(np_(state.pool[14]) < 0.5)[0].astype(np.int32)
    d["free_list"][: len(dead)] = dead  # the v1 step injects into free slots
    d["free_count"] = np.array([len(dead)], np.int32)
    js = JState(**{k: jax.numpy.asarray(v) for k, v in d.items()}, key=jax.random.PRNGKey(3))
    run = build_step(
        geo, tabs, btab, build_reservoir_tables(mat, dom, 1.0, rho, device="cpu"), params,
        n_inner=1, n_outer=4,
    )
    _, out = run(state)
    step = jax.jit(make_step(jg, jmat.device_tables(), jbt, j_rt(jmat, jdom, 1.0, rho), jparams))
    for k in range(4):
        js, jo = step(js)
        np.testing.assert_allclose(np_(out.T_sv[k]), np.asarray(jo.T_sv), atol=0.05, err_msg=f"T_sv step {k}")
        if k == 0:
            np.testing.assert_array_equal(np_(out.n_leaving[0]), np.asarray(jo.n_leaving))
        assert int(out.lost[k]) == 0 and int(jo.lost) == 0
        assert abs(int(out.N_p[k]) - int(jo.N_p)) < 30
    assert abs(int(out.N_p[-1]) - 3000) < 100
