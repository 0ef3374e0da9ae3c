"""The perforated plate (BASELINE config 4: an imported STL with a hole,
Voronoi subvolumes) on the port's CPU path, against the JAX package.

The plate of tests/test_porous.py (3000 x 3000 x 1000 A, a 1200 A square
hole through z, 32 triangles) as an STL, 8 Voronoi cells, T reservoirs at
304 / 296 K on the x faces, every other facet rough at eta = 5 A: kernel
A's triangle cast with in-kernel diffuse reflection and its nearest-centre
subvolumes, the narrow machinery on nearest-centre ids.

  * one initial state, 4 steps of the port's fused step against the JAX v1
    step: T_sv within 0.1 K every step (the two packages draw their diffuse
    re-emissions from different streams; 0.1 K is a few times the spread
    of 4 steps' MC noise at ~300 particles a cell), step 0's absorptions
    within 3 particles (a lane can diffuse before it reaches a reservoir),
    nothing lost, populations within 30.
The mirror of tests/test_porous.py::test_porous_voronoi_simulation (its
physics assertions) is tests/test_torch_plate_physics.py, the CLI on the
plate tests/test_torch_plate_cli.py.
Both packages take the plate's fixed Lloyd centres (torch_parity:
PLATE_CENTERS): the Lloyd iteration costs ~50 s of CPU.
"""

import numpy as np
import pytest

from torch_parity import np_, patch_lloyd, perforated_plate, plate_kw


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    from nanokappa_torch.geometry import stl
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.reservoir import build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, particle_count

    path = str(tmp_path_factory.mktemp("plate") / "plate.stl")
    stl.save_stl(perforated_plate(), path)
    with pytest.MonkeyPatch.context() as mp:
        patch_lloyd(mp)
        dom = build_domain(**plate_kw(path))
    mat = synthetic_material(mesh=(4, 4, 4))
    n_p, rho = particle_count(("total", 3000), mat, dom)
    params = SimParams(
        dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="pooled",
        particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0, k_max=16,
    )
    geo = build_device_geometry(dom, device="cpu")
    btab = build_boundary_tables(mat, dom, device="cpu")
    rtab = build_reservoir_tables(mat, dom, 1.0, rho, device="cpu")
    return path, dom, mat, n_p, rho, params, geo, btab, rtab


def test_plate_step_matches_jax_v1(plate, monkeypatch):
    import jax

    from nanokappa_tpu.geometry import domain as jdom_mod
    from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
    from nanokappa_tpu.material import synthetic_material as j_mat
    from nanokappa_tpu.sim.boundary_tables import build_boundary_tables as j_bt
    from nanokappa_tpu.sim.reservoir import build_reservoir_tables as j_rt
    from nanokappa_tpu.sim.state import SimParams as JParams, SimState as JState
    from nanokappa_tpu.sim.step import make_step
    from nanokappa_torch.convert import state_to_jax
    from nanokappa_torch.sim.fused import dkern_active, kernel_cast_ok, mirror_eligible
    from nanokappa_torch.sim.state import init_state
    from nanokappa_torch.sim.step import build_step

    path, dom, mat, n_p, rho, params, geo, btab, rtab = plate
    patch_lloyd(monkeypatch)
    monkeypatch.setattr(jdom_mod, "_mc_subvol_volume", lambda *a, **k: dom.subvol_volume.copy())
    jdom = jdom_mod.build_domain(**plate_kw(path))
    np.testing.assert_array_equal(jdom.subvol_center, dom.subvol_center)
    jmat = j_mat(mesh=(4, 4, 4))
    tabs = mat.device_tables("cpu")
    assert geo.subvol_type == "voronoi" and not geo.is_box and kernel_cast_ok(geo)
    assert dkern_active(geo, btab, params, tabs) and not mirror_eligible(geo, btab, params, tabs)

    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=4)
    d = state_to_jax(state, v1=True)  # the v1 step injects into free slots
    js = JState(**{k: jax.numpy.asarray(v) for k, v in d.items()}, key=jax.random.PRNGKey(4))
    run = build_step(geo, tabs, btab, rtab, params, n_inner=1, n_outer=4)
    _, out = run(state)
    common = {f: getattr(params, f) for f in ("dt", "n_cap", "inj_cap", "temp_interp", "res_gen",
                                              "particle_density", "n_active_modes", "t_reference", "k_max")}
    step = jax.jit(make_step(j_geo(jdom), jmat.device_tables(), j_bt(jmat, jdom),
                             j_rt(jmat, jdom, 1.0, rho), JParams(step_impl="v1", **common)))
    for k in range(4):
        js, jo = step(js)
        np.testing.assert_allclose(np_(out.T_sv[k]), np.asarray(jo.T_sv), atol=0.1, err_msg=f"T_sv step {k}")
        if k == 0:
            np.testing.assert_allclose(np_(out.n_leaving[0]), np.asarray(jo.n_leaving), atol=3)
        assert int(out.lost[k]) == 0 and int(jo.lost) == 0
        assert abs(int(out.N_p[k]) - int(jo.N_p)) < 30
