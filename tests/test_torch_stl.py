"""The imported-STL path on the port alone: a 144-sided cylinder (576
triangles) written with the port's STL writer, loaded back through
build_domain(<path>.stl) and run through the kernel_cast-off step, as
tests/test_fused.py::test_v2_imported_stl_runs runs the JAX package: a
gradient forms, nothing is lost, the population stays within 10%. The
domain has 2 slices (the JAX test's has 5): the Monte Carlo subvolume split
costs seconds per slice on the CPU. Meshes beyond kernel E's 512 chunks
raise, naming the ROADMAP item that ports them.
"""

import numpy as np
import pytest

from torch_parity import np_


def test_imported_stl_runs(tmp_path):
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.geometry.primitives import make_primitive
    from nanokappa_torch.geometry.stl import save_stl
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.fused import kernel_cast_ok
    from nanokappa_torch.sim.reservoir import build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count
    from nanokappa_torch.sim.step import build_step

    path = str(tmp_path / "wire.stl")
    save_stl(make_primitive("cylinder", (2e3, 500.0, 144)), path)
    mat = synthetic_material(mesh=(4, 4, 4))
    dom = build_domain(
        geometry=path, subvolumes=("slice", 2, 2),
        bound_pos=("relative", 0.5, 0.5, -0.1, 0.5, 0.5, 1.1),
        bound_cond=("T", "T", "R"), bound_values=(302.0, 298.0, 2.0), connect_pos=("relative",),
    )
    n_p, rho = particle_count(("total", 2000), mat, dom)
    params = SimParams(
        dt=1.0, n_cap=4096, inj_cap=512, temp_interp="nearest", res_gen="pooled",
        particle_density=rho, n_active_modes=mat.n_active_modes, t_reference=300.0,
    )
    geo = build_device_geometry(dom, device="cpu")
    assert geo.tri_origin.shape[0] == 576 and not kernel_cast_ok(geo)
    btab = build_boundary_tables(mat, dom, device="cpu")
    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=5)
    run = build_step(
        geo, mat.device_tables("cpu"), btab, build_reservoir_tables(mat, dom, 1.0, rho, device="cpu"),
        params, n_inner=5,
    )
    for _ in range(3):
        state, out = run(state)
    T = np_(out.T_sv)
    assert np.all(T > 290) and np.all(T < 310)
    assert T[0] > T[-1]  # hot cap -> cold cap gradient forming
    assert int(out.lost) == 0
    assert abs(int(out.N_p) - n_p) < 0.1 * n_p


@pytest.mark.parametrize("n_side", [16400])
def test_meshes_beyond_kernel_e_raise(n_side):
    """65,600 triangles: beyond kernel E's 512 chunks, the v1 step's
    territory (ROADMAP item 11, ported: such a mesh no longer raises, it
    runs the v1 step, with the JAX package's reason)."""
    from types import SimpleNamespace

    import torch

    from nanokappa_torch.sim.fused import build_route, v2_fallback_reason
    from nanokappa_torch.sim.state import SimParams

    geo = SimpleNamespace(is_box=False, tri_origin=torch.zeros(4 * n_side, 3), n_reservoirs=2,
                          subvol_type="slice", n_subvols=5)
    params = SimParams(dt=1.0, n_cap=1024, inj_cap=8)
    route = build_route(geo, None, params, None)
    assert route.step == "v1" and route.v1_reason == v2_fallback_reason(geo, params) == (
        "mesh has 65600 triangles > the large-mesh fused-step bound LARGE_TRI_MAX=65536"
    )
