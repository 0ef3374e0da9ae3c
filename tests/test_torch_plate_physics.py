"""The perforated plate on the port's CPU path: the physics assertions of
tests/test_porous.py::test_porous_voronoi_simulation (temperatures between
the reservoirs, heat flowing hot to cold across the Voronoi cells, no lane
inside the hole, no loss), on the configuration of tests/test_torch_plate.py.
"""

import numpy as np

from test_torch_plate import plate  # noqa: F401  (the shared fixture)
from torch_parity import np_


def test_plate_physics(plate):
    """tests/test_porous.py::test_porous_voronoi_simulation's assertions on
    the port (at 4^3, 3000 particles, 100 steps)."""
    from nanokappa_torch.sim.state import init_state
    from nanokappa_torch.sim.step import build_step

    path, dom, mat, n_p, rho, params, geo, btab, rtab = plate
    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=4)
    run = build_step(geo, mat.device_tables("cpu"), btab, rtab, params, n_inner=10, n_outer=10)
    state, out = run(state)
    T = np_(out.T_sv[-1])
    assert np.all(T > 295.9) and np.all(T < 304.1)
    cx = dom.subvol_center[:, 0]
    assert T[np.argmin(cx)] > T[np.argmax(cx)]  # conducts hot -> cold
    alive = np_(state.alive)
    pos = np_(state.pos)[alive]
    in_hole = (np.abs(pos[:, 0] - 1500) < 590) & (np.abs(pos[:, 1] - 1500) < 590)
    assert in_hole.mean() < 0.01
    assert int(out.lost[-1]) < 0.05 * n_p
    assert abs(int(out.N_p[-1]) - n_p) < 0.05 * n_p
    assert int(state.kernel_events[0]) > 0  # kernel A diffused on the walls
    sv = np_(state.sv_col)[alive]
    assert len(np.unique(sv)) == 8
