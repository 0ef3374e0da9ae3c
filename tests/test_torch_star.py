"""The 12-cell Voronoi star with radial temperatures (examples/voronoi_star.txt)
on the port's v1 step on the CPU, against the JAX package's v1 step.

The star fails the fused step's gate on its radial interpolation alone, so
both packages take their v1 step: injections, the full-width drift, the
event compaction, the narrow machinery (its 48-triangle dense cast), the
merge, the binning and the RTA toward the RBF temperature profile.

  * one initial state, 4 steps of the port's v1 step against JAX v1: T_sv
    within 0.1 K every step (the two packages draw their reflections and
    injections from different streams; 0.1 K is a few times the spread of
    4 steps' MC noise at ~300 particles a cell), step 0's absorptions
    within 3 particles, nothing lost, populations within 30;
  * the same parameter file through `python -m nanokappa_torch.cli` with
    `--device cpu`: the v1 step is taken and the result files come out in
    the JAX driver's columns.
Both packages take the star's fixed Lloyd centres and equal cell volumes
(torch_parity: STAR_CENTERS): its Lloyd iteration costs ~100 s of CPU.
"""

import os

import numpy as np

from torch_parity import STAR, STAR_CENTERS, np_, patch_lloyd

RADIAL_REASON = "temp_interp='radial' on voronoi subvolumes needs the XLA path"


def test_star_v1_step_matches_jax_v1(monkeypatch):
    import jax

    from nanokappa_tpu.geometry.device import build_device_geometry as j_geo
    from nanokappa_tpu.geometry.domain import build_domain as j_dom
    from nanokappa_tpu.material import synthetic_material as j_mat
    from nanokappa_tpu.sim.boundary_tables import build_boundary_tables as j_bt
    from nanokappa_tpu.sim.fused import v2_fallback_reason as j_reason
    from nanokappa_tpu.sim.reservoir import build_reservoir_tables as j_rt
    from nanokappa_tpu.sim.state import SimParams as JParams, SimState as JState
    from nanokappa_tpu.sim.step import make_step as j_make_step
    from nanokappa_torch.convert import state_to_jax
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.ops import compact, scatter_rows
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables
    from nanokappa_torch.sim.fused import v2_fallback_reason
    from nanokappa_torch.sim.reservoir import autosize_c_max, build_reservoir_tables
    from nanokappa_torch.sim.state import SimParams, init_state, particle_count
    from nanokappa_torch.sim.step import build_step

    patch_lloyd(monkeypatch, STAR_CENTERS, equal_volumes=True)
    dom, jdom = build_domain(**STAR), j_dom(**STAR)
    np.testing.assert_array_equal(dom.subvol_center, jdom.subvol_center)
    mat, jmat = synthetic_material(mesh=(6, 6, 6)), j_mat(mesh=(6, 6, 6))
    n_p, rho = particle_count(("total", 3000), mat, dom)
    rtab = build_reservoir_tables(mat, dom, 1.0, rho, device="cpu")
    common = dict(
        dt=1.0, n_cap=4096, inj_cap=512, c_max=autosize_c_max(rtab), temp_interp="radial",
        res_gen="constant", particle_density=rho, n_active_modes=mat.n_active_modes,
        t_reference=300.0,
    )
    params, jparams = SimParams(**common), JParams(**common)
    geo, jgeo = build_device_geometry(dom, device="cpu"), j_geo(jdom)
    assert geo.tri_origin.shape[0] == 48 and geo.n_subvols == 12
    assert v2_fallback_reason(geo, params) == j_reason(jgeo, jparams) == RADIAL_REASON
    btab = build_boundary_tables(mat, dom, device="cpu")
    tabs = mat.device_tables("cpu")

    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=4)
    assert state.layout == "plain"
    d = state_to_jax(state, v1=True)  # the v1 step injects into free slots
    js = JState(**{k: jax.numpy.asarray(v) for k, v in d.items()}, key=jax.random.PRNGKey(4))
    run = build_step(geo, tabs, btab, rtab, params, n_inner=1, n_outer=4)
    n_c, n_d = compact.launches, scatter_rows.launches
    _, out = run(state)
    assert (compact.launches, scatter_rows.launches) == (n_c, n_d)  # the CPU takes the twins
    step = jax.jit(j_make_step(jgeo, jmat.device_tables(), j_bt(jmat, jdom), j_rt(jmat, jdom, 1.0, rho), jparams))
    for k in range(4):
        js, jo = step(js)
        np.testing.assert_allclose(np_(out.T_sv[k]), np.asarray(jo.T_sv), atol=0.1, err_msg=f"T_sv step {k}")
        if k == 0:
            np.testing.assert_allclose(np_(out.n_leaving[0]), np.asarray(jo.n_leaving), atol=3)
        assert int(out.lost[k]) == 0 and int(jo.lost) == 0
        assert abs(int(out.N_p[k]) - int(jo.N_p)) < 30


def star_argv(tmp) -> list[str]:
    """examples/voronoi_star.txt with a synthetic 6^3 material folder under
    `tmp`, 3,000 particles, 20 steps and the results under `tmp`."""
    from nanokappa_torch.material import write_synthetic_hdf5

    matdir = str(tmp / "mat")
    os.makedirs(matdir)
    write_synthetic_hdf5(matdir, mesh=(6, 6, 6))
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "examples", "voronoi_star.txt")) as f:
        words = f.read().split()
    swap = {"--mat_folder": [matdir], "--hdf_file": ["kappa-m666.hdf5"],
            "--particles": ["total", "3e3"], "--iterations": ["20"], "--n_mean": ["5"],
            "--results_folder": [str(tmp / "res")]}
    out, i = [], 0
    while i < len(words):
        w = words[i]
        j = i + 1
        while j < len(words) and not words[j].startswith("--"):
            j += 1
        out += [w, *swap.get(w, words[i + 1 : j])]
        i = j
    return out + ["--device", "cpu"]


def test_cli_on_the_star(tmp_path, monkeypatch, capsys):
    from nanokappa_torch.cli import main

    pfile = tmp_path / "parameters.txt"
    pfile.write_text(" ".join(star_argv(tmp_path)))
    patch_lloyd(monkeypatch, STAR_CENTERS, equal_volumes=True)
    main(["-ff", str(pfile)])
    assert f"NOTE: running the v1 step (no fused drift kernel): {RADIAL_REASON}" in capsys.readouterr().out
    folder = str(tmp_path / "res_0")
    for name in ("arguments.txt", "convergence.txt", "particle_data.txt", "subvolumes.txt",
                 "subvol_connections.txt"):
        assert os.path.getsize(os.path.join(folder, name)) > 0, name

    def rows(name):
        with open(os.path.join(folder, name)) as f:
            return [line for line in f.read().splitlines() if not line.startswith("#")]

    sv = rows("subvolumes.txt")
    assert len(sv) == 12 and all(len(r.split(",")) == 13 for r in sv)
    con = rows("subvol_connections.txt")
    assert len(con) > 0 and all(len(r.split(",")) == 12 for r in con)
    T = np.array([float(r.split(",")[5]) for r in sv])
    assert np.all(T > 290.0) and np.all(T < 310.0)
    with open(os.path.join(folder, "convergence.txt")) as f:
        lines = f.read().splitlines()
    # time stamp, step, time, total energy, 4 per reservoir, N_p, then per
    # cell T, E, 3 flux components, N_p, then kappa per connection
    n_con = len(con)
    assert {len(line.split()) for line in lines[1:]} == {4 + 4 * 2 + 1 + 6 * 12 + n_con}
    part = np.loadtxt(os.path.join(folder, "particle_data.txt"), delimiter=",")
    assert abs(len(part) - 3000) < 300 and np.isfinite(part).all()


def test_driver_regrows_the_v1_event_window(tmp_path, monkeypatch, capsys):
    """The driver on the v1 step: no deferred RTA to finalise (the identity),
    and the frozen-storm regrow rebuilds the v1 runner with the wider event
    compaction, logging the reason again (nanokappa_tpu/driver.py:301-340)."""
    from nanokappa_torch.driver import Simulation
    from nanokappa_torch.io.config import read_args

    patch_lloyd(monkeypatch, STAR_CENTERS, equal_volumes=True)
    sim = Simulation(read_args(star_argv(tmp_path)))
    assert sim.route.v1_reason == RADIAL_REASON and sim.state.layout == "plain"
    assert sim._finalize(sim.state) is sim.state
    cur = sim.route.evt_cap
    assert cur == max(sim.params.inj_cap, sim.params.n_cap // 16)
    sim._rebuild_step(evt_cap=2 * cur)
    assert sim.route.evt_cap == 2 * cur
    assert capsys.readouterr().out.count(f"running the v1 step (no fused drift kernel): {RADIAL_REASON}") == 2
    sim.state, out = sim.run_steps(sim.state)
    assert int(out.lost[-1]) == 0 and sim.state.step == 100
