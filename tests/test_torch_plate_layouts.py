"""The perforated plate's result layouts against the JAX driver's: for the
same CLI arguments (tests/test_torch_plate_cli.py:plate_argv),
convergence.txt's header (per-connection kappa columns) is the JAX
driver's, string for string, and a residue.txt row from the same window of
two datapoints is the JAX driver's, string for string. Both packages take
the plate's fixed Lloyd centres (torch_parity: PLATE_CENTERS); the JAX
domain reuses the port's subvolume volumes.
"""

import os

import numpy as np

from test_torch_plate_cli import plate_argv
from torch_parity import patch_lloyd


def test_plate_layouts_match_jax_driver(tmp_path, monkeypatch):
    from nanokappa_tpu.driver import Simulation as JSimulation
    from nanokappa_tpu.geometry import domain as jdom_mod
    from nanokappa_tpu.io.config import generate_results_folder, read_args as j_read_args
    from nanokappa_torch.driver import N_DT_TO_CONV, Simulation, host_outputs
    from nanokappa_torch.io.config import read_args
    from nanokappa_torch.sim.step import build_step

    argv = plate_argv(tmp_path)
    patch_lloyd(monkeypatch)
    sim = Simulation(read_args(argv + ["--iterations", "10", "--results_folder", str(tmp_path / "port"),
                                       "--device", "cpu"]))
    monkeypatch.setattr(jdom_mod, "_mc_subvol_volume", lambda *a, **k: sim.domain.subvol_volume.copy())
    jsim = JSimulation(generate_results_folder(
        j_read_args(argv + ["--iterations", "10", "--results_folder", str(tmp_path / "jax")])
    ))
    np.testing.assert_array_equal(jsim.domain.subvol_connections, sim.domain.subvol_connections)
    with open(os.path.join(sim.folder, "convergence.txt")) as f:
        port_header = f.readline()
    with open(os.path.join(jsim.folder, "convergence.txt")) as f:
        assert f.readline() == port_header
    assert "K Con" in port_header

    # one residue row from the same window (two datapoints of the port's
    # 1-datapoint runner) in both drivers
    tail = build_step(sim.geo, sim.mtab, sim.btab, sim.rtab, sim.params, n_inner=N_DT_TO_CONV)
    rows = []
    for _ in range(2):
        sim.state, out = tail(sim.state)
        rows.append(sim._observe(host_outputs(out)))
    for s in (sim, jsim):
        s.window.clear()
        s.window.extend(rows)
        s.old_mean = None
        s._update_residue()
    lines = [open(os.path.join(f, "residue.txt")).read().splitlines()[-1]
             for f in (sim.folder, jsim.folder)]
    assert lines[0] == lines[1]
    n_con = len(sim.domain.subvol_connections)
    assert len(lines[0].split()) == 8 + 3 * 8 + 2 + n_con  # T, phi xyz, reservoirs, kappa per connection
