"""The port's driver and CLI (nanokappa_torch.driver / .cli) on the CPU.

  * The CLI end to end on a small film read from a synthetic hdf5 folder
    (`write_synthetic_hdf5(mesh=(6, 6, 6))`), 110 steps (one 100-step batch
    and the 1-datapoint tail): every result file is written, the profile
    converges to a gradient, and arguments.txt replays through read_args.
  * convergence.txt's header is the JAX driver's, string for string, for
    the same arguments, and a residue.txt row from the same window is the
    JAX driver's, string for string.
  * The frozen-storm regrow: the event window doubles, the runners are
    rebuilt and the state runs on (tests/test_driver_features.py
    ::test_evt_cap_regrow).
  * particle_data.txt's native row formatter writes np.savetxt's bytes.
"""

import os

import numpy as np
import pytest

ARGV = [
    "--hdf_file", "kappa-m666.hdf5", "--poscar_file", "POSCAR", "--geometry", "box",
    "--dimensions", "2e3", "1e3", "1e3", "--subvolumes", "slice", "5", "0",
    "--bound_pos", "relative", "-0.1", "0.5", "0.5", "1.1", "0.5", "0.5",
    "0.5", "0.5", "-0.1", "0.5", "0.5", "1.1",
    "--bound_cond", "T", "T", "R", "R", "P", "--bound_values", "302", "298", "0", "0",
    "--connect_pos", "relative", "0.5", "-0.1", "0.5", "0.5", "1.1", "0.5",
    "--temp_dist", "linear", "--temp_interp", "nearest", "--particles", "total", "3e3",
    "--timestep", "1", "--iterations", "110", "--n_mean", "5", "--conv_crit", "0", "10",
    "--reservoir_gen", "pooled", "--output", "screen",
]


@pytest.fixture(scope="module")
def matdir(tmp_path_factory):
    from nanokappa_torch.material import write_synthetic_hdf5

    d = str(tmp_path_factory.mktemp("mat"))
    write_synthetic_hdf5(d, mesh=(6, 6, 6))
    return d


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory, matdir):
    from nanokappa_torch.cli import main

    tmp = tmp_path_factory.mktemp("run")
    pfile = tmp / "parameters.txt"
    pfile.write_text(
        " ".join(["--mat_folder", matdir, *ARGV, "--results_folder", str(tmp / "res"),
                  "--device", "cpu"])
    )
    main(["-ff", str(pfile)])
    return str(tmp / "res_0")


def test_cli_end_to_end(cli_run):
    from nanokappa_torch.io.config import read_args

    folder = cli_run
    for name in ("arguments.txt", "convergence.txt", "residue.txt", "particle_data.txt",
                 "subvolumes.txt", "specular_correspondences.txt"):
        assert os.path.exists(os.path.join(folder, name)), name
    rows = np.loadtxt(os.path.join(folder, "convergence.txt"), usecols=range(1, 6 + 2 * 3 + 1))
    assert rows.shape[0] == 11 and rows[-1, 0] == 110  # 10 batched datapoints + the tail
    T = np.loadtxt(os.path.join(folder, "subvolumes.txt"), delimiter=",")[:, 5]
    assert np.all(T > 297) and np.all(T < 303) and T[0] > T[-1]
    part = np.loadtxt(os.path.join(folder, "particle_data.txt"), delimiter=",")
    assert abs(len(part) - 3000) < 300 and np.isfinite(part).all()
    args = read_args(["-ff", os.path.join(folder, "arguments.txt")])
    assert args.device == ["cpu"] and args.particles == ["total", "3e3"]
    # the indexed folder replays
    assert [os.path.realpath(f) for f in args.results_folder] == [os.path.realpath(folder)]


def test_result_layouts_match_jax_driver(cli_run, matdir, tmp_path):
    from nanokappa_tpu.driver import Simulation as JSimulation
    from nanokappa_tpu.io.config import generate_results_folder, read_args as j_read_args
    from nanokappa_torch.driver import Simulation, host_outputs
    from nanokappa_torch.io.config import read_args

    argv = ["--mat_folder", matdir, *ARGV, "--iterations", "10"]
    jsim = JSimulation(generate_results_folder(j_read_args(argv + ["--results_folder", str(tmp_path / "jax")])))
    with open(os.path.join(cli_run, "convergence.txt")) as f:
        port_header = f.readline()
    with open(os.path.join(jsim.folder, "convergence.txt")) as f:
        assert f.readline() == port_header

    # one residue row from the same window (two datapoints of the port's
    # 1-datapoint runner) in both drivers
    sim = Simulation(read_args(argv + ["--results_folder", str(tmp_path / "port"), "--device", "cpu"]))
    sim.run(verbose=False)
    rows = []
    for _ in range(2):
        sim.state, out = sim._run_tail(sim.state)
        rows.append(sim._observe(host_outputs(out)))
    for s in (sim, jsim):
        s.window.clear()
        s.window.extend(rows)
        s.old_mean = None
        s._update_residue()
    lines = [open(os.path.join(f, "residue.txt")).read().splitlines()[-1]
             for f in (sim.folder, jsim.folder)]
    assert lines[0] == lines[1]
    assert len(lines[0].split()) == 3 * 5 + 2  # T, phi, kappa per slice; 2 reservoirs


def test_evt_cap_regrow(tmp_path, matdir):
    from nanokappa_torch.driver import Simulation
    from nanokappa_torch.io.config import read_args
    from nanokappa_torch.sim.fused import event_window

    argv = [
        "--mat_folder", matdir, "--hdf_file", "kappa-m666.hdf5", "--poscar_file", "POSCAR",
        "--geometry", "box", "--dimensions", "5e3", "1e3", "1e3", "--subvolumes", "slice", "5", "0",
        "--bound_pos", "relative", "-0.1", "0.5", "0.5", "1.1", "0.5", "0.5",
        "--bound_cond", "T", "T", "P", "--bound_values", "302", "298",
        "--connect_pos", "relative", "0.5", "-0.1", "0.5", "0.5", "1.1", "0.5",
        "0.5", "0.5", "-0.1", "0.5", "0.5", "1.1",
        "--particles", "total", "3e3", "--timestep", "1", "--iterations", "20",
        "--results_folder", str(tmp_path / "res"), "--output", "screen", "--device", "cpu",
    ]
    sim = Simulation(read_args(argv))
    sim.run(verbose=False)
    old = event_window(sim.geo, sim.mtab, sim.btab, sim.params)
    # a storm: more than 1% of the pool frozen in the last 100 steps
    sim._regrow_if_frozen(dict(frozen=sim.params.n_cap // 50))
    assert sim.params.evt_cap == min(2 * old, sim.params.n_cap // 4) and sim.evt_regrows == 1
    assert sim._run_tail is None  # the tail runner is rebuilt on demand
    sim.args.iterations = [40]
    row = sim.run(verbose=False)  # 20 more steps on the rebuilt runner
    assert sim.current_timestep == 40
    assert np.all(row["T"] > 290) and np.all(row["T"] < 310)
    assert abs(row["N_p"] - 3000) < 300


def test_particle_rows_match_savetxt():
    import io

    from nanokappa_torch.native import format_particle_rows

    rng = np.random.default_rng(5)
    n = 2000
    qj = np.stack([rng.integers(0, 30000, n), rng.integers(0, 6, n)], axis=1)
    pos = rng.normal(0, 1, (n, 3)) * 10.0 ** rng.integers(-4, 5, (n, 3))
    occ = rng.normal(0, 1, n) * 10.0 ** rng.integers(-30, 3, n)
    pos[:4] = [[0.0, -0.0, 0.0005], [-0.0004, 1e4, -2.5e3], [0.0015, 0.0025, -0.0035], [1.0, 2.0, 3.0]]
    occ[:4] = [0.0, -0.0, 1e-300, -1.5e2]
    ref = io.BytesIO()
    np.savetxt(ref, np.hstack((qj, pos, occ[:, None])), "%d, %d, %.3f, %.3f, %.3f, %.6e")
    assert bytes(format_particle_rows(qj[:, 0], qj[:, 1], pos, occ)) == ref.getvalue()
