"""The driver's particle_data.txt checkpoint (nanokappa_torch/native.py
CheckpointFormatter, csrc/host_checkpoint.cpp) on the CPU.

  * The native pass over chunks of pool lanes writes np.savetxt's bytes
    (fmt "%d, %d, %.3f, %.3f, %.3f, %.6e") for the alive lanes, in lane
    order, at 1, 2, 3 and 8 threads and 0 to 200,003 rows, with dead lanes
    between alive ones, positions cast from float32 as the pool holds
    them, out-of-range modes clipped, the special values of
    tests/test_torch_driver.py::test_particle_rows_match_savetxt and the
    longest rows; also on the row-major layout of a sharded run's gather.
  * The thread rule: one thread on one core or below 65,536 lanes; the
    cgroup quota readers.
  * A small film through `Simulation` writes, after the header's date
    line, the bytes of the path it replaced (the whole pool on the host,
    the NumPy occupation and `format_particle_rows`), and `host_state()`'s
    arrays are those of the whole pool.
"""

import io

import numpy as np
import pytest

FMT = "%d, %d, %.3f, %.3f, %.3f, %.6e"
N_BRANCHES = 6
N_MODES = 400 * N_BRANCHES


def savetxt_rows(mode, pos, dev, alive, be_table) -> bytes:
    """np.savetxt's bytes over the alive lanes (the writer's reference)."""
    m = np.clip(mode, 0, len(be_table) - 1)[alive]
    cols = np.column_stack([
        m // N_BRANCHES, m % N_BRANCHES, np.asarray(pos, np.float64)[alive],
        np.asarray(dev, np.float64)[alive] + be_table[m],
    ])
    out = io.BytesIO()
    np.savetxt(out, cols, FMT)
    return out.getvalue()


def lanes_for(rows: int, seed: int):
    """Pool lanes holding `rows` alive particles, with dead lanes between
    them (dead lanes carry any mode bits); the special values up front."""
    rng = np.random.default_rng(seed)
    n = rows + rows // 3 + 5
    alive = np.zeros(n, bool)
    alive[np.sort(rng.choice(n, rows, replace=False))] = True
    mode = rng.integers(-5, N_MODES + 5, n).astype(np.int32)
    mode[alive] = rng.integers(0, N_MODES, rows)
    pos = (rng.normal(0, 1, (3, n)) * 10.0 ** rng.integers(-4, 5, (3, n))).astype(np.float32)
    dev = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-30, 3, n)).astype(np.float32)
    be = rng.random(N_MODES) * 10.0 ** rng.integers(-8, 2, N_MODES)
    be[0] = 1e-300
    be[1] = -0.0
    special = [
        # x, y, z, dev, mode
        (0.0, -0.0, 0.0005, 0.0, 0),  # occupation 1e-300
        (-0.0004, 1e4, -2.5e3, -0.0, 1),  # -0.000, occupation -0.0
        (0.0015, 0.0025, -0.0035, -1.5e2, 7),
        (3.4e38, -3.4e38, -1.1754944e-38, -3.4e38, N_MODES - 1),  # the longest row
        (1.0, 2.0, 3.0, 0.5, -3),  # an alive lane's mode out of range, both ways
        (1.0, 2.0, 3.0, 0.5, N_MODES + 2),
    ]
    live = np.flatnonzero(alive)
    for lane, (x, y, z, d, m) in zip(live, special):
        pos[:, lane] = (x, y, z)
        dev[lane] = d
        mode[lane] = m
    return mode, pos, dev, alive, be


ROWS = (0, 1, 7, 65_535, 65_537, 200_003)


@pytest.fixture(scope="module", params=ROWS, ids=[f"rows{r}" for r in ROWS])
def lanes(request):
    mode, pos, dev, alive, be = lanes_for(request.param, seed=request.param)
    return mode, pos, dev, alive, be, savetxt_rows(mode, pos.T, dev, alive, be)


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
def test_writer_matches_savetxt(lanes, threads):
    from nanokappa_torch.native import CheckpointFormatter

    mode, pos, dev, alive, be, ref = lanes
    fmt = CheckpointFormatter(be, N_BRANCHES)
    got = b"".join(bytes(part) for part in fmt(mode, pos.T, dev, alive, threads))
    assert got == ref


def test_writer_reads_a_gathered_layout():
    """A sharded run's rank 0 holds (N, 6) rows [mode, sv, x, y, z, dev],
    every one alive (driver.py _gather_host_state): the same bytes."""
    from nanokappa_torch.native import CheckpointFormatter

    mode, pos, dev, alive, be = lanes_for(65_537, seed=11)
    a = np.zeros((int(alive.sum()), 6), np.float32)
    a[:, 0] = mode[alive].view(np.float32)
    a[:, 2:5] = pos.T[alive]
    a[:, 5] = dev[alive]
    ref = savetxt_rows(mode[alive], pos.T[alive], dev[alive], np.ones(len(a), bool), be)
    fmt = CheckpointFormatter(be, N_BRANCHES)
    m = np.ascontiguousarray(a[:, 0]).view(np.int32)
    got = fmt(m, a[:, 2:5], a[:, 5], np.ones(len(a), bool), 3)
    assert b"".join(bytes(p) for p in got) == ref


def test_thread_rule():
    import os

    from nanokappa_torch.native import checkpoint_threads, usable_cores

    assert checkpoint_threads(1_277_952, 1) == 1  # an affinity of one core
    assert checkpoint_threads(65_535, 8) == checkpoint_threads(0, 8) == 1
    assert checkpoint_threads(65_537, 8) == 2
    assert checkpoint_threads(1_277_952, 8) == 8
    assert checkpoint_threads(10**8, 64) == 16
    assert 1 <= usable_cores() <= len(os.sched_getaffinity(0))


def test_cgroup_quota_readers(tmp_path):
    """A quota rounds up to whole cores; no quota reads None."""
    from nanokappa_torch.native import _cfs_quota, _cpu_max

    (tmp_path / "cpu.max").write_text("250000 100000\n")
    (tmp_path / "cpu.cfs_quota_us").write_text("50000\n")
    (tmp_path / "cpu.cfs_period_us").write_text("100000\n")
    assert _cpu_max(tmp_path) == 3 and _cfs_quota(tmp_path) == 1
    (tmp_path / "cpu.max").write_text("max 100000\n")
    (tmp_path / "cpu.cfs_quota_us").write_text("-1\n")
    assert _cpu_max(tmp_path) is None and _cfs_quota(tmp_path) is None


@pytest.fixture(scope="module")
def film(tmp_path_factory):
    from nanokappa_torch.driver import Simulation
    from nanokappa_torch.io.config import read_args
    from nanokappa_torch.material.synthetic import synthetic_material

    tmp = tmp_path_factory.mktemp("ckpt")
    argv = [
        "--hdf_file", "kappa-m666.hdf5", "--poscar_file", "POSCAR",
        "--geometry", "box", "--dimensions", "2e3", "1e3", "1e3", "--subvolumes", "slice", "5", "0",
        "--bound_pos", "relative", "-0.1", "0.5", "0.5", "1.1", "0.5", "0.5",
        "0.5", "0.5", "-0.1", "0.5", "0.5", "1.1",
        "--bound_cond", "T", "T", "R", "R", "P", "--bound_values", "302", "298", "0", "0",
        "--connect_pos", "relative", "0.5", "-0.1", "0.5", "0.5", "1.1", "0.5",
        "--particles", "total", "4e3", "--timestep", "1", "--iterations", "20",
        "--reservoir_gen", "pooled", "--results_folder", str(tmp / "res"),
        "--output", "screen", "--device", "cpu",
    ]
    sim = Simulation(read_args(argv), material=synthetic_material(mesh=(6, 6, 6)))
    sim.run(verbose=False)
    return sim


def test_simulation_checkpoint_matches_the_numpy_path(film):
    """particle_data.txt after 20 steps: the header but its date line, and
    every row, as the whole-pool NumPy path formats them; the checkpoint's
    three phases timed inside `write_state`, on one thread."""
    import os

    from nanokappa_torch.material.tables import bose_einstein
    from nanokappa_torch.native import format_particle_rows
    from nanokappa_torch.sim.state import C_ALIVE, C_DEV, C_MODE

    sim = film
    mat = sim.material
    pool = sim._finalize(sim.state).pool.cpu().numpy()
    alive = pool[C_ALIVE] > 0.5
    mode = np.clip(pool[C_MODE].view(np.int32), 0, mat.n_modes - 1)
    q, j = mat.mode_to_qj(mode[alive])
    occ = pool[C_DEV].astype(float) + bose_einstein(
        sim.params.t_reference, mat.omega.reshape(-1)[mode]
    )
    body = bytes(format_particle_rows(q, j, pool[0:3].T[alive], occ[alive]))
    assert alive.sum() > 3000

    with open(os.path.join(sim.folder, "particle_data.txt"), "rb") as f:
        lines = f.read().split(b"\n", 4)
    assert lines[0] == b"# Particles final state data "
    assert lines[1].startswith(b"# Date and time: ")
    assert lines[2] == b"# hdf file = ['kappa-m666.hdf5'], POSCAR file = ['POSCAR']"
    assert lines[3] == b"# q-point, branch, pos x [angs], pos y [angs], pos z [angs], occupation"
    assert lines[4] == body

    calls = sim.timer.calls
    for sub in ("write_state.copy", "write_state.format", "write_state.write"):
        assert len(calls[sub]) == len(calls["write_state"]) == 1
    assert sum(calls[s][0] for s in ("write_state.copy", "write_state.format",
                                     "write_state.write")) <= calls["write_state"][0]
    assert sim.checkpoint_threads == 1  # fewer than 65,536 lanes
    assert "checkpoint_threads" in sim.timer.report(checkpoint_threads=sim.checkpoint_threads)


def test_host_state_reads_the_whole_pool(film):
    """host_state()'s arrays, from the narrow host copy, equal those the
    whole pool gives, bit for bit, and so do the occupations."""
    from nanokappa_torch.material.tables import bose_einstein
    from nanokappa_torch.sim.state import C_ALIVE, C_DEV, C_MODE, C_SV

    sim = film
    s = sim._finalize(sim.state)
    pool = s.pool.cpu().numpy()
    h = sim.host_state()
    np.testing.assert_array_equal(h.alive, pool[C_ALIVE] > 0.5)
    for got, want in ((h.mode, pool[C_MODE].view(np.int32)),
                      (h.sv_col, pool[C_SV].view(np.int32)),
                      (h.dev, pool[C_DEV]), (h.pos, pool[0:3].T)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(h.T_sv, s.T_sv.cpu().numpy())
    # occupation_of reads the driver's table: the elementwise values
    mode = np.clip(h.mode, 0, sim.material.n_modes - 1)
    want = pool[C_DEV].astype(float) + bose_einstein(
        sim.params.t_reference, sim.material.omega.reshape(-1)[mode]
    )
    assert sim.occupation_of(h).tobytes() == want.tobytes()
