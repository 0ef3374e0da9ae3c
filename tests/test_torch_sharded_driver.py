"""The film parameter file (tests/torch_parity.py:film_params_file, 3000
particles, 100 steps) with `--n_shards 2` through the JAX package's driver
(2 of conftest's 8 virtual devices) and the port's CLI
(`python -m nanokappa_torch.cli -ff FILE` with `--device cpu`: two gloo
ranks, spawned once, running beside the JAX driver): the convergence
windows agree as tests/test_torch_film_drivers.py holds them, only rank 0
writes the result files, and particle_data.txt holds every rank's
particles."""

import multiprocessing
import os
import threading

import numpy as np

from torch_parity import assert_drivers_agree, film_params_file, run_driver


def window(folder: str, n_res: int, n_sv: int, n: int = 10) -> dict:
    """run_driver's statistics (T, kappa, eb) of the last n rows of a
    slice run's convergence.txt, with its last row's N_p and lost count."""
    rows = [ln.split() for ln in open(os.path.join(folder, "convergence.txt")) if not ln.startswith("#")]
    a = np.array([[float(x) for x in r[1:]] for r in rows[-n:]])
    eb = a[:, 3:3 + n_res]
    i_np = 3 + 4 * n_res
    T = a[:, i_np + 1:i_np + 1 + n_sv]

    def stat(x):
        return x.mean(0), x.std(0, ddof=1) / np.sqrt(len(x))

    return dict(T=stat(T), kappa=stat(a[:, -1]), eb=stat(eb), N_p=int(a[-1, i_np]), rows=len(rows))


def test_film_two_shards_through_both_drivers(tmp_path):
    from nanokappa_tpu.material import write_synthetic_hdf5
    from nanokappa_torch import cli

    write_synthetic_hdf5(str(tmp_path / "mat"), mesh=(6, 6, 6))
    pf = film_params_file(tmp_path, str(tmp_path / "mat"), "kappa-m666.hdf5", steps=100)
    text = open(pf).read()
    jf, tf = str(tmp_path / "jax.txt"), str(tmp_path / "torch.txt")
    with open(jf, "w") as f:
        f.write(text + "--n_shards 2\n")
    with open(tf, "w") as f:
        f.write(text + f"--n_shards 2\n--device cpu\n--seed 0\n--output file\n"
                       f"--results_folder {tmp_path / 'port'}\n")
    err = []

    def port():
        try:
            cli.main(["-ff", tf])
        except BaseException as e:  # re-raised below, in the test's thread
            err.append(e)

    th = threading.Thread(target=port)
    th.start()
    run_j = run_driver("jax", jf, str(tmp_path / "jax"), 0)
    th.join(timeout=120)
    hung = th.is_alive()
    if hung:  # stop the CLI's ranks, or they hold their cores past the test
        for p in multiprocessing.active_children():
            p.kill()
    assert not hung
    if err:
        raise err[0]

    (folder,) = [str(p) for p in (tmp_path / "port").parent.glob("port_*")]
    w = window(folder, n_res=2, n_sv=5)
    run_t = dict(w, bulk=run_j["bulk"], lost=0)
    assert_drivers_agree([run_j], [run_t])

    # one writer: one header and 10 rows of convergence, one residue row
    # (the check at step 100), one output
    conv = open(os.path.join(folder, "convergence.txt")).read().splitlines()
    assert sum(ln.startswith("#") for ln in conv) == 1 and w["rows"] == 10
    assert len(open(os.path.join(folder, "residue.txt")).read().splitlines()) == 1
    out = open(os.path.join(folder, "output.txt")).read()
    assert out.count("Simulation finished") == 1 and "Particle shards: 2 ranks" in out
    lost = [ln for ln in out.splitlines() if "WARNING: lost" in ln]
    assert not lost, lost
    # particle_data.txt: every rank's alive particles, gathered to rank 0
    lines = open(os.path.join(folder, "particle_data.txt")).read().splitlines()
    body = [ln for ln in lines if not ln.startswith("#")]
    assert len(body) == w["N_p"] > 0.9 * 3000
    for name in ("arguments.txt", "subvolumes.txt", "specular_correspondences.txt"):
        assert os.path.exists(os.path.join(folder, name)), name
