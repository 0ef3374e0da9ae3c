"""The k film through the port's CLI on the full 24-row mirror layout, on
the CPU (`--device cpu`), with the boundary tables of
tests/torch_parity.py:craft_kmirror (the driver builds the k tables from
the material; at this grid their own map covers too few wall-incident
modes for the mirror gate, so the driver's build_boundary_tables is wrapped).

  * `python -m nanokappa_torch.cli -ff <file> --bound_scat k` on a small
    film, 110 steps: the tables it ran on put it on the full layout, every
    result file is written, convergence.txt holds the 100-step batch and
    the tail, the profile falls from hot to cold inside the reservoirs'
    range, and particle_data.txt holds the population.
  * Resuming from that particle_data.txt (`--part_dist <file>`) through
    `Simulation`: the state is on the full layout with every particle of
    the file, its cache filled again with the degenerate split drawn (the
    share of partnered caches that took the branch is 1/2 within 4
    binomial standard deviations), and it runs on.
"""

import os

import numpy as np
import pytest

from test_torch_driver import ARGV
from torch_parity import craft_kmirror, split_share

KARGV = [*ARGV, "--bound_scat", "k"]


@pytest.fixture(scope="module")
def kcli(tmp_path_factory):
    from nanokappa_torch import driver
    from nanokappa_torch.cli import main
    from nanokappa_torch.material import write_synthetic_hdf5
    from nanokappa_torch.sim.boundary_tables import build_boundary_tables

    mp = pytest.MonkeyPatch()
    built = []

    def crafted(mat, dom, scat_model="velocity", device=None):
        btab = craft_kmirror(build_boundary_tables(mat, dom, scat_model, device=device),
                             build_boundary_tables(mat, dom, "velocity", device=device))
        built.append(btab)
        return btab

    mp.setattr(driver, "build_boundary_tables", crafted)
    tmp = tmp_path_factory.mktemp("krun")
    matdir = str(tmp / "mat")
    write_synthetic_hdf5(matdir, mesh=(6, 6, 6))
    pfile = tmp / "parameters.txt"
    pfile.write_text(" ".join(["--mat_folder", matdir, *KARGV, "--results_folder",
                               str(tmp / "res"), "--device", "cpu"]))
    main(["-ff", str(pfile)])
    yield str(tmp / "res_0"), matdir, built
    mp.undo()


def test_cli_kfilm_full_mirror(kcli):
    from nanokappa_torch.material import load_material
    from nanokappa_torch.geometry.device import build_device_geometry
    from nanokappa_torch.io.config import read_args
    from nanokappa_torch.sim.fused import build_route

    folder, matdir, built = kcli
    args = read_args(["-ff", os.path.join(folder, "arguments.txt")])
    assert args.bound_scat == ["k"]
    mat = load_material(matdir, "kappa-m666.hdf5", "POSCAR")
    from nanokappa_torch.driver import Simulation

    sim = Simulation(args, material=mat)  # the same configuration, not run
    assert build_route(sim.geo, built[0], sim.params, sim.mtab).layout == "full"
    assert sim.state.layout == "full"
    for name in ("arguments.txt", "convergence.txt", "residue.txt", "particle_data.txt",
                 "subvolumes.txt", "specular_correspondences.txt"):
        assert os.path.exists(os.path.join(folder, name)), name
    rows = np.loadtxt(os.path.join(folder, "convergence.txt"), usecols=range(1, 6 + 2 * 3 + 1))
    assert rows.shape[0] == 11 and rows[-1, 0] == 110
    T = np.loadtxt(os.path.join(folder, "subvolumes.txt"), delimiter=",")[:, 5]
    assert np.all(T > 298) and np.all(T < 302) and T[0] > T[-1]
    part = np.loadtxt(os.path.join(folder, "particle_data.txt"), delimiter=",")
    assert abs(len(part) - 3000) < 300 and np.isfinite(part).all()


def test_resume_refills_the_mirror_cache(kcli, tmp_path):
    from nanokappa_torch.driver import Simulation
    from nanokappa_torch.io.config import read_args
    from nanokappa_torch.material import load_material

    folder, matdir, built = kcli
    pdata = os.path.join(folder, "particle_data.txt")
    n_file = len(np.loadtxt(pdata, delimiter=","))
    argv = ["--mat_folder", matdir, *KARGV, "--results_folder", str(tmp_path / "res"),
            "--device", "cpu", "--part_dist", pdata]
    argv[argv.index("--iterations") + 1] = "10"
    sim = Simulation(read_args(argv), material=load_material(matdir, "kappa-m666.hdf5", "POSCAR"))
    assert sim.state.layout == "full"
    assert int(sim.state.alive.sum()) == n_file
    n, k = split_share(sim.state, built[-1], sim.mtab)
    assert n > 0 and abs(k - n / 2) <= 4 * np.sqrt(n / 4), (n, k)
    sim.run(verbose=False)
    lost = sim.window[-1]["lost_split"]
    assert sum(lost) == 0 and abs(int(sim.window[-1]["N_p"]) - n_file) < 0.1 * n_file
