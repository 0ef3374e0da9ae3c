"""The perforated plate through the port's CLI on the CPU
(`python -m nanokappa_torch.cli -ff <file>` with `--device cpu`), against
the JAX driver's result layouts.

  * The CLI on the Voronoi plate (an STL path as --geometry, 8 Voronoi
    cells, 20 steps) writes every result file, subvolumes.txt in the
    non-slice columns and subvol_connections.txt one row per connection,
    in the JAX driver's columns.
The result layouts against the JAX driver's are
tests/test_torch_plate_layouts.py. The plate takes its fixed Lloyd centres
(torch_parity: PLATE_CENTERS).
"""

import os

import numpy as np
import pytest

from torch_parity import PLATE_CENTERS, patch_lloyd, perforated_plate


def plate_argv(tmp) -> list[str]:
    """The plate's CLI arguments, its STL and a synthetic 6^3 material
    folder written under `tmp`."""
    from nanokappa_torch.geometry import stl
    from nanokappa_torch.material import write_synthetic_hdf5

    matdir = str(tmp / "mat")
    os.makedirs(matdir)
    write_synthetic_hdf5(matdir, mesh=(6, 6, 6))
    path = str(tmp / "plate.stl")
    stl.save_stl(perforated_plate(), path)
    return [
        "--mat_folder", matdir, "--hdf_file", "kappa-m666.hdf5", "--poscar_file", "POSCAR",
        "--geometry", path, "--subvolumes", "voronoi", "8",
        "--bound_pos", "relative", "-0.1", "0.5", "0.5", "1.1", "0.5", "0.5",
        "--bound_cond", "T", "T", "R", "--bound_values", "304", "296", "5",
        "--connect_pos", "relative", "--temp_dist", "linear", "--temp_interp", "nearest",
        "--particles", "total", "3e3", "--timestep", "1", "--iterations", "20",
        "--n_mean", "5", "--reservoir_gen", "pooled", "--output", "screen",
    ]


@pytest.fixture(scope="module")
def plate_run(tmp_path_factory):
    from nanokappa_torch.cli import main

    tmp = tmp_path_factory.mktemp("plate_cli")
    argv = plate_argv(tmp)
    pfile = tmp / "parameters.txt"
    pfile.write_text(" ".join([*argv, "--results_folder", str(tmp / "res"), "--device", "cpu"]))
    with pytest.MonkeyPatch.context() as mp:
        patch_lloyd(mp)
        main(["-ff", str(pfile)])
    return str(tmp / "res_0"), argv


def _rows(folder, name):
    with open(os.path.join(folder, name)) as f:
        return [line for line in f.read().splitlines() if not line.startswith("#")]


def test_cli_on_the_voronoi_plate(plate_run):
    folder, _ = plate_run
    for name in ("arguments.txt", "convergence.txt", "particle_data.txt",
                 "subvolumes.txt", "subvol_connections.txt", "specular_correspondences.txt"):
        assert os.path.getsize(os.path.join(folder, name)) > 0, name
    sv = _rows(folder, "subvolumes.txt")
    assert len(sv) == 8 and all(len(r.split(",")) == 13 for r in sv)
    con = _rows(folder, "subvol_connections.txt")
    assert len(con) > 0 and all(len(r.split(",")) == 12 for r in con)
    centres = np.array([[float(x) for x in r.split(",")[1:4]] for r in sv])
    c = PLATE_CENTERS
    np.testing.assert_allclose(centres, c[np.lexsort((c[:, 2], c[:, 1], c[:, 0]))], rtol=1e-3)
    T = np.array([float(r.split(",")[5]) for r in sv])
    assert np.all(T > 295.9) and np.all(T < 304.1)
    part = np.loadtxt(os.path.join(folder, "particle_data.txt"), delimiter=",")
    assert abs(len(part) - 3000) < 300 and np.isfinite(part).all()


def test_voronoi_connections_follow_the_sorted_centres(tmp_path, monkeypatch):
    """The port sorts the Voronoi centres before it takes their volumes
    and connections, so subvol_connections.txt joins neighbouring cells;
    the JAX package sorts them after (ROADMAP queue 3), its connections
    index the unsorted centres."""
    from nanokappa_torch.geometry import domain as t_dom, stl
    from nanokappa_tpu.geometry import domain as j_dom

    path = str(tmp_path / "plate.stl")
    stl.save_stl(perforated_plate(), path)
    patch_lloyd(monkeypatch, PLATE_CENTERS[[3, 6, 0, 5, 1, 7, 2, 4]])  # Lloyd's order is arbitrary
    kw = dict(
        geometry=path, subvolumes=("voronoi", 8),
        bound_pos=("relative", -0.1, 0.5, 0.5, 1.1, 0.5, 0.5),
        bound_cond=("T", "T", "R"), bound_values=(304.0, 296.0, 5.0), connect_pos=("relative",),
    )
    dom, jdom = t_dom.build_domain(**kw), j_dom.build_domain(**kw)
    np.testing.assert_array_equal(dom.subvol_center, jdom.subvol_center)
    want = t_dom._nearest_connections(dom.subvol_center, dom.mesh)
    np.testing.assert_array_equal(dom.subvol_connections, want)
    assert not np.array_equal(jdom.subvol_connections, want)
    # each cell connects to a neighbour: no connection spans the plate
    c = dom.subvol_center
    span = np.linalg.norm(c[want[:, 0]] - c[want[:, 1]], axis=1)
    assert span.max() < 1500.0
