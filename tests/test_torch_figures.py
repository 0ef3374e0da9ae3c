"""The figures on the port (nanokappa_torch/visual.py, the JAX package's
visual.py): a port CLI run on the CPU writes the JAX CLI's figure set (the
material and geometry plots at start, the postprocess figures at the
end, the particle scatters under --fig_plot); `--postprocess FOLDER`
rebuilds from the folder's files alone the same figures that the JAX
package's `postprocess_folder` builds from them; both packages'
`read_convergence` read the port's convergence.txt alike; and
`read_args(tolerant=True)` skips flags it does not know (the port's
arguments.txt carries --device, which the JAX parser does not)."""

import os
import shutil

import numpy as np
import pytest


# the JAX CLI test's film (tests/test_cli.py make_params_file), on the CPU
PARAMS = """
--mat_folder       {mat}
--hdf_file         kappa-m444.hdf5
--poscar_file      POSCAR
--geometry         box
--dimensions       5e3 1e3 1e3
--subvolumes       slice 10 0
--bound_pos        relative -0.1 0.5 0.5 1.1 0.5 0.5 0.5 0.5 -0.1 0.5 0.5 1.1
--bound_cond       T T R R P
--connect_pos      relative 0.5 -0.1 0.5 0.5 1.1 0.5
--bound_values     302 298 0 0
--temp_dist        linear
--temp_interp      linear
--particles        total 5e3
--timestep         1
--iterations       100
--n_mean           5
--results_folder   {out}/res/film
--conv_crit        0 10
--fig_plot         energy T
--output           screen
--device           cpu
"""


@pytest.fixture(scope="module")
def port_folder(tmp_path_factory):
    from nanokappa_torch.cli import main
    from nanokappa_torch.material import write_synthetic_hdf5

    d = tmp_path_factory.mktemp("figs")
    write_synthetic_hdf5(str(d / "mat"), mesh=(4, 4, 4))
    p = d / "params.txt"
    p.write_text(PARAMS.format(mat=d / "mat", out=d))
    main(["-ff", str(p)])
    return str(d / "res" / "film_0")


def _pngs(folder):
    return sorted(f for f in os.listdir(folder) if f.endswith(".png"))


def test_cli_writes_the_jax_figure_set(port_folder):
    figs = _pngs(port_folder)
    for f in ("convergence_T.png", "convergence_kappa.png", "convergence_en_balance.png",
              "fig_energy.png", "fig_temperature.png", "k_contribution.png",
              "density_of_states.png", "BC_plot.png"):
        assert f in figs, (f, figs)
    for f in ("convergence.txt", "residue.txt", "subvolumes.txt", "particle_data.txt", "arguments.txt"):
        assert os.path.exists(os.path.join(port_folder, f)), f


def test_postprocess_rebuilds_what_the_jax_package_rebuilds(port_folder, tmp_path):
    from nanokappa_torch.cli import main
    from nanokappa_tpu.visual import postprocess_folder as j_postprocess

    jax_copy = tmp_path / "jax"
    port_copy = tmp_path / "port"
    for dst in (jax_copy, port_copy):
        os.makedirs(dst)
        for f in os.listdir(port_folder):
            if f.endswith(".txt"):
                shutil.copy(os.path.join(port_folder, f), dst)
    main(["--postprocess", str(port_copy)])
    j_postprocess(str(jax_copy), verbose=False)
    port, jax_ = _pngs(port_copy), _pngs(jax_copy)
    assert port == jax_ and "fig_energy.png" in port and "convergence_T.png" in port
    # a run's own postprocess wrote every figure the offline rebuild writes
    assert set(port) <= set(_pngs(port_folder))


def test_read_convergence_agrees(port_folder):
    from nanokappa_torch.visual import read_convergence
    from nanokappa_tpu.visual import read_convergence as j_read

    path = os.path.join(port_folder, "convergence.txt")
    a = read_convergence(path, 10, 2, "slice", 9)
    b = j_read(path, 10, 2, "slice", 9)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    assert len(a["T"]) == 10  # one datapoint every 10 steps


def test_read_args_tolerant_skips_unknown_flags(tmp_path):
    from nanokappa_torch.io.config import read_args

    p = tmp_path / "arguments.txt"
    p.write_text("--hdf_file k.hdf5\n--poscar_file POSCAR\n--rt_plot T omega\n--from_file gone.txt\n"
                 "--iterations 7\n--device cpu\n")
    args = read_args(["-ff", str(p)], tolerant=True)
    assert args.iterations == [7] and args.device == ["cpu"] and args.from_file == str(p)
    with pytest.raises(SystemExit):
        read_args(["-ff", str(p)])
