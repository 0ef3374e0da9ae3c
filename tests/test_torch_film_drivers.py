"""The round's first done-criterion on the CPU (ROADMAP 1.1, its test
half): a small film parameter file (the 6^3 synthetic Si material, 3000
particles, 150 steps) through the JAX package's driver
(`nanokappa_tpu.driver.Simulation`) and the port's
(`nanokappa_torch.driver.Simulation`, on the CPU; two seeds, the JAX
driver one: its compiles take most of the file's time): T_sv,
kappa and the reservoirs' energy balance over the convergence window agree
within Monte Carlo noise, each run judged as tests/test_sim_box.py:89
judges the film. tests/test_torch_film_drivers_ge.py makes the Ge swap."""

from torch_parity import assert_drivers_agree, film_params_file, run_driver


def test_film_through_both_drivers(tmp_path):
    from nanokappa_tpu.material import write_synthetic_hdf5

    write_synthetic_hdf5(str(tmp_path / "mat"), mesh=(6, 6, 6))
    pf = film_params_file(tmp_path, str(tmp_path / "mat"), "kappa-m666.hdf5", steps=100)
    runs = {pkg: [run_driver(pkg, pf, str(tmp_path / f"{pkg}{s}"), s) for s in seeds]
            for pkg, seeds in (("jax", (0,)), ("torch", (0, 1)))}
    assert_drivers_agree(runs["jax"], runs["torch"])
