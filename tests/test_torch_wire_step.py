"""The nanowire end to end: the port's `build_step` (kernel A's triangle
cast and in-kernel diffuse reflection, 'constant' reservoirs) against the
JAX package's v1 step (`make_step`, as tests/test_fused.py:370-409 runs it)
on the 6^3 wire with 3000 particles.

Every side-wall hit diffuses (the octagon's walls have no specular partner
on this grid), with per-lane draws that differ between the packages, so
the comparison is statistical, from one initial state:
  * the first step's absorptions (n_leaving) are exact: both steps see the
    same lanes and positions;
  * the port's T_sv, averaged over steps 5-20, lies within 5 pooled
    standard deviations of the mean of three JAX v1 runs (seeds 3, 4, 5):
    the band the JAX runs' own spread gives;
  * nothing is lost and the population stays within 3% of the start.
The JAX v2 step on this wire (its Pallas kernel with the 32-triangle cast)
takes 30 s to compile for the CPU, beyond this file's time budget.
"""

import numpy as np

from torch_parity import WIRE, build_pair, jax_fields, np_


def test_wire_step_matches_jax_v1():
    import jax

    from nanokappa_tpu.sim.state import init_state as j_init
    from nanokappa_tpu.sim.step import make_step
    from nanokappa_torch.convert import state_from_jax
    from nanokappa_torch.sim.step import build_step

    j, t = build_pair(WIRE, mesh=(6, 6, 6), res_gen="constant", step_impl="v1")
    n_steps, skip = 20, 5
    run = build_step(t.geo, t.tabs, t.btab, t.rtab, t.params, n_inner=1, n_outer=n_steps)
    _, out = run(state_from_jax(jax_fields(j.state), "plain", device="cpu", seed=3))
    assert (np_(out.lost) == 0).all()
    assert np.abs(np_(out.N_p) - j.n_p).max() <= 0.03 * j.n_p
    T_port = np_(out.T_sv)[skip:].mean(axis=0)
    assert T_port[0] > T_port[-1]

    step = jax.jit(make_step(j.geo, j.tabs, j.btab, j.rtab, j.params))
    T_jax = []
    for seed in (3, 4, 5):
        js = j_init(j.mat, j.dom, j.geo, j.params, j.n_p, temp_dist="linear", seed=seed, btab=j.btab)
        Ts = []
        for k in range(n_steps):
            js, jo = step(js)
            if seed == 3 and k == 0:
                np.testing.assert_array_equal(np_(out.n_leaving[0]), np.asarray(jo.n_leaving))
            Ts.append(np.asarray(jo.T_sv))
        assert int(jo.lost) == 0
        T_jax.append(np.mean(Ts[skip:], axis=0))
    T_jax = np.array(T_jax)  # (3 runs, SV)
    sigma = np.sqrt(T_jax.var(axis=0, ddof=1).mean())  # pooled over subvolumes
    assert np.abs(T_port - T_jax.mean(axis=0)).max() <= 5.0 * sigma, (T_port, T_jax, sigma)
