"""The film slice end to end: the port's `build_step` against the JAX
package's step on the same configuration.

  * Deterministic: the eta = 0 film without reservoirs (P/R/R/P: periodic x
    and z, specular y walls) from one converted initial state with a
    temperature gradient, 4 steps through the port and through the JAX v2
    step (its Pallas kernels in interpret mode). Lanes without a mirror
    partner still diffuse with per-lane draws, so the tolerances are those
    of tests/test_fused.py::test_v2_mirror_specular_matches_v1: T_sv to
    rtol 1e-4, Np_sv to 3 particles, nothing lost.
  * Statistical: the full film (T/T/R/R/P, pooled reservoirs) for 20 steps
    through the port and through the JAX v1 step with 3 seeds. The port's
    time-averaged T_sv must sit within 5 pooled standard deviations of the
    JAX seeds' mean (the band the JAX seeds' own spread gives), with the
    population conserved to 5%, a hot-to-cold gradient and nothing lost.
"""

import numpy as np
import torch

from torch_parity import CLOSED_FILM, FILM_FULL, build_pair, jax_fields, np_


def test_slice_deterministic_matches_jax_v2():
    import jax

    from nanokappa_tpu.sim.step import make_step
    from nanokappa_torch.convert import state_from_jax
    from nanokappa_torch.sim.step import build_step

    j, t = build_pair(
        CLOSED_FILM, temp_dist="custom", subvol_temp=(299.0, 299.5, 300.0, 300.5, 301.0),
    )
    state = state_from_jax(jax_fields(j.state), "slim", device="cpu", seed=3)
    run = build_step(t.geo, t.tabs, t.btab, t.rtab, t.params, n_inner=1, n_outer=4)
    _, out = run(state)

    step = jax.jit(make_step(j.geo, j.tabs, j.btab, j.rtab, j.params))
    js = j.state
    for k in range(4):
        js, jo = step(js)
        np.testing.assert_allclose(np_(out.T_sv[k]), np.asarray(jo.T_sv), rtol=1e-4, err_msg=f"T_sv step {k}")
        np.testing.assert_allclose(np_(out.Np_sv[k]), np.asarray(jo.Np_sv), atol=3, err_msg=f"Np_sv step {k}")
        assert int(out.lost[k]) == 0 and int(jo.lost) == 0
    assert int(out.N_p[-1]) == j.n_p  # closed box: every particle stays


def test_slice_statistics_match_jax_v1():
    import dataclasses

    from nanokappa_tpu.sim.state import init_state as j_init
    from nanokappa_tpu.sim.step import build_step as j_build
    from nanokappa_torch.sim.step import build_step

    j, t = build_pair(FILM_FULL, n_p=4000, n_cap=8192, step_impl="v1", seed=0)
    n_steps, tail = 20, 10
    run = build_step(t.geo, t.tabs, t.btab, t.rtab, t.params, n_inner=1, n_outer=n_steps)
    _, out = run(t.state)
    T_port = np_(out.T_sv[-tail:]).mean(axis=0)
    N_p = np_(out.N_p)
    assert (np_(out.lost) == 0).all()
    assert np.abs(N_p - t.n_p).max() <= 0.05 * t.n_p
    assert T_port[0] > T_port[-1]

    jrun = j_build(j.geo, j.tabs, j.btab, j.rtab, j.params, n_inner=1, n_outer=n_steps)
    T_jax = []
    for seed in (1, 2, 3):
        js = j_init(j.mat, j.dom, j.geo, j.params, j.n_p, temp_dist="linear", seed=seed, btab=j.btab)
        _, jo = jrun(js)
        assert int(np.asarray(jo.lost)[-1]) == 0
        T_jax.append(np.asarray(jo.T_sv)[-tail:].mean(axis=0))
    T_jax = np.array(T_jax)  # (3 seeds, SV)
    mean = T_jax.mean(axis=0)
    sigma = np.sqrt(T_jax.var(axis=0, ddof=1).mean())  # pooled over subvolumes
    assert np.abs(T_port - mean).max() <= 5.0 * sigma, (T_port, mean, sigma)


def test_finalize_and_tau_refresh_match_jax():
    """The pending deferred RTA (make_finalize) and the slope-form lifetime
    refresh after a temperature jump across grid bins (refresh_tau_T), on
    one converted state. Occupations to 2e-6 of their scale (float32
    exp/expm1 rounding in two frameworks); lifetimes to float32 rounding."""
    import dataclasses

    import jax.numpy as jnp

    from nanokappa_tpu.sim.fused import (
        from_transposed, make_finalize as j_final, refresh_tau_T as j_refresh,
        to_transposed,
    )
    from nanokappa_torch.convert import state_from_jax
    from nanokappa_torch.sim.fused import make_finalize, refresh_tau_T

    j, t = build_pair(CLOSED_FILM, temp_dist="custom", subvol_temp=(299.0, 299.5, 300.0, 300.5, 301.0))
    js = dataclasses.replace(j.state, step=jnp.asarray(1, jnp.int32))
    ts = state_from_jax(jax_fields(js), "slim", device="cpu")
    jf = np.asarray(j_final(j.geo, j.tabs, j.params, btab=j.btab)(js).dev)
    tf = np_(make_finalize(t.geo, t.tabs, t.params)(ts).dev)
    np.testing.assert_allclose(tf, jf, rtol=2e-6, atol=2e-6 * np.abs(jf).max())
    assert np.abs(tf - np_(ts.dev)).max() > 0  # the RTA did act

    T_new = np.array([281.0, 295.0, 300.0, 305.0, 319.0], np.float32)
    jT = dataclasses.replace(to_transposed(js, combined=True, slim=True), T_sv=jnp.asarray(T_new))
    jr = from_transposed(j_refresh(jT, j.geo, j.tabs, j.params, use_mirror=True), flip_axis=1)
    ts.T_sv = torch.as_tensor(T_new)
    refresh_tau_T(ts, t.geo, t.tabs, t.params)
    alive = np.asarray(jr.alive)
    np.testing.assert_allclose(np_(ts.tau)[alive], np.asarray(jr.tau)[alive], rtol=1e-6)
    np.testing.assert_allclose(np_(ts.pool[17])[alive], np.asarray(jr.mirror)[alive, 6], rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(jr.mirror)[:, 6]).max())
