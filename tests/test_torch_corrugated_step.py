"""The corrugated wire of examples/corrugated_wire.txt end to end: the
port's fused step (kernel A's triangle cast over 120 triangles and its
in-kernel diffuse reflection on 40 wall-table rows, the partner mask in two
words; the k model, 'constant' reservoirs) against the JAX package's v1
step (`make_step`, XLA) on the 6^3 material with 3000 particles, from one
converted initial state. The JAX package's fused step does not reflect
in-kernel past its 8-row diffuse pool (it exports every rough hit), and
its Pallas triangle cast compiles for minutes on the CPU.

Per-lane draws differ between the packages, so the comparison is
statistical: the port's T_sv, averaged over steps 4-16, lies within 5
pooled standard deviations of the mean of three JAX v1 runs (seeds 3, 4,
5), and so do its absorptions (n_leaving summed over the steps: a lane
reflected near a cap reaches it within the first step, so even step 1's
counts follow the packages' own draws); nothing is lost and the
population stays within 3% of the start."""

import numpy as np

from torch_parity import CORRUGATED, build_pair, jax_fields, np_


def test_corrugated_wire_step_matches_jax_v1():
    import jax

    from nanokappa_tpu.sim.state import init_state as j_init
    from nanokappa_tpu.sim.step import make_step
    from nanokappa_torch.convert import state_from_jax
    from nanokappa_torch.ops.megastep import mega_config
    from nanokappa_torch.sim.fused import dkern_active, event_window, v2_eligible
    from nanokappa_torch.sim.step import build_step

    j, t = build_pair(CORRUGATED, mesh=(6, 6, 6), res_gen="constant", step_impl="v1", scat_model="k")
    assert t.btab.n_rows == 40 and v2_eligible(t.geo, t.params)
    assert dkern_active(t.geo, t.btab, t.params, t.tabs)
    cfg = mega_config(t.geo, t.tabs, t.btab, t.params, event_window(t.geo, t.tabs, t.btab, t.params))
    assert cfg.cmask_w == 2 and cfg.tris.shape[0] == 120
    n_steps, skip = 16, 4
    run = build_step(t.geo, t.tabs, t.btab, t.rtab, t.params, n_inner=1, n_outer=n_steps)
    state, out = run(state_from_jax(jax_fields(j.state), "plain", device="cpu", seed=3))
    assert int(state.kernel_events[0]) > 0  # kernel A's in-kernel diffuse re-emissions
    assert (np_(out.lost) == 0).all()
    assert np.abs(np_(out.N_p) - j.n_p).max() <= 0.03 * j.n_p
    T_port = np_(out.T_sv)[skip:].mean(axis=0)
    assert T_port[0] > T_port[-1]

    step = jax.jit(make_step(j.geo, j.tabs, j.btab, j.rtab, j.params))
    T_jax, L_jax = [], []
    for seed in (3, 4, 5):
        js = j_init(j.mat, j.dom, j.geo, j.params, j.n_p, temp_dist="linear", seed=seed, btab=j.btab)
        Ts, Ls = [], []
        for k in range(n_steps):
            js, jo = step(js)
            Ts.append(np.asarray(jo.T_sv))
            Ls.append(np.asarray(jo.n_leaving))
        assert int(jo.lost) == 0
        T_jax.append(np.mean(Ts[skip:], axis=0))
        L_jax.append(np.sum(Ls, axis=0))
    T_jax = np.array(T_jax)  # (3 runs, SV)
    sigma = np.sqrt(T_jax.var(axis=0, ddof=1).mean())  # pooled over subvolumes
    assert np.abs(T_port - T_jax.mean(axis=0)).max() <= 5.0 * sigma, (T_port, T_jax, sigma)
    L_jax = np.array(L_jax)  # (3 runs, R)
    L_port = np_(out.n_leaving).sum(axis=0)
    # Poisson-like counts: their own variance, and the runs' spread
    s_L = np.sqrt(np.maximum(L_jax.var(axis=0, ddof=1), L_jax.mean(axis=0)))
    assert (np.abs(L_port - L_jax.mean(axis=0)) <= 5.0 * s_L).all(), (L_port, L_jax)
