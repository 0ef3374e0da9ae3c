"""The 'one_to_one' reservoir scheme (nanokappa_torch/sim/reservoir.py
_one_to_one) against the JAX package's (`sample_injections`, :289-318):
each reservoir regenerates exactly the particles that left it in the
previous step, up to inj_cap // R of them (the rest are dropped and
counted), modes by the Walker alias of enter_prob. Totals are exact; the
modes are compared by chi-square against the JAX package's draws and
against enter_prob; and the film's population holds within 5% over 200
steps on both of the port's steps, as tests/test_sim_box.py:198 holds the
JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.stats import chi2

from torch_parity import FILM, build_pair, np_


def _per_reservoir(rows, n_valid, res_facet):
    from nanokappa_torch.sim.state import C_MODE, C_ONF

    v = np_(rows[:, :n_valid])
    return np.searchsorted(res_facet, v[C_ONF].view(np.int32)), v[C_MODE].view(np.int32)


def test_one_to_one_totals_are_n_leaving_clipped_at_per():
    from nanokappa_torch.sim.reservoir import sample_injections
    from nanokappa_torch.sim.state import C_REM

    _, t = build_pair(FILM, mesh=(4, 4, 4), inj_cap=512, res_gen="one_to_one")
    per = t.params.inj_cap // 2
    res_facet = np_(t.geo.res_facet)
    gen = torch.Generator().manual_seed(5)
    for leaving in ([0, 0], [3, 0], [17, 250], [per, per], [per + 40, 7], [1000, per + 1]):
        nl = torch.tensor(leaving, dtype=torch.int32)
        rows, n_valid, counter, dropped = sample_injections(
            t.state.res_counter, t.geo, t.rtab, t.params, gen, nl
        )
        kept = np.minimum(leaving, per)
        assert n_valid == kept.sum() and dropped == sum(leaving) - kept.sum(), leaving
        assert counter is t.state.res_counter  # no accumulator
        r, _ = _per_reservoir(rows, n_valid, res_facet)
        np.testing.assert_array_equal(np.bincount(r, minlength=2), kept)
        assert np.all(np.diff(r) >= 0)  # packed in block order: reservoir 0 first
        rem = np_(rows[C_REM, :n_valid])
        assert rem.size == 0 or (rem.min() >= 0.0 and rem.max() <= 1.0)
    with pytest.raises(ValueError, match="n_leaving"):
        sample_injections(t.state.res_counter, t.geo, t.rtab, t.params, gen)


def test_one_to_one_modes_match_jax_and_enter_prob():
    import jax
    import jax.numpy as jnp

    from nanokappa_tpu.sim.reservoir import sample_injections as j_sample
    from nanokappa_torch.sim.reservoir import sample_injections

    j, t = build_pair(FILM, mesh=(4, 4, 4), inj_cap=2048, res_gen="one_to_one")
    per = t.params.inj_cap // 2
    res_facet = np_(t.geo.res_facet)
    ep = np_(t.rtab.enter_prob).astype(np.float64)
    R, M = ep.shape
    draws = 60
    gen = torch.Generator().manual_seed(9)
    nl = torch.tensor([per, per], dtype=torch.int32)
    hp = np.zeros((R, M), np.int64)
    for _ in range(draws):
        rows, n_valid, _, _ = sample_injections(t.state.res_counter, t.geo, t.rtab, t.params, gen, nl)
        r, m = _per_reservoir(rows, n_valid, res_facet)
        np.add.at(hp, (r, m), 1)
    js = dataclasses.replace(j.state, n_leaving=jnp.asarray([per, per], jnp.int32))
    draw = jax.jit(lambda key: j_sample(js, j.geo, j.tabs, j.rtab, j.params, key))
    hj = np.zeros((R, M), np.int64)
    for k in range(draws):
        rows, n_valid, _, _, _ = draw(jax.random.PRNGKey(k))
        assert int(n_valid) == 2 * per
        r, m = _per_reservoir(np.asarray(rows).T, int(n_valid), res_facet)
        np.add.at(hj, (r, m), 1)
    for r in range(R):
        assert hp[r].sum() == hj[r].sum() == draws * per
        p = ep[r] / ep[r].sum()
        for name, h in (("port", hp[r]), ("jax", hj[r])):
            assert h[p == 0].sum() == 0, name  # never a mode that cannot enter
            exp = p * h.sum()
            sel = exp >= 5
            stat = ((h[sel] - exp[sel]) ** 2 / exp[sel]).sum() + (
                (h[~sel].sum() - exp[~sel].sum()) ** 2 / max(exp[~sel].sum(), 1e-9)
            )
            assert stat < chi2.ppf(0.999, sel.sum()), (name, r, stat, sel.sum())
        # the two packages' histograms against each other
        sel = (hp[r] + hj[r]) >= 10
        stat = (((hp[r] - hj[r])[sel]) ** 2 / (hp[r] + hj[r])[sel]).sum()
        assert stat < chi2.ppf(0.999, sel.sum() - 1), (r, stat)


@pytest.mark.parametrize("step_impl", ["v2", "v1"])
def test_one_to_one_population_and_injection_ledger(step_impl, monkeypatch):
    """210 steps of the film: each of the first 10 steps injects exactly
    the previous step's n_leaving (none reaches the clip here), read from
    the step outputs — N_p(k) - N_p(k-1) + n_leaving(k) + lanes removed =
    injected — and after 20 runs of 10 steps more the population stays
    within 5% of its start."""
    from nanokappa_torch.sim.state import init_state
    from nanokappa_torch.sim.step import build_step

    _, t = build_pair(FILM, mesh=(4, 4, 4), n_p=3000, n_cap=4096, inj_cap=512, res_gen="one_to_one")
    params = dataclasses.replace(t.params, step_impl=step_impl)
    state = init_state(t.mat, t.dom, t.geo, params, t.n_p, t.btab, temp_dist="linear", seed=3)
    n_steps = 200
    run = build_step(t.geo, t.tabs, t.btab, t.rtab, params, n_inner=10, n_outer=n_steps // 10)
    n0 = int(state.alive.sum())
    outs = []
    for _ in range(10):
        # one step at a time: the outputs of every step
        state, out = build_step(t.geo, t.tabs, t.btab, t.rtab, params, n_inner=1, n_outer=1)(state)
        outs.append(out)
    state, _ = run(state)
    assert state.layout == ("plain" if step_impl == "v1" else "slim")
    N_p = np.array([n0] + [int(o.N_p) for o in outs])
    leave = np.array([np_(o.n_leaving).sum() for o in outs])
    lost = np.array([np.zeros(3, np.int64)] + [np_(o.lost_split) for o in outs])
    assert lost[-1, 0] == 0  # nothing dropped: no step reached the clip
    injected = np.diff(N_p) + leave + np.diff(lost[:, 1] + lost[:, 2])
    np.testing.assert_array_equal(injected[1:], leave[:-1])
    assert injected[0] == 0  # n_leaving starts at zero, as in the JAX init
    assert leave.sum() > 0
    assert int(state.lost[0]) == 0
    assert abs(int(state.alive.sum()) - n0) < 0.05 * n0
