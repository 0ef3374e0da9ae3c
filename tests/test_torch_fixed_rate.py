"""The 'fixed_rate' reservoir scheme (nanokappa_torch/sim/reservoir.py
_fixed_rate_lattice) against the JAX package's
(`nanokappa_tpu.sim.reservoir.sample_injections`, :202-247), by
distribution over many draws on the 6^3 film: floor(enter_prob) copies of
each (reservoir, mode) plus one with probability frac(enter_prob), so each
(reservoir, mode)'s count has mean enter_prob and variance
frac (1 - frac). The two packages draw different streams (threefry and
Philox), so they are compared through these moments and a chi-square of
their mode histograms, not draw by draw."""

import dataclasses

import numpy as np
from scipy.stats import chi2

from torch_parity import FILM, build_pair, np_

DRAWS = 300


def _counts(modes, facets, res_facet, R, M):
    """(R, M) copies of each (reservoir, mode) in one draw's valid rows."""
    r = np.searchsorted(res_facet, facets)
    out = np.zeros((R, M), np.int64)
    np.add.at(out, (r, modes), 1)
    return out


def _draws():
    import jax

    from nanokappa_tpu.sim.reservoir import sample_injections as j_sample
    from nanokappa_torch.sim.reservoir import autosize_c_max, sample_injections
    from nanokappa_torch.sim.state import C_MODE, C_ONF, C_REM

    j, t = build_pair(FILM, mesh=(6, 6, 6), n_p=3000, inj_cap=1024, res_gen="fixed_rate")
    c_max = autosize_c_max(t.rtab)
    t.params = dataclasses.replace(t.params, c_max=c_max)
    j.params = dataclasses.replace(j.params, c_max=c_max)
    R, M = t.rtab.enter_prob.shape
    res_facet = np_(t.geo.res_facet)
    assert np.all(np.diff(res_facet) > 0)

    gen = __import__("torch").Generator().manual_seed(11)
    port, port_dt = [], []
    for _ in range(DRAWS):
        rows, n_valid, counter, dropped, _ = sample_injections(
            t.state.res_counter, t.geo, t.rtab, t.params, gen
        )
        assert dropped == 0 and counter is t.state.res_counter  # no accumulator
        v = np_(rows[:, :n_valid])
        port.append(_counts(v[C_MODE].view(np.int32), v[C_ONF].view(np.int32), res_facet, R, M))
        port_dt.append(v[C_REM])
    draw = jax.jit(lambda key: j_sample(j.state, j.geo, j.tabs, j.rtab, j.params, key))
    ref = []
    for k in range(DRAWS):
        rows, n_valid, _, dropped, _ = draw(jax.random.PRNGKey(k))
        n_valid = int(n_valid)
        assert int(dropped) == 0
        v = np.asarray(rows)[:n_valid].T
        ref.append(_counts(v[C_MODE].view(np.int32), v[C_ONF].view(np.int32), res_facet, R, M))
    ep = np_(t.rtab.enter_prob).astype(np.float64)
    return np.array(port), np.array(ref), ep, np.concatenate(port_dt)


def test_fixed_rate_counts_and_modes_match_jax():
    port, ref, ep, dt_frac = _draws()
    frac = ep - np.floor(ep)
    var = frac * (1.0 - frac)
    for name, c in (("port", port), ("jax", ref)):
        # every (reservoir, mode) gets floor(ep) or floor(ep) + 1 copies
        assert np.all((c == np.floor(ep)) | (c == np.floor(ep) + 1)), name
        # the total a draw: mean sum(ep) within 5 sigma, sigma^2 = sum var / D
        tot = c.sum(axis=(1, 2))
        assert abs(tot.mean() - ep.sum()) <= 5.0 * np.sqrt(var.sum() / DRAWS), (name, tot.mean(), ep.sum())
        # per-mode means: chi-square of (mean - ep) over the modes that vary
        m = c.mean(axis=0)
        sel = var > 1e-3
        stat = (((m - ep)[sel]) ** 2 / (var[sel] / DRAWS)).sum()
        assert stat < chi2.ppf(0.999, sel.sum()), (name, stat, sel.sum())
        # the variance, pooled over the modes: sum var_hat against sum var
        v_hat = c.var(axis=0, ddof=1)
        assert abs(v_hat.sum() / var.sum() - 1.0) < 0.1, (name, v_hat.sum(), var.sum())
    # the two packages' mode histograms, pooled over reservoirs: two-sample
    # chi-square over the modes both draw
    hp, hr = port.sum(axis=(0, 1)), ref.sum(axis=(0, 1))
    hp, hr = hp - np.floor(ep).sum(0) * DRAWS, hr - np.floor(ep).sum(0) * DRAWS  # the Bernoulli part
    sel = (hp + hr) >= 10
    stat = (((hp - hr)[sel]) ** 2 / (hp + hr)[sel]).sum()
    assert stat < chi2.ppf(0.999, sel.sum() - 1), (stat, sel.sum())
    # arrival fractions lie in the step
    assert dt_frac.min() >= 0.0 and dt_frac.max() <= 1.0


def test_fixed_rate_clips_above_c_max():
    """Counts above c_max cannot sit on the (c_max, R*M) lattice: they are
    counted into `dropped`, as the JAX package counts them; each
    (reservoir, mode) keeps min(count, c_max) copies."""
    import torch

    from nanokappa_torch.sim.reservoir import sample_injections
    from nanokappa_torch.sim.state import C_MODE, C_ONF

    _, t = build_pair(FILM, mesh=(4, 4, 4), n_p=3000, inj_cap=4096, res_gen="fixed_rate")
    # a denser gas: every entry probability x 20, so many exceed c_max = 1
    rtab = dataclasses.replace(t.rtab, enter_prob=t.rtab.enter_prob * 20.0)
    ep = np_(rtab.enter_prob).astype(np.float64)
    params = dataclasses.replace(t.params, c_max=1)
    R, M = ep.shape
    res_facet = np_(t.geo.res_facet)
    gen = torch.Generator().manual_seed(2)
    for _ in range(5):
        rows, n_valid, _, dropped, _ = sample_injections(t.state.res_counter, t.geo, rtab, params, gen)
        v = np_(rows[:, :n_valid])
        c = _counts(v[C_MODE].view(np.int32), v[C_ONF].view(np.int32), res_facet, R, M)
        assert c.max() == 1 and np.all(c[np.floor(ep) >= 1] == 1)  # min(count, c_max)
        total = n_valid + dropped
        assert np.floor(ep).sum() <= total <= np.ceil(ep).sum()
        assert dropped >= np.maximum(np.floor(ep) - 1, 0).sum() > 0
