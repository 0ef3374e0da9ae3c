"""The port's narrow event machinery and pooled reservoir injection against
the JAX package.

  * Rows that only absorb, translate periodically or reflect specularly
    (eta = 0 walls, p = 1, partner present) are deterministic: the port's
    `run_event_buffer` must give the JAX package's rows and ledger.
  * Diffuse re-emission draws by Walker alias through `diff2`: the drawn
    modes must follow the creation-rate weights (chi-square).
  * Pooled injection counts per reservoir are deterministic (a host
    float32 accumulator) and must equal the JAX package's step by step; the
    injected modes must follow enter_prob (chi-square).

Tolerances: ints exact; positions and times to float32 rounding of the
re-cast and drift (rtol 1e-6 of the box size); occupation differences to
4 eps of their operands (sim/bose.py cancels near T_ref); ledger to rtol
1e-5 (float32 sums in another order). Chi-square tests at p = 1e-4 on
seeded draws (deterministic).
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy import stats

from torch_parity import FILM, build_pair, np_

EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def pair():
    return build_pair(FILM)


def _facets(t):
    bc = np_(t.geo.facet_bc)
    return {
        "absorb": list(np.nonzero(bc == 1)[0]),
        "periodic": list(np.nonzero(bc == 2)[0]),
        "rough": list(np.nonzero(bc == 3)[0]),
    }


def _rows_at_walls(t, facets, n, rng, need_partner=True, rem=0.05):
    """(n, 16) rows sitting on the given facets (cycled), each moving into
    its wall, interior on the other axes, with `rem` of the step left."""
    from nanokappa_torch.sim.state import (
        C_ALIVE, C_CF, C_DEV, C_MODE, C_OMEGA, C_ONF, C_REM, C_SV, C_TAU, C_TCOLL,
    )

    v = np_(t.tabs.velocity)
    om = np_(t.tabs.omega)
    normals = np_(t.geo.facet_normal)
    axis, plane = np_(t.geo.box_axis), np_(t.geo.box_plane)
    lo, hi = np_(t.geo.bounds)
    corr = t.btab.corr
    row_of = np_(t.btab.row_of_rough)
    frough = np_(t.geo.facet_rough)
    rows = np.zeros((n, 16), np.float32)
    bits = rows.view(np.int32)
    for i in range(n):
        f = facets[i % len(facets)]
        ok = (v @ normals[f] > 1e-3) & (om > 0)
        if need_partner and frough[f] >= 0:
            ok &= corr[row_of[frough[f]]] >= 0
        m = rng.choice(np.nonzero(ok)[0])
        p = lo + (0.2 + 0.6 * rng.random(3)) * (hi - lo)
        p[axis[f]] = plane[f]
        rows[i, 0:3] = p
        rows[i, 3:6] = v[m]
        rows[i, C_OMEGA] = om[m]
        rows[i, C_TAU] = 5.0 + rng.random()
        rows[i, C_DEV] = rng.normal(0, 0.02)
        bits[i, C_MODE] = m
        bits[i, C_CF] = f
        rows[i, C_TCOLL] = 0.0
        bits[i, C_ONF] = -1
        rows[i, C_REM] = rem
        rows[i, C_ALIVE] = 1.0
        bits[i, C_SV] = 0
    return rows


def test_event_buffer_deterministic_paths(pair):
    """Absorb, periodic translation and p = 1 specular reflection: no draw
    decides anything, so both packages give the same rows and ledger."""
    import jax

    from nanokappa_tpu.sim.cascade import run_event_buffer as j_run
    from nanokappa_torch.sim.cascade import run_event_buffer
    from nanokappa_torch.sim.state import C_ALIVE, C_CF, C_DEV, C_MODE, C_ONF

    j, t = pair
    fac = _facets(t)
    facets = fac["absorb"] + fac["periodic"] + fac["rough"]
    rows = _rows_at_walls(t, facets, 96, np.random.default_rng(7))
    E = rows.shape[0]
    vbuf = np.ones(E, bool)
    vbuf[-6:] = False  # padding lanes stay untouched and out of the ledger
    jo, jled, jstuck, jdef, jfr = j_run(
        jax.numpy.asarray(rows), jax.numpy.asarray(vbuf), j.geo, j.tabs, j.btab,
        j.params, jax.random.PRNGKey(0), j.state.T_sv, 8,
    )
    to, tled, tstuck, tdef, tfr, _ = run_event_buffer(
        torch.as_tensor(rows.T.copy()), torch.as_tensor(vbuf), t.geo, t.tabs, t.btab,
        t.params, torch.Generator().manual_seed(0), t.state.T_sv, 8,
    )
    jo, to = np.asarray(jo), np_(to).T
    for c in (C_MODE, C_CF, C_ONF, C_ALIVE):
        np.testing.assert_array_equal(to[:, c].view(np.int32), jo[:, c].view(np.int32), err_msg=f"col {c}")
    absorbed = vbuf & (to[:, C_ALIVE] < 0.5)
    assert absorbed.sum() == sum(vbuf[i] for i in range(E) if facets[i % len(facets)] in fac["absorb"])
    # positions, velocities, times: float32 rounding of the cast and drift
    np.testing.assert_allclose(to[:, 0:3], jo[:, 0:3], rtol=0, atol=1e-6 * 2e3)
    np.testing.assert_array_equal(to[:, 3:7], jo[:, 3:7])  # vel, omega: table values
    np.testing.assert_allclose(to[:, 11], jo[:, 11], rtol=1e-6)  # t_coll
    np.testing.assert_allclose(to[:, 13], jo[:, 13], rtol=1e-6, atol=1e-7)  # remaining
    np.testing.assert_allclose(to[:, 7], jo[:, 7], rtol=1e-6)  # lifetimes
    # occupations: specular re-reference (an occupation difference)
    np.testing.assert_allclose(to[:, C_DEV], jo[:, C_DEV], rtol=1e-6, atol=4 * EPS * 10)
    led_t, led_j = np_(tled).astype(np.float64), np.asarray(jled, np.float64)
    np.testing.assert_allclose(led_t, led_j, rtol=1e-5, atol=1e-5 * np.abs(led_j).max())
    assert int(tstuck) == int(jstuck) == 0 and int(tdef) == int(jdef) == 0
    assert int(tfr) == int(jfr) == 0


def _chi2_pvalue(counts, expected):
    """Pearson chi-square over bins with expected >= 5 (the rest merged)."""
    order = np.argsort(expected)
    c, e = counts[order], expected[order]
    small = np.cumsum(e) < 5.0
    c = np.concatenate([[c[small].sum()], c[~small]]) if small.any() else c
    e = np.concatenate([[e[small].sum()], e[~small]]) if small.any() else e
    keep = e > 0
    chi2 = (((c - e) ** 2)[keep] / e[keep]).sum()
    return stats.chi2.sf(chi2, keep.sum() - 1)


def test_diffuse_draw_follows_alias_weights(pair):
    """With the specularity zeroed every rough-wall hit re-emits diffusely;
    the drawn modes follow the wall row's creation-rate weights."""
    from nanokappa_torch.sim.cascade import run_event_buffer
    from nanokappa_torch.sim.state import C_MODE

    j, t = pair
    f = _facets(t)["rough"][0]
    rows = _rows_at_walls(t, [f], 20000, np.random.default_rng(8), need_partner=False)
    spec2 = t.btab.spec2.clone()
    spec2[..., 0] = 0.0
    btab = dataclasses.replace(t.btab, spec2=spec2)
    object.__setattr__(btab, "_host", t.btab._host)
    out, *_ = run_event_buffer(
        torch.as_tensor(rows.T.copy()), torch.ones(rows.shape[0], dtype=torch.bool),
        t.geo, t.tabs, btab, t.params, torch.Generator().manual_seed(1), t.state.T_sv, 8,
    )
    modes = np_(out[C_MODE]).view(np.int32)
    row = int(np_(t.btab.row_of_rough)[np_(t.geo.facet_rough)[f]])
    w = t.btab._host["creation"][row]
    M = w.shape[0]
    counts = np.bincount(modes, minlength=M).astype(float)
    assert counts[w == 0].sum() == 0  # never a mode the wall cannot emit
    assert _chi2_pvalue(counts, w / w.sum() * len(modes)) > 1e-4


def test_pooled_injection_counts_match_jax(pair):
    """The pooled accumulator fixes each reservoir's count: the same counts
    and the same float32 accumulator as the JAX package, step after step."""
    import jax

    from nanokappa_tpu.sim.reservoir import sample_injections as j_sample
    from nanokappa_torch.sim.reservoir import sample_injections
    from nanokappa_torch.sim.state import C_ONF

    j, t = pair
    jstate = j.state
    counter = t.state.res_counter.copy()
    gen = torch.Generator().manual_seed(2)
    res_facet = np_(t.geo.res_facet)
    for step in range(12):
        jrows, jn, jcounter, jdrop, _ = j_sample(
            jstate, j.geo, j.tabs, j.rtab, j.params, jax.random.PRNGKey(step)
        )
        rows, n, counter, drop, _ = sample_injections(counter, t.geo, t.rtab, t.params, gen)
        assert n == int(jn) > 0 and drop == int(jdrop)
        np.testing.assert_array_equal(counter, np.asarray(jcounter))
        jf = np.asarray(jrows)[: int(jn), C_ONF].view(np.int32)
        tf = np_(rows[C_ONF, :n]).view(np.int32)
        for f in res_facet:
            assert (tf == f).sum() == (jf == f).sum(), (step, f)
        jstate = dataclasses.replace(jstate, res_counter=jcounter)


def test_pooled_injection_modes_and_rows(pair):
    """Injected modes follow enter_prob per reservoir (chi-square); rows sit
    on their reservoir wall, arrive within the step, carry the occupation
    of the reservoir temperature, and are STALE (to be cast)."""
    from nanokappa_torch.sim.bose import occupation_delta_T
    from nanokappa_torch.sim.reservoir import sample_injections
    from nanokappa_torch.sim.state import C_CF, C_DEV, C_MODE, C_OMEGA, C_ONF, C_REM

    j, t = pair
    counter = t.state.res_counter.copy()
    gen = torch.Generator().manual_seed(3)
    res_facet = np_(t.geo.res_facet)
    axis, plane = np_(t.geo.box_axis), np_(t.geo.box_plane)
    modes = {int(f): [] for f in res_facet}
    for _ in range(150):
        rows, n, counter, _, _ = sample_injections(counter, t.geo, t.rtab, t.params, gen)
        r = rows[:, :n]
        onf = np_(r[C_ONF]).view(np.int32)
        for k, f in enumerate(res_facet):
            sel = onf == f
            modes[int(f)].append(np_(r[C_MODE]).view(np.int32)[sel])
            np.testing.assert_array_equal(np_(r[axis[f]])[sel], plane[f])
            T_r = float(np_(t.geo.res_temperature)[k])
            g = occupation_delta_T(
                torch.full((int(sel.sum()),), T_r), 300.0, r[C_OMEGA][torch.as_tensor(sel)]
            )
            np.testing.assert_array_equal(np_(r[C_DEV])[sel], np_(g))
        assert (np_(r[C_CF]).view(np.int32) == -2).all()
        rem = np_(r[C_REM])
        assert ((rem >= 0) & (rem < 1)).all()
    ep = np_(t.rtab.enter_prob).astype(np.float64)
    for k, f in enumerate(res_facet):
        m = np.concatenate(modes[int(f)])
        counts = np.bincount(m, minlength=ep.shape[1]).astype(float)
        assert counts[ep[k] == 0].sum() == 0
        assert _chi2_pvalue(counts, ep[k] / ep[k].sum() * len(m)) > 1e-4
