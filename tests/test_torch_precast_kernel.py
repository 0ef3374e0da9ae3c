"""Kernel A's kernel_cast-off branch (the large-mesh path: no in-kernel cast,
no event round, injections pre-cast) against the JAX package's Pallas kernel
with `kernel_cast=False` (interpret mode), one step.

Held on the film box: the branch never casts, so the geometry only decides
which lanes end their flight inside the step, and the box keeps the JAX
kernel out of the 384-triangle unroll that would take minutes to compile
for the CPU. The pool is the film's, compacted, with 5% of the alive lanes
pre-cast as the step pre-casts injections (C_TCOLL = -t/dt - 1 with the real
facet in C_CF: they decode their flight and skip the deferred RTA), and
leftover flights of 0.05 to 1 dt, so some lanes end on a wall. Then:
  * every int row matches exactly, the float rows to rtol 2e-5 (the JAX
    kernel's Taylor expm1 twin);
  * the counts (pending, alive, kept), the exported pool indices (the JAX
    kernel's per-block segments, concatenated) and the exported rows match;
  * no ledger (nothing is absorbed in-kernel), and the subvolume sums of
    the lanes that stay match to rtol 1e-5 of their absolute scale.
"""

import numpy as np
import pytest
import torch

from torch_parity import FILM, build_pair, np_

INT_ROWS = [9, 10, 12, 14, 15]  # mode, facet, on-facet, alive, sv
FLOAT_ROWS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 13]


def _close_rows(a, b, rows, msg):
    for r in rows:
        x, y = np.asarray(a[r], np.float64), np.asarray(b[r], np.float64)
        fin = np.isfinite(y)
        np.testing.assert_array_equal(np.isfinite(x), fin, err_msg=f"{msg} row {r}")
        scale = np.abs(y[fin]).max(initial=0.0)
        np.testing.assert_allclose(x[fin], y[fin], rtol=2e-5, atol=2e-5 * scale, err_msg=f"{msg} row {r}")


@pytest.fixture(scope="module")
def box():
    from nanokappa_torch.ops.raycast import raycast

    j, t = build_pair(FILM)
    pool = np.array(j.state.packed).T.copy()  # (16, N), the plain rows
    keep = np.nonzero(pool[14] > 0.5)[0]
    pool = np.concatenate([pool[:, keep], np.zeros((16, pool.shape[1] - len(keep)), np.float32)], 1)
    alive = np.nonzero(pool[14] > 0.5)[0]
    rng = np.random.default_rng(4)
    pool[13, alive] = rng.uniform(0.05, 1.0, len(alive)).astype(np.float32)
    # pre-cast lanes, as the step pre-casts injections
    pre = alive[::20]
    tp = torch.as_tensor(pool)
    t_b, f_b = raycast(t.geo, tp[0:3, pre].T, tp[3:6, pre].T, tp[12, pre].contiguous().view(torch.int32))
    pool[11, pre] = np_(-(t_b / 1.0) - 1.0)
    pool[10, pre] = np_(f_b).view(np.float32)
    return j, t, pool, pre


@pytest.mark.parametrize("rta_on", [0, 1])
def test_precast_branch_matches_pallas(box, rta_on):
    import jax.numpy as jnp

    from nanokappa_tpu.ops.megastep import drift_megastep as j_drift
    from nanokappa_torch.ops.megastep import drift_megastep, mega_config

    j, t, pool, pre = box
    N = pool.shape[1]
    ecap = 1024
    L = N // 8
    jp, jevt, ecnt, acnt, starts, kept, jled, jbins = j_drift(
        jnp.asarray(pool.reshape(16, N // L, L)), j.state.T_sv, jnp.asarray(rta_on),
        j.geo, j.params, ecap=ecap, interpret=True, kernel_cast=False,
    )
    jp = np.asarray(jp).reshape(16, N)
    cfg = mega_config(t.geo, t.tabs, t.btab, t.params, ecap, kernel_cast=False)
    assert not cfg.kernel_cast and cfg.rounds == 0 and cfg.facets.shape[0] == 0
    tp = torch.as_tensor(pool.copy())
    rows, idx, counts, led, bins = drift_megastep(tp, t.state.T_sv, bool(rta_on), cfg)
    tp = np_(tp)

    for r in INT_ROWS:
        np.testing.assert_array_equal(tp[r].view(np.int32), jp[r].view(np.int32), err_msg=f"row {r}")
    _close_rows(tp, jp, FLOAT_ROWS, "pool")
    # the pre-cast lanes decoded their flight (none is left encoded)
    assert (tp[11, pre] > -0.5).all()

    k = int(np.asarray(kept).sum())
    assert counts.tolist() == [int(np.asarray(ecnt).sum()), int(np.asarray(acnt).sum()), k, 0, 0]
    assert k > 20, k
    jevt, starts, kept = np.asarray(jevt), np.asarray(starts), np.asarray(kept)
    jidx = np.concatenate([jevt[s:s + n] for s, n in zip(starts, kept)])
    np.testing.assert_array_equal(np_(idx[:k]), jidx)
    assert (np_(idx[k:]) == N).all()
    for r in INT_ROWS:
        np.testing.assert_array_equal(np_(rows[r, :k]).view(np.int32), jp[r, jidx].view(np.int32))
    _close_rows(np_(rows[:, :k]), jp[:, jidx], FLOAT_ROWS, "exported")

    assert not np_(led).any() and not np.asarray(jled).any()
    a, b = np_(bins).astype(np.float64), np.asarray(jbins, np.float64)
    scale = np.abs(b).sum(axis=0, keepdims=True) + np.abs(b).max()
    assert (np.abs(a - b) <= 1e-5 * np.abs(b) + 1e-5 * scale).all(), (a, b)
