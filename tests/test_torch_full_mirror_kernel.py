"""Kernel A's full-mirror branch (the 24-row pool) against the JAX
package's Pallas kernel in interpret mode, on the film box.

Two pools, each as the JAX step sees it (init_state -> to_transposed with
the combined 24-row mirror cache -> compact_pool), with 5% of the alive
lanes made STALE (fresh injections the kernel casts) and a third without a
cached partner (their wall hits stay pending and export):
  * the velocity film (here): its partner is the exact crystal mirror (the
    slim gate holds, but the kernel is handed the full cache);
  * the k film on tests/torch_parity.py:craft_kmirror's tables
    (tests/test_torch_full_mirror_kkernel.py): the cache holds the
    degenerate partner branch where the split drawn at initialisation took
    it, and a sixth of the lanes cache a partner frequency 1e-3 off theirs,
    so the swap's occupation re-reference is not zero (the synthetic
    material's degenerate branches have equal frequencies).
Tolerances (tests/test_torch_megastep.py): int rows and exported int rows
bit-exact; float rows, occupations included, to rtol 2e-5 plus 2e-5 of the
row's largest magnitude (the JAX kernel's Taylor twin of expm1, also in
its occupation re-reference at the swap); ledger and subvolume sums to
rtol 1e-5 of their absolute scale (float32 sums in another order).
"""

import numpy as np
import torch

from test_torch_megastep import assert_float_rows
from torch_parity import FILM, assert_bits, build_pair, kmirror_pair, np_

INT_ROWS = [9, 10, 12, 14, 15, 16]  # mode, facet, on-facet, alive, sv, partner
FLOAT_ROWS = [r for r in range(24) if r not in INT_ROWS]


def full_pool(j):
    from nanokappa_tpu.ops.compact_pool import compact_pool
    from nanokappa_tpu.sim.fused import to_transposed

    stT = to_transposed(j.state, combined=True)
    pool3, _, _ = compact_pool(stT.packed, None, interpret=True)
    pool = np.array(pool3).reshape(24, -1)
    alive = np.nonzero(pool[14] > 0.5)[0]
    pool[10, alive[::20]] = np.array(-2, np.int32).view(np.float32)
    pool[16, alive[1::3]] = np.array(-1, np.int32).view(np.float32)
    return pool


def check_full_mirror(case):
    import jax.numpy as jnp

    from nanokappa_tpu.ops.megastep import drift_megastep as j_drift
    from nanokappa_torch.ops.megastep import drift_megastep, mega_config
    from nanokappa_torch.sim.fused import autosize_evt_cap

    j, t = build_pair(FILM) if case == "velocity" else kmirror_pair(FILM, mesh=(4, 4, 4))
    pool = full_pool(j)
    if case == "k":
        # some lanes cache a degenerate partner branch
        xm, m = pool[16].view(np.int32), pool[9].view(np.int32)
        assert ((pool[14] > 0.5) & (xm >= 0) & (xm != m)).any()
        pool[17, 2::6] *= np.float32(1.001)
    N = pool.shape[1]
    ecap = autosize_evt_cap(t.geo, t.tabs, t.params, True, N)
    tau_T = np_(t.tabs.tau_T)
    L = N // 8
    (jp, jrows, ecnt, acnt, _starts, kept, jled, jbins) = j_drift(
        jnp.asarray(pool.reshape(24, N // L, L)), j.state.T_sv, jnp.asarray(1),
        j.geo, j.params, ecap=ecap, interpret=True, export_rows=True,
        w_exp=min(256, ecap), tau_bounds=(float(tau_T[0]), float(tau_T[-1])),
    )
    jp = np.asarray(jp).reshape(24, N)
    cfg = mega_config(t.geo, t.tabs, t.btab, t.params, ecap, layout="full")
    tp = torch.as_tensor(pool.copy())
    rows, _, counts, led, bins = drift_megastep(tp, t.state.T_sv, True, cfg)

    for r in INT_ROWS:
        assert_bits(tp[r], jp[r], f"row {r}")
    assert_float_rows(tp, jp, FLOAT_ROWS, "pool")
    k = int(np.asarray(kept).sum())
    assert counts.tolist()[:3] == [int(np.asarray(ecnt).sum()), int(np.asarray(acnt).sum()), k]
    assert k > 0, "the film pool must export some rows"
    # the swap happened on the main path of this pool: modes moved
    assert (np_(tp[9]).view(np.int32) != pool[9].view(np.int32)).any()
    jr = np.asarray(jrows)[:, :k]
    for r in INT_ROWS:
        assert_bits(rows[r, :k], jr[r], f"exported row {r}")
    assert_float_rows(rows[:, :k], jr, FLOAT_ROWS, "exported")
    assert not (np_(rows)[:, k:] != 0).any()
    for a, b in ((led, jled), (bins, jbins)):
        a, b = np_(a).astype(np.float64), np.asarray(b, np.float64)
        scale = np.abs(b).sum(axis=0, keepdims=True) + np.abs(b).max()
        assert (np.abs(a - b) <= 1e-5 * np.abs(b) + 1e-5 * scale).all(), (a, b)


def test_full_mirror_matches_pallas():
    check_full_mirror("velocity")
