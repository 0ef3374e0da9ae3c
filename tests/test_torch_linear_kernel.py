"""Kernel A's slim branch under linear temperatures (the deferred RTA at the
lerped particle temperature, `_T_interp` nanokappa_tpu/ops/megastep.py:
496-528) against the Pallas kernel in interpret mode, on the film's pool
with a third of the lanes between a reservoir and the end slice centres
(the lerp extrapolates there). Both kernels fold the slice centres' origin
and spacing in float64 on the host: int rows exact, floats rtol 2e-5 (the
JAX kernel's Taylor expm1 twin, tests/test_torch_megastep.py), sums rtol
1e-5 of their absolute scale.
"""

import dataclasses

import numpy as np
import torch

from test_torch_linear_t import linear_pair
from torch_parity import np_

FLOAT_ROWS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 13, 17]
INT_ROWS = [9, 10, 12, 14, 15, 16]


def test_linear_slim_branch_matches_pallas():
    import jax.numpy as jnp

    from nanokappa_tpu.ops.compact_pool import compact_pool
    from nanokappa_tpu.ops.megastep import drift_megastep as j_drift
    from nanokappa_tpu.sim.fused import to_transposed
    from nanokappa_torch.ops.megastep import SV_LINEAR, drift_megastep, mega_config
    from nanokappa_torch.sim.fused import autosize_evt_cap

    j, t = linear_pair()
    stT = to_transposed(j.state, combined=True, slim=True)
    pool3, _, _ = compact_pool(stT.packed, None, interpret=True)
    pool = np.array(pool3).reshape(18, -1)
    N = pool.shape[1]
    alive = np.nonzero(pool[14] > 0.5)[0]
    pool[10, alive[::20]] = np.array(-2, np.int32).view(np.float32)
    pool[16, alive[1::3]] = np.array(-1, np.int32).view(np.float32)
    rng = np.random.default_rng(13)
    c = np_(t.geo.subvol_center)[:, 0]
    lo, hi = t.dom.mesh.bounds
    lanes = alive[2::3]
    pool[0, lanes] = np.where(rng.random(len(lanes)) < 0.5, rng.uniform(lo[0] + 1, c[0], len(lanes)),
                              rng.uniform(c[-1], hi[0] - 1, len(lanes)))
    T_sv = np.array([301.6, 300.4, 300.1, 299.2, 298.5], np.float32)

    ecap = autosize_evt_cap(t.geo, t.tabs, t.params, True, N)
    tau_T = np_(t.tabs.tau_T)
    L = N // 8
    jp, jrows, ecnt, acnt, _s, kept, jled, jbins = j_drift(
        jnp.asarray(pool.reshape(18, N // L, L)), jnp.asarray(T_sv), jnp.asarray(1),
        j.geo, j.params, ecap=ecap, interpret=True, export_rows=True,
        w_exp=min(256, ecap), tau_bounds=(float(tau_T[0]), float(tau_T[-1])),
    )
    jp = np.asarray(jp).reshape(18, N)
    cfg = mega_config(t.geo, t.tabs, t.btab, t.params, ecap, flip_axis=2)
    assert cfg.sv_mode == SV_LINEAR
    tp = torch.as_tensor(pool.copy())
    rows, _, counts, led, bins = drift_megastep(tp, torch.as_tensor(T_sv), True, cfg)
    tp = np_(tp)
    # the lerp really moved the deferred RTA: nearest temperatures differ
    ncfg = dataclasses.replace(cfg, sv_mode=0)
    tn = torch.as_tensor(pool.copy())
    drift_megastep(tn, torch.as_tensor(T_sv), True, ncfg)
    assert (np_(tn)[8] != tp[8]).mean() > 0.3

    for r in INT_ROWS:
        np.testing.assert_array_equal(tp[r].view(np.int32), jp[r].view(np.int32), err_msg=f"row {r}")
    for r in FLOAT_ROWS:
        x, y = tp[r].astype(np.float64), jp[r].astype(np.float64)
        fin = np.isfinite(y)
        np.testing.assert_array_equal(np.isfinite(x), fin, err_msg=f"row {r}")
        scale = np.abs(y[fin]).max(initial=0.0)
        np.testing.assert_allclose(x[fin], y[fin], rtol=2e-5, atol=2e-5 * scale, err_msg=f"row {r}")
    k = int(np.asarray(kept).sum())
    assert counts.tolist() == [int(np.asarray(ecnt).sum()), int(np.asarray(acnt).sum()), k, 0, 0]
    for a, b in ((led, jled), (bins, jbins)):
        a, b = np_(a).astype(np.float64), np.asarray(b, np.float64)
        scale = np.abs(b).sum(axis=0, keepdims=True) + np.abs(b).max()
        assert (np.abs(a - b) <= 1e-5 * np.abs(b) + 1e-5 * scale).all(), (a, b)
