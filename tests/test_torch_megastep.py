"""The port's drift kernel (A) against the JAX package's Pallas kernel.

On the CPU each wrapper runs its plain torch twin; the Pallas kernels run in
interpret mode, as the JAX package's own tests run them. The CUDA kernels
themselves are held against the same twins on the card by
tests/test_torch_gpu.py and, at the film's full size, by chip_smoke.py.

Tolerances:
  * exported rows and every int row are bit-exact;
  * the drift kernel's float rows agree to rtol 2e-5: the JAX kernel
    evaluates occupations with a Taylor twin of expm1 (`expm1k`, a Mosaic
    workaround) that differs from expm1 by up to ~2e-5 relative — the
    tolerance of tests/test_fused.py::test_v2_mirror_specular_matches_v1;
  * the ledger and the subvolume sums agree to rtol 1e-5 plus 1e-5 of the
    column's absolute total: float32 sums in another order, with
    cancellation in the signed energy column.
"""

import numpy as np
import pytest
import torch

from torch_parity import FILM, assert_bits, build_pair, np_

INT_ROWS = [9, 10, 12, 14, 15, 16]  # mode, facet, on-facet, alive, sv, partner


def assert_float_rows(a, b, rows, msg=""):
    """rtol 2e-5 of each value plus 2e-5 of its row's largest magnitude."""
    for r in rows:
        x, y = np_(a[r]).astype(np.float64), np_(b[r]).astype(np.float64)
        fin = np.isfinite(y)
        np.testing.assert_array_equal(fin, np.isfinite(x), err_msg=f"{msg} row {r}")
        scale = np.abs(y[fin]).max(initial=0.0)
        np.testing.assert_allclose(
            x[fin], y[fin], rtol=2e-5, atol=2e-5 * scale, err_msg=f"{msg} row {r}"
        )


# --------------------------------------------------------------------------
# kernel A: the drift megastep
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def film_pool():
    """The film pool as the JAX step sees it: init_state -> to_transposed
    (slim combined 18-row layout) -> compact_pool, with 5% of the alive
    lanes made STALE (fresh injections that the kernel must cast) and a
    third without a mirror partner (their wall hits stay pending and
    export)."""
    import jax.numpy as jnp

    from nanokappa_tpu.ops.compact_pool import compact_pool
    from nanokappa_tpu.sim.fused import to_transposed

    j, t = build_pair(FILM)
    stT = to_transposed(j.state, combined=True, slim=True)
    pool3, _, _ = compact_pool(stT.packed, None, interpret=True)
    pool = np.array(pool3).reshape(18, -1)
    alive = np.nonzero(pool[14] > 0.5)[0]
    pool[10, alive[::20]] = np.array(-2, np.int32).view(np.float32)
    pool[16, alive[1::3]] = np.array(-1, np.int32).view(np.float32)
    return j, t, pool


@pytest.mark.parametrize("rta_on", [0, 1])
def test_megastep_matches_pallas(film_pool, rta_on):
    import jax.numpy as jnp

    from nanokappa_tpu.ops.megastep import drift_megastep as j_drift
    from nanokappa_torch.ops.megastep import drift_megastep, mega_config
    from nanokappa_torch.sim.fused import autosize_evt_cap

    j, t, pool = film_pool
    N = pool.shape[1]
    ecap = autosize_evt_cap(t.geo, t.tabs, t.params, True, N)
    tau_T = np_(t.tabs.tau_T)
    bounds = (float(tau_T[0]), float(tau_T[-1]))
    L = N // 8
    (jp, jrows, ecnt, acnt, _starts, kept, jled, jbins) = j_drift(
        jnp.asarray(pool.reshape(18, N // L, L)), j.state.T_sv, jnp.asarray(rta_on),
        j.geo, j.params, ecap=ecap, interpret=True, export_rows=True,
        w_exp=min(256, ecap), tau_bounds=bounds,
    )
    jp = np.asarray(jp).reshape(18, N)
    cfg = mega_config(t.geo, t.tabs, t.btab, t.params, ecap, flip_axis=2)
    tp = torch.as_tensor(pool.copy())
    rows, _, counts, led, bins = drift_megastep(tp, t.state.T_sv, bool(rta_on), cfg)

    # pool: int rows exact, float rows to the expm1 twin's 2e-5
    for r in INT_ROWS:
        assert_bits(tp[r], jp[r], f"row {r}")
    assert_float_rows(tp, jp, [0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 13, 17], "pool")
    # counts: pending, alive, kept
    k = int(np.asarray(kept).sum())
    assert counts.tolist() == [int(np.asarray(ecnt).sum()), int(np.asarray(acnt).sum()), k, 0, 0]
    assert k > 0, "the film pool must export some rows"
    # exported rows in ascending lane order, int columns bit-exact
    jr = np.asarray(jrows)[:, :k]
    for r in INT_ROWS:
        assert_bits(rows[r, :k], jr[r], f"exported row {r}")
    assert_float_rows(rows[:, :k], jr, [0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 13, 17], "exported")
    assert not (np_(rows)[:, k:] != 0).any()
    # ledger and bins: rtol 1e-5 + 1e-5 of the absolute scale
    for a, b in ((led, jled), (bins, jbins)):
        a, b = np_(a).astype(np.float64), np.asarray(b, np.float64)
        scale = np.abs(b).sum(axis=0, keepdims=True) + np.abs(b).max()
        assert (np.abs(a - b) <= 1e-5 * np.abs(b) + 1e-5 * scale).all(), (a, b)
