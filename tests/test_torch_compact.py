"""The port's compaction kernels (B: pool, C: stream) against the JAX
package's Pallas kernels.

On the CPU each wrapper runs its plain torch twin; the Pallas kernels run in
interpret mode, as the JAX package's own tests run them. The CUDA kernels
themselves are held against the same twins on the card by
tests/test_torch_gpu.py and, at the film's full size, by chip_smoke.py.

Tolerance: none — compaction is data movement, bit-exact.
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_bits, hazard_pool, np_


# --------------------------------------------------------------------------
# kernel C: stream compaction
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,p,cap",
    [(2048, 0.05, 512), (2048, 0.5, 512), (40000, 0.06, 4096), (5000, 0.0, 64), (3000, 1.0, 256)],
)
def test_compact_matches_pallas(n, p, cap):
    """Exactly compact_indices_pallas: ascending indices, sentinel n past
    n_valid = min(count, cap) — including count > cap and n not a multiple
    of the TPU kernel's 16384-bit block."""
    import jax.numpy as jnp

    from nanokappa_tpu.ops.compact import compact_indices_pallas
    from nanokappa_torch.ops.compact import compact_indices

    mask = np.random.default_rng(n + int(100 * p)).random(n) < p
    ji, jn = compact_indices_pallas(jnp.asarray(mask), cap, interpret=True)
    ti, tn = compact_indices(torch.as_tensor(mask), cap)
    np.testing.assert_array_equal(np_(ti), np.asarray(ji))
    assert int(tn) == int(jn) == min(int(mask.sum()), cap)


# --------------------------------------------------------------------------
# kernel B: pool compaction
# --------------------------------------------------------------------------


def _jax_compact(pool):
    import jax.numpy as jnp

    from nanokappa_tpu.ops.compact_pool import compact_pool
    from nanokappa_tpu.ops.megastep import tile_width

    C, N = pool.shape
    L = tile_width(N) // 8
    out, _, tail = compact_pool(jnp.asarray(pool.reshape(C, N // L, L)), None, interpret=True)
    return np.asarray(out).reshape(C, N), int(tail)


def test_compact_pool_single_tile_bit_exact():
    """One TPU tile: the JAX output is a dense prefix followed by zero
    rows, which is the port's output lane for lane."""
    from nanokappa_torch.ops.compact_pool import compact_pool

    pool = hazard_pool(np.random.default_rng(11), 18, 4096)
    jout, jtail = _jax_compact(pool)
    tout, ttail = compact_pool(torch.as_tensor(pool))
    assert int(ttail) == jtail == int((pool[14] > 0.5).sum())
    assert_bits(tout, jout)


def test_compact_pool_multi_tile_order_and_tail():
    """Two TPU tiles: the JAX kernel leaves 128-aligned filler gaps between
    tiles; the alive rows, in order, and their count agree."""
    from nanokappa_torch.ops.compact_pool import compact_pool

    pool = hazard_pool(np.random.default_rng(12), 18, 65536, p_alive=0.45)
    jout, jtail = _jax_compact(pool)
    tout, ttail = compact_pool(torch.as_tensor(pool))
    jalive = jout[14] > 0.5
    n = int((pool[14] > 0.5).sum())
    assert int(ttail) == n == int(jalive.sum())
    assert not jalive[jtail:].any()
    assert_bits(np_(tout)[:, :n], jout[:, jalive])
    assert not (np_(tout)[:, n:] != 0).any()  # every row past the tail is zero
