"""Kernel D's plain twin (`nanokappa_torch/ops/scatter_rows.py`) against the
JAX package's `scatter_rows_sorted` (the Pallas kernel in interpret mode)
and against XLA's sorted-unique `.at[].set`, bit for bit, on the four shapes
of tests/test_scatter_rows.py transposed to the port's (C, N) layout:
several blocks with a sentinel tail, one exact block, no updates, a dense
cluster. The pools carry bit-hazard integer rows (small ids read as float32
denormals, STALE = -2 as a NaN payload), which any float arithmetic would
corrupt. The CUDA kernel against this twin is
tests/test_torch_gpu.py::test_cuda_scatter_rows_matches_plain.
"""

import numpy as np
import pytest
import torch

from torch_parity import SCATTER_CASES, assert_bits, scatter_case


@pytest.mark.parametrize("n,e,nval", SCATTER_CASES, ids=["blocks_sentinel", "one_block", "none", "cluster"])
def test_scatter_rows_twin_matches_jax(n, e, nval):
    import jax.numpy as jnp

    from nanokappa_tpu.ops.scatter_rows import scatter_rows_sorted
    from nanokappa_torch.ops import scatter_rows as sr

    pool, rows, idx = scatter_case(n, e, nval)
    before = sr.launches
    got = sr.scatter_rows(torch.as_tensor(pool), torch.as_tensor(rows), torch.as_tensor(idx))
    assert sr.launches == before  # a CPU pool takes the twin
    base, upd, ix = jnp.asarray(pool.T), jnp.asarray(rows.T), jnp.asarray(idx)
    pallas = np.asarray(scatter_rows_sorted(base, upd, ix, interpret=True)).T
    xla = np.asarray(base.at[ix].set(upd, mode="drop", indices_are_sorted=True, unique_indices=True)).T
    assert_bits(got, pallas)
    assert_bits(got, xla)
    ref = pool.copy()
    ref[:, idx[:nval]] = rows[:, :nval]
    assert_bits(got, ref)
