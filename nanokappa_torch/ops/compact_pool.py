"""Kernel B — pool defragmentation: every alive lane of the (C, N) pool,
in order, packed into a dense prefix [0, tail) of a second pool.

Replaces the Pallas kernel `compact_pool` / `_kernel` of
nanokappa_tpu/ops/compact_pool.py (:118 / :50). The step appends injections
and finished event rows at the pool tail while absorption kills lanes
anywhere, so the live region grows and accumulates holes; the runner
(sim/step.py) compacts once per sub-block when the coming appends could
reach the capacity. Here the prefix is DENSE (tail = alive count) and every
row of every lane past the tail reads zero (dead) — the TPU kernel's
128-lane filler gaps and 8-row DMA padding are not ported.

CUDA design (csrc/compact_pool.cu): per-block alive counts
(`__syncthreads_count`), one block's exclusive scan of the counts, then one
thread per lane ranks its block's alive lanes with warp ballots and moves
all C rows of an alive lane to `offset[block] + rank` in the output pool,
while lanes at or past the tail zero their output column. Rows move as
uint32 bits, so the bitcast integer rows (small ids = float32 denormals,
STALE = a NaN payload) are never touched by float arithmetic. What bounds it
on the card: bytes — one read and one write of the C x N x 4 byte pool
(~91 MB each at the film's 1.26e6 lanes, ~55 us at 3.35 TB/s); the design
reads each row once, coalesced, and writes monotone (mostly coalesced)
destinations.
"""

from __future__ import annotations

import torch

from nanokappa_torch.sim.state import C_ALIVE

launches = 0  # kernel launches (the CUDA path only)


def compact_pool_plain(pool: torch.Tensor, out: torch.Tensor | None = None):
    """The plain torch version: (out (C, N), tail () i32)."""
    alive = pool[C_ALIVE] > 0.5
    keep = torch.nonzero(alive).flatten()
    if out is None:
        out = torch.empty_like(pool)
    out.zero_()
    out[:, : keep.shape[0]] = pool[:, keep]
    tail = torch.tensor(keep.shape[0], dtype=torch.int32, device=pool.device)
    return out, tail


def compact_pool(pool: torch.Tensor, out: torch.Tensor | None = None):
    """Defragment the (C, N) float32 pool into `out` (allocated when None;
    must not alias `pool`). Returns (out, tail () int32 tensor): all alive
    lanes packed in order into [0, tail), zero rows beyond. A CPU pool takes
    the plain version, a CUDA pool launches kernel B."""
    global launches
    if pool.device.type != "cuda":
        return compact_pool_plain(pool, out)
    from nanokappa_torch.ops import _cuda

    if pool.dim() != 2 or pool.dtype != torch.float32 or not pool.is_contiguous():
        raise ValueError("compact_pool: pool must be a contiguous (C, N) float32 tensor")
    if out is None:
        out = torch.empty_like(pool)
    if out.shape != pool.shape or not out.is_contiguous() or out.data_ptr() == pool.data_ptr():
        raise ValueError("compact_pool: out must be a distinct contiguous tensor shaped like pool")
    lib = _cuda.library()
    C, N = pool.shape
    nb = -(-N // 256)
    tail = torch.empty((), dtype=torch.int32, device=pool.device)
    scratch = torch.empty(2 * nb + 1, dtype=torch.int32, device=pool.device)
    err = lib.nk_compact_pool(
        _cuda.ptr(pool), _cuda.ptr(out), C, N, _cuda.ptr(tail),
        _cuda.ptr(scratch), _cuda.stream(pool),
    )
    _cuda.check(err, "nk_compact_pool")
    launches += 1
    return out, tail
