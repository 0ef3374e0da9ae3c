"""Kernel D — sorted-unique row scatter: the event rows of the v1 cascade
merged back into the pool at their lanes.

Replaces the Pallas kernel `scatter_rows_sorted` / `_kernel` of
nanokappa_tpu/ops/scatter_rows.py (:80 / :41), called by the JAX v1
cascade's merge (nanokappa_tpu/sim/cascade.py `_merge_rows` :97). The
function: pool[:, idx[e]] = rows[:, e] for every update lane e whose index
lies in [0, N); the other lanes (the sentinel N that fills a compaction's
unused tail) are dropped. The indices come from stream compaction, so they
are ascending and unique. The port's layout is SoA — pool (C, N), rows
(C, E) — and the pool is updated IN PLACE (the JAX kernel returns a new
array; the port's step owns its pool and needs no copy).

CUDA design (csrc/scatter_rows.cu): one thread per update lane, in
64-thread blocks: the thread reads its index once and moves its lane's C
rows 16 at a time (every load of a chunk before its stores), each row read
coalesced along E. idx ascends, so the sentinel tail is a suffix: a thread
whose index is >= N leaves after its index load. Unique indices mean no
two threads write one address, so there are no atomics and no ordering,
and the kernel reads the sentinel itself (no mask on the host, no
synchronisation). Rows move as uint32 bits, so the pool's bitcast integer
rows are never touched by float arithmetic. Not ported: the TPU's
16,384-lane output blocks with their `searchsorted` starts, the
128-aligned DMA windows, the 8-row padding and the log-shift expand
network. What bounds it on the card: its bytes bound is the valid prefix
of the rows read and written (2 x n_valid x C x 4 B) and the E indices
read — at the v1 event window (E = 79,872, C = 16) at most 10.5 MB, 3.1 us
at 3.35 TB/s — but the pool's SoA layout (kernel A's) puts each valid
store alone in its 32-byte sector (the star's event lanes lie ~26 apart),
and scattered 4-byte stores run at the card's rate of store requests
(~27-36 G sectors/s measured on the H100, whatever the thread mapping:
PERF.md), not at its memory bandwidth.
"""

from __future__ import annotations

import torch

launches = 0  # kernel launches (the CUDA path only)


def scatter_rows_plain(pool: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain torch version: the function kernel D computes."""
    valid = (idx >= 0) & (idx < pool.shape[1])
    pool[:, idx[valid].long()] = rows[:, valid]
    return pool


def scatter_rows(pool: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Write rows (C, E) into the (C, N) float32 pool at the ascending,
    unique lanes idx (E,) int32, in place; lanes outside [0, N) are
    dropped. Returns the pool. A CPU pool takes the plain version, a CUDA
    pool launches kernel D."""
    global launches
    if pool.device.type != "cuda":
        return scatter_rows_plain(pool, rows, idx)
    from nanokappa_torch.ops import _cuda

    if pool.dim() != 2 or pool.dtype != torch.float32 or not pool.is_contiguous():
        raise ValueError("scatter_rows: pool must be a contiguous (C, N) float32 tensor")
    C, N = pool.shape
    E = idx.shape[0]
    if rows.shape != (C, E) or rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError("scatter_rows: rows must be a contiguous (C, E) float32 tensor")
    if idx.dtype != torch.int32 or not idx.is_contiguous() or rows.device != pool.device \
            or idx.device != pool.device:
        raise ValueError("scatter_rows: idx must be a contiguous int32 tensor on the pool's device")
    lib = _cuda.library()
    err = lib.nk_scatter_rows(
        _cuda.ptr(pool), _cuda.ptr(rows), _cuda.ptr(idx), C, N, E, _cuda.stream(pool),
    )
    _cuda.check(err, "nk_scatter_rows")
    launches += 1
    return pool
