"""Kernel C — stream compaction: the indices of a mask's True entries,
packed to the front of a cap-wide int32 buffer.

Replaces the Pallas kernel `compact_indices_pallas` / `_kernel` of
nanokappa_tpu/ops/compact.py (:68 / :36). Returns (idx (cap,) int32 with
sentinel N in the unused lanes, n_valid = min(count, cap) as a () int32
tensor). On the film it compacts the event machinery's round-2+ survivors
(N = EVT_CAP = 2048 lanes into cap = 512).

CUDA design (csrc/compact.cu): a block scan in three launches — per-block
True counts (`__syncthreads_count`), one block's exclusive scan of those
counts, then each block ranks its lanes with warp ballots and writes every
True lane below `cap` to its global rank (ascending lane order); a fourth
launch writes the sentinel past n_valid. What bounds it on the card: at the
film's 2048-lane mask it is four launches of a few microseconds — launch
latency, not bytes; the design keeps it to one pass over the mask and no
host synchronisation. The TPU kernel's in-register log-shift network and its
XLA assembly are not ported: a scan computes the same function.
"""

from __future__ import annotations

import torch

launches = 0  # kernel launches (the CUDA path only)


def compact_indices_plain(mask: torch.Tensor, cap: int):
    """The plain torch version: the function kernel C computes."""
    n = mask.shape[0]
    idx = torch.nonzero(mask).flatten().to(torch.int32)[:cap]
    n_valid = torch.tensor(idx.shape[0], dtype=torch.int32, device=mask.device)
    out = torch.full((cap,), n, dtype=torch.int32, device=mask.device)
    out[: idx.shape[0]] = idx
    return out, n_valid


def compact_indices(mask: torch.Tensor, cap: int):
    """(idx (cap,) i32, n_valid () i32): a CPU mask takes the plain version,
    a CUDA mask launches kernel C."""
    global launches
    if mask.device.type != "cuda":
        return compact_indices_plain(mask, cap)
    from nanokappa_torch.ops import _cuda

    if mask.dim() != 1 or mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError("compact_indices: mask must be a contiguous 1-D bool tensor")
    lib = _cuda.library()
    n = mask.shape[0]
    nb = -(-n // 256)
    idx = torch.empty(cap, dtype=torch.int32, device=mask.device)
    n_valid = torch.empty((), dtype=torch.int32, device=mask.device)
    scratch = torch.empty(2 * nb + 1, dtype=torch.int32, device=mask.device)
    err = lib.nk_compact_indices(
        _cuda.ptr(mask), n, cap, _cuda.ptr(idx), _cuda.ptr(n_valid),
        _cuda.ptr(scratch), _cuda.stream(mask),
    )
    _cuda.check(err, "nk_compact_indices")
    launches += 1
    return idx, n_valid
