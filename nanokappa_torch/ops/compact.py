"""Kernel C — stream compaction: the indices of a mask's True entries,
packed to the front of a cap-wide int32 buffer.

Replaces the Pallas kernel `compact_indices_pallas` / `_kernel` of
nanokappa_tpu/ops/compact.py (:68 / :36). Returns (idx (cap,) int32 with
sentinel N in the unused lanes, n_valid = min(count, cap) as a () int32
tensor). On the film it compacts the event machinery's round-2+ survivors
(N = EVT_CAP = 2048 lanes into cap = 512).

CUDA design (csrc/compact.cu): one launch a call, a single-pass chained
scan with decoupled look-back. A tile is 256 threads x 16 mask bytes (one
16-byte load a thread; a mask at an odd address or of a ragged length takes
byte loads at its two ends); a tile's id comes from an atomic ticket, it
ranks its lanes by a block scan of its threads' popcounts
(`nk::block_rank_bits`), publishes its count and then its inclusive prefix
in a 64-bit status word, and reads its predecessors' words a warp at a
time back to the nearest inclusive prefix; every True lane below `cap` is
written at its global rank (ascending lane order). The tile with the last id writes n_valid and the
sentinel tail; the last tile to finish zeroes the scratch again, so the
next call, or a CUDA graph's replay, finds it zeroed (no host-side epoch,
no memset). What bounds it on the card: at the main paths' widths (2,048
to 1,277,952 lanes, 2 KB to 1.3 MB of mask) it is one launch of a few
microseconds — launch latency and the tiles' chain, not bytes. The TPU
kernel's in-register log-shift network and its XLA assembly are not
ported: a scan computes the same function.
"""

from __future__ import annotations

import torch

launches = 0  # kernel launches (the CUDA path only)

TILE = 4096  # mask lanes a tile of the kernel
MAX_N = 2**31 - 16  # lane ids and the sentinel n are int32
_SCRATCH: dict[int, torch.Tensor] = {}  # device index -> the kernel's scratch


def compact_indices_plain(mask: torch.Tensor, cap: int):
    """The plain torch version: the function kernel C computes."""
    n = mask.shape[0]
    idx = torch.nonzero(mask).flatten().to(torch.int32)[:cap]
    n_valid = torch.tensor(idx.shape[0], dtype=torch.int32, device=mask.device)
    out = torch.full((cap,), n, dtype=torch.int32, device=mask.device)
    out[: idx.shape[0]] = idx
    return out, n_valid


def _scratch(device: torch.device) -> torch.Tensor:
    """The kernel's scratch on one device (a ticket, a finished count and a
    status word a tile, for any n up to MAX_N: 4 MiB), zeroed once; each
    launch leaves it zeroed. Calls on one device must run in one stream's
    order, and the first one outside a CUDA graph's capture."""
    s = _SCRATCH.get(device.index)
    if s is None:
        words = 1 + -(-(MAX_N + 15) // TILE)
        s = _SCRATCH[device.index] = torch.zeros(words, dtype=torch.int64, device=device)
    return s


def compact_indices(mask: torch.Tensor, cap: int):
    """(idx (cap,) i32, n_valid () i32): a CPU mask takes the plain version,
    a CUDA mask launches kernel C. Both are views of one (cap + 1,) int32
    buffer, the call's only allocation."""
    global launches
    if mask.device.type != "cuda":
        return compact_indices_plain(mask, cap)
    from nanokappa_torch.ops import _cuda

    if mask.dim() != 1 or mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError("compact_indices: mask must be a contiguous 1-D bool tensor")
    n = mask.shape[0]
    if n > MAX_N:
        raise ValueError(f"compact_indices: {n} lanes exceed the int32 ids ({MAX_N})")
    lib = _cuda.library()
    out = torch.empty(cap + 1, dtype=torch.int32, device=mask.device)
    err = lib.nk_compact_indices(
        _cuda.ptr(mask), n, cap, _cuda.ptr(out), _cuda.ptr(_scratch(mask.device)), _cuda.stream(mask),
    )
    _cuda.check(err, "nk_compact_indices")
    launches += 1
    return out.narrow(0, 0, cap), out.select(0, cap)
