"""The yardstick of the kernel rooflines: the card's published peaks and the
bytes and float32 operations that one launch of kernel A (the drift
megastep) or kernel B (the pool compaction) needs for its inputs.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates at the full 700 W
power limit. A card set below that limit runs slower under load; the
harness prints the card's limit beside every share.

Byte counts follow the pool layouts of nanokappa_torch/sim/state.py: a pool
is (C, N) float32, C = 18 rows on the "slim" layout, 24 on "full", 16 on
"plain"; ints ride as int32 bits in float32 rows. What a launch needs is
counted, not what the pool could hold: each ALIVE lane's C rows read once
and written once, never the pool's capacity N.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
R8 = 8  # kernel A's ledger rows (csrc/megastep.cu)
A_LANE_OPS = 150  # float32 operations of one lane's RTA, drift and sums
CAST_OPS = 45  # float32 operations of one Moller-Trumbore ray-triangle test


def sv8(n_subvols: int) -> int:
    """Kernel A's subvolume rows, padded to a multiple of eight."""
    return max(8, -(-n_subvols // 8) * 8)


def kernel_a_bytes(rows: int, n_alive: float, kept: float, n_subvols: int) -> float:
    """One kernel A launch: the alive lanes' rows read and written, each
    exported lane's rows and its pool index written, the per-subvolume
    sums [e, e vx, e vy, e vz, n] and the per-reservoir ledger written."""
    return 2.0 * rows * 4 * n_alive + kept * (rows * 4 + 4) + (sv8(n_subvols) + R8) * 5 * 4


def kernel_a_ops(n_alive: float, recasts: float, n_triangles: int) -> float:
    """One kernel A launch: the per-lane arithmetic, and a triangle cast
    (CAST_OPS a triangle) for each lane an in-kernel event re-emitted."""
    return A_LANE_OPS * n_alive + CAST_OPS * n_triangles * recasts


def kernel_b_bytes(rows: int, n_alive: float) -> float:
    """One kernel B launch: each surviving lane's alive flag read, and its
    rows read once and written once into the packed pool."""
    return 2.0 * rows * 4 * n_alive + 4.0 * n_alive


def least_seconds(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(seconds, what bounds them): the larger of bytes over the memory
    peak and operations over the float32 peak."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def share_percent(n_bytes: float, n_ops: float, seconds: float) -> float | None:
    """The launch's share of its roofline in percent, None without a time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * least_seconds(n_bytes, n_ops)[0] / seconds
