"""kernel.compact_pool_roofline: kernel B's (ops/compact_pool.py +
csrc/compact_pool.cu) share of its roofline on the timed path: its kernels
(count_alive, the shared scan_runs that follows it, move_lanes) over the
profiled batch, divided by the batch's launches; the bytes the survivors
need (roofline.kernel_b_bytes) over 3.35 TB/s."""

import roofline

# its kernels; the scan both A and B launch (None) goes to the call it follows
OWNERS = {"count_alive": "B", "move_lanes": "B", "scan_runs": None}


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    if tr is None or c is None:
        return None
    n = c["launches"].get("compact_pool", 0)
    t = tr.owned_kernels(OWNERS).get("B", 0.0)
    if n <= 0 or t <= 0:
        return None
    return roofline.share_percent(roofline.kernel_b_bytes(ctx.layout_rows, c["n_alive"]), 0.0, t / n)
