"""kernel.megastep_roofline: kernel A's (ops/megastep.py + csrc/megastep.cu)
share of its roofline on the timed path. Its device time a launch is every
kernel one call launches (mega_lanes, the shared scan_runs that follows it,
mega_export, mega_reduce) over the profiled batch, divided by the batch's
launches (the module's launch counter); the least time is the larger of
the bytes the inputs need over 3.35 TB/s and the float32 operations over
67 TFLOP/s (roofline.py)."""

import roofline

# its kernels; the scan both A and B launch (None) goes to the call it follows
OWNERS = {"mega_lanes": "A", "mega_export": "A", "mega_reduce": "A", "scan_runs": None}


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    if tr is None or c is None:
        return None
    n = c["launches"].get("megastep", 0)
    t = tr.owned_kernels(OWNERS).get("A", 0.0)
    if n <= 0 or t <= 0:
        return None
    diffused, flagged, swaps, exported = c["events"]
    n_bytes = roofline.kernel_a_bytes(ctx.layout_rows, c["n_alive"], exported / n, ctx.n_subvols)
    n_ops = roofline.kernel_a_ops(c["n_alive"], diffused / n, ctx.n_triangles)
    return roofline.share_percent(n_bytes, n_ops, t / n)
