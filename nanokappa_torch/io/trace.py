"""Tracing and profiling utilities of the driver (the JAX package's
nanokappa_tpu/io/trace.py, with torch.profiler in place of jax.profiler):

  * `PhaseTimer` — per-phase wall-clock accumulation for the driver loop
    (device work is timed to a synchronize at the phase's edge), keeping
    every call's duration so a caller can read the last few,
  * `trace()` — a context manager around torch.profiler (CPU and CUDA
    activities) that writes a Chrome trace (`--profile <dir>` in the CLI),
  * the timestamped convergence rows give the steps/second telemetry.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class PhaseTimer:
    def __init__(self):
        self.calls: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.calls[name].append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.calls.get(name, ()))

    def report(self, **counts) -> str:
        """Every phase's total and mean a call, then each of `counts`."""
        lines = ["phase timings:"]
        for name, ts in sorted(self.calls.items(), key=lambda kv: -sum(kv[1])):
            tot, n = sum(ts), len(ts)
            lines.append(
                f"  {name:<24s} {tot:8.2f} s total, {tot / max(n, 1) * 1e3:8.2f} ms/call x{n}"
            )
        lines += [f"  {name:<24s} {value}" for name, value in counts.items()]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler over the block; writes `log_dir/trace.json`. No-op
    when log_dir is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
