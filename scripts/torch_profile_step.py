"""Where the port's film step spends its time on the card.

    python scripts/torch_profile_step.py

Builds the film exactly as chip_smoke.py does, warms up one run of
n_inner = 10 steps, then records one more run with torch.profiler (CPU and
CUDA activities). Prints the step's wall time, the device's busy share
(summed kernel time over the wall time of the window), the top operators by
host and by device time, and writes the Chrome trace to
chiprun_out/torch_step_trace.json. Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


STEPS = 10


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_step: needs a CUDA card")
    from chip_smoke import MESH, PARTICLES, SEED, card_line, film_ctx, film_params
    from nanokappa_torch.sim.state import init_state
    from nanokappa_torch.sim.step import build_step

    device = torch.device("cuda:0")
    mat, dom, geo, btab = film_ctx(MESH, device)
    n_p, rtab, params = film_params(mat, dom, geo, PARTICLES, device)
    state = init_state(mat, dom, geo, params, n_p, btab, temp_dist="linear", seed=SEED)
    run = build_step(geo, mat.device_tables(device), btab, rtab, params, n_inner=STEPS)
    for _ in range(2):
        state, _ = run(state)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, out = run(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(
        e.self_device_time_total for e in events if e.device_type.name == "CUDA"
    )
    print(card_line())
    print(f"run of {STEPS} steps: {wall * 1e3:.3f} ms wall, "
          f"{wall / STEPS * 1e3:.3f} ms/step; kernels {dev_us / 1e3:.3f} ms "
          f"= device busy {dev_us / 1e6 / wall:.4f} of the window")
    print(events.table(sort_by="self_cpu_time_total", row_limit=25))
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace("chiprun_out/torch_step_trace.json")


if __name__ == "__main__":
    main()
