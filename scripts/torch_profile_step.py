"""Where the port's step spends its time on the card.

    python scripts/torch_profile_step.py [film|kfilm0|wire|bigmesh|plate|star]     # default: film

Builds the film (pooled reservoirs), the film under the k model (`kfilm0`:
the eta = 0 bench film on the full 24-row mirror layout), the nanowire, the
large mesh (the 96-sided cylinder) or the perforated plate (its STL written
to a temporary folder, Voronoi 8 subvolumes; all three 'constant'
reservoirs) exactly as chip_smoke.py does, or the star
(examples/voronoi_star.txt on the v1 step, built by `Simulation` from
chip_smoke.py's arguments, its results folder temporary), warms up two runs of
n_inner = 10 steps, then records one more run with torch.profiler (CPU and
CUDA activities). Prints the step's wall time, the device's busy share
(summed kernel time over the wall time of the window), the launches per
step, the top operators by host and by device time, and writes the Chrome
trace to chiprun_out/torch_step_trace_<config>.json. Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
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
    from chip_smoke import (
        BIGMESH, FILM, MESH, PARTICLES, PLATE, SEED, WIRE, build_ctx, card_line,
        perforated_plate, run_params, star_argv,
    )
    from nanokappa_torch.material import synthetic_material
    from nanokappa_torch.sim.state import init_state
    from nanokappa_torch.sim.step import build_step

    config = sys.argv[1] if len(sys.argv) > 1 else "film"
    configs = {"film": (FILM, "pooled"), "kfilm0": (FILM, "pooled"), "wire": (WIRE, "constant"),
               "bigmesh": (BIGMESH, "constant")}
    if config == "plate":
        import tempfile

        from nanokappa_torch.geometry import stl

        stl_path = os.path.join(tempfile.mkdtemp(prefix="profile_plate_"), "plate.stl")
        stl.save_stl(perforated_plate(), stl_path)
        configs["plate"] = (dict(PLATE, geometry=stl_path), "constant")
    device = torch.device("cuda:0")
    mat = synthetic_material(mesh=(MESH, MESH, MESH))
    if config == "star":
        import tempfile

        from nanokappa_torch.driver import Simulation
        from nanokappa_torch.io.config import read_args

        sim = Simulation(read_args(star_argv(tempfile.mkdtemp(prefix="profile_star_"), device)), material=mat)
        geo, btab, rtab, params, state = sim.geo, sim.btab, sim.rtab, sim.params, sim.state
    else:
        domain_kw, res_gen = configs[config]
        scat = "k" if config == "kfilm0" else "velocity"
        dom, geo, btab = build_ctx(mat, domain_kw, device, scat)
        n_p, rtab, params = run_params(mat, dom, PARTICLES, res_gen, device)
        params = dataclasses.replace(params, scat_model=scat)
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
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(card_line())
    print(f"{config} ({state.layout} pool): run of {STEPS} steps: {wall * 1e3:.3f} ms wall, "
          f"{wall / STEPS * 1e3:.3f} ms/step; kernels {dev_us / 1e3:.3f} ms "
          f"= device busy {dev_us / 1e6 / wall:.4f} of the window; "
          f"{launches / STEPS:.1f} cudaLaunchKernel per step")
    print(events.table(sort_by="self_cpu_time_total", row_limit=25))
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(f"chiprun_out/torch_step_trace_{config}.json")


if __name__ == "__main__":
    main()
