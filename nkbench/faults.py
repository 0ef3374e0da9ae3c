"""Faults planted in the program underneath a run, to show that the
correctness check catches a broken timed path (control.py --faults on the
card at the cell's own size, tests/test_nkbench_faults.py on the CPU).

    with plant("unchanged"):
        harness.run_cell(...)

The faults a one-card cell can have:
  unchanged    kernel A leaves the pool as it was (a step that returns its
               state unchanged);
  half         kernel A moves only the first half of the particles (half of
               the batch left out; the sums are taken over the rest);
  one_particle kernel A's output has one particle moved 1 A (an answer
               altered where it is produced);
  injection    the reservoirs inject at the reference temperature (the
               injected occupation deviation is 0);
  narrow       the narrow rounds hand every particle back as it came;
  datapoint    the driver's datapoint has its first slice 0.05 K warmer.
The exchange between cards has no fault to plant: every cell runs on one
card, with no collective.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half", "one_particle", "injection", "narrow", "datapoint")


@contextlib.contextmanager
def plant(fault: str):
    from nanokappa_torch.driver import Simulation
    from nanokappa_torch.ops import megastep
    from nanokappa_torch.sim import fused
    from nanokappa_torch.sim.state import C_ALIVE, C_DEV

    saved = [(megastep, "drift_megastep", megastep.drift_megastep),
             (fused, "sample_injections", fused.sample_injections),
             (fused, "run_event_buffer", fused.run_event_buffer),
             (Simulation, "_observe", Simulation._observe)]
    real_mega, real_inj, real_evt, real_obs = (s[2] for s in saved)

    def mega(pool, T_sv, rta_on, cfg, seed=0):
        if fault == "unchanged":
            return real_mega(pool.clone(), T_sv, rta_on, cfg, seed=seed)
        if fault == "half":
            alive = (pool[C_ALIVE] > 0.5).nonzero().flatten()
            n = int(alive[alive.numel() // 2]) if alive.numel() else 0
            half = pool[:, :n].clone()
            out = real_mega(half, T_sv, rta_on, cfg, seed=seed)
            pool[:, :n] = half
            return out
        out = real_mega(pool, T_sv, rta_on, cfg, seed=seed)
        alive = (pool[C_ALIVE] > 0.5).nonzero()
        if alive.numel():
            pool[2, int(alive[0])] += 1.0
        return out

    def inj(*a, **k):
        out = real_inj(*a, **k)
        out[0][C_DEV] = 0.0
        return out

    def evt(rows, vbuf, *a, **k):
        out = real_evt(rows, vbuf, *a, **k)
        out[0][: rows.shape[0]] = rows  # every particle handed back as it came
        out[0][C_ALIVE] = vbuf.float()
        return out

    def observe(self, out):
        row = real_obs(self, out)
        row["T"] = row["T"].copy()
        row["T"][0] += 0.05
        return row

    if fault in ("unchanged", "half", "one_particle"):
        megastep.drift_megastep = mega
    elif fault == "injection":
        fused.sample_injections = inj
    elif fault == "narrow":
        fused.run_event_buffer = evt
    elif fault == "datapoint":
        Simulation._observe = observe
    else:
        raise ValueError(f"no fault {fault!r} (the faults: {', '.join(FAULTS)})")
    try:
        yield
    finally:
        for obj, name, f in saved:
            setattr(obj, name, f)
