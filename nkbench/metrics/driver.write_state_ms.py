"""driver.write_state_ms: the driver's particle_data.txt checkpoint (with
the subvolume files), its PhaseTimer `write_state` phase, mean ms a
checkpoint over the traced run's window (the batches after the profiled
one)."""


def read(ctx):
    ts = ctx.phases.get("write_state", [])
    return 1e3 * sum(ts) / len(ts) if ts else None
