"""step.ms_per_step: the driver's `device_step` phase (the runner's 100
steps, synchronised at the phase's edge) over the traced run's window, in
ms a step."""


def read(ctx):
    ts = ctx.phases.get("device_step", [])
    return 1e3 * sum(ts) / ctx.steps if ts and ctx.steps else None
