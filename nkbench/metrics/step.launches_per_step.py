"""step.launches_per_step: the runtime's kernel launches (cudaLaunchKernel
and its variants, host side) over the profiled batch, a step."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not tr.steps:
        return None
    return tr.launches / tr.steps
