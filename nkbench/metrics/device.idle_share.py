"""device.idle_share: 1 - (the union of the device's kernel, memcpy and
memset intervals) / the wall of the profiled batch (its device_step
through its checkpoint), in percent."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
