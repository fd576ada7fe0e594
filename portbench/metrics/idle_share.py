"""idle_share: the share of the traced window's wall time in which no
operation ran on the device (the profiler's device records)."""

from portbench import trace


def read(ctx):
    w = ctx.trace
    if w is None or not w.device:
        return None
    return 100.0 * (1.0 - trace.busy_s(w.device) / w.wall_s)
