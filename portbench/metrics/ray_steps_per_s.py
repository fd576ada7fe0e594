"""ray_steps_per_s: every slot of the population times every step
completed in the measured window, over the window's wall seconds (host
clock, from the first request's call to the host copy of the last)."""

from portbench import stats


def read(ctx):
    return stats.rate(ctx.slots, ctx.window_steps, ctx.window_s)
