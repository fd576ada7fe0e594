"""k6_roofline: K6's bound for the traced steps (portbench.roofline, from
the rays' covered cells; no deposit where the wind is imposed and not
coupled) over K6's device time in them; K6 runs the whole steps of a
deployment with the lifecycle or an imposed wind."""

from portbench import roofline, trace

KERNEL = "step_resident_kernel"


def read(ctx):
    d = ctx.driver
    if ctx.trace is None or d.kind != "whole_run" or not d.lifecycle:
        return None
    t = trace.kernel_time_s(ctx.trace.device, KERNEL)
    if t <= 0:
        return None
    coupled = bool(ctx.setup.conf["model"]["prognostic_mean"])
    bound = roofline.whole_run_step_s(ctx.slots, ctx.cells, d.save_every,
                                      deposit=coupled) * ctx.trace_steps
    return 100.0 * bound / t
