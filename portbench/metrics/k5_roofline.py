"""k5_roofline: K5's bound for the traced steps (portbench.roofline, from
the rays' covered cells) over K5's device time in them; K5 runs the whole
steps of a deployment without lifecycle or imposed wind, in a day of whole
runs or in the experiment driver's launches."""

from portbench import roofline, trace

KERNEL = "step_resident_kernel"


def read(ctx):
    d = ctx.driver
    if ctx.trace is None or d.kind == "stepwise" or d.lifecycle:
        return None
    t = trace.kernel_time_s(ctx.trace.device, KERNEL)
    if t <= 0:
        return None
    bound = roofline.whole_run_step_s(ctx.slots, ctx.cells, d.save_every,
                                      deposit=True) * ctx.trace_steps
    return 100.0 * bound / t
