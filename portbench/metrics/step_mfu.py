"""step_mfu: the whole step's share of the card's peak: the least time the
card needs for the traced steps (portbench.roofline: the whole-run
kernel's bound a step, or three K4 launches' bound a step of the step
loop) over the traced window's wall time.  The experiment driver's
diagnostics (K1) are not the step, and their work is not counted.  Whatever kernel carries the
step, this share bounds every kernel's roofline that moves the rate."""

from portbench import roofline


def read(ctx):
    d = ctx.driver
    if ctx.trace is None or not ctx.trace.device:
        return None
    if d.kind != "stepwise":
        deposit = bool(ctx.setup.conf["model"]["prognostic_mean"])
        per_step = roofline.whole_run_step_s(ctx.slots, ctx.cells, d.save_every,
                                             deposit=deposit)
    else:
        per_step = 3 * roofline.k4_launch_s(ctx.slots, ctx.cells)
    return 100.0 * per_step * ctx.trace_steps / ctx.trace.wall_s
