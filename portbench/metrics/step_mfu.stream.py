"""step_mfu.stream: the whole step's share of the card's peak where the
rays outnumber the card's on-chip storage: the least time the card needs
for the traced steps of a whole run (portbench.roofline_stream: the
operations, or the launch's state and the streamed rays' bytes of every
stage) over the traced window's wall time.  Whatever kernel carries the
step, this share bounds ``k5_roofline.stream``."""

from portbench import roofline_stream


def read(ctx):
    d = ctx.driver
    if ctx.trace is None or not ctx.trace.device or d.kind != "whole_run":
        return None
    coupled = bool(ctx.setup.conf["model"]["prognostic_mean"])
    per_step = roofline_stream.whole_run_step_s(ctx.slots, ctx.cells,
                                                d.save_every, deposit=coupled)
    return 100.0 * per_step * ctx.trace_steps / ctx.trace.wall_s
