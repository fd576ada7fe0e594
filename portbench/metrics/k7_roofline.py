"""k7_roofline: K7's bound for the traced steps (portbench.roofline, from
the rays' covered cells over every member; the deposit where the wind is
coupled) over the device time of K7, the ``kStream=true`` instantiation
of ``step_resident_kernel``, in them; K7 runs the whole steps of a
member-stacked deployment, all members in one launch."""

from portbench import roofline

KERNEL = "step_resident_kernel"


def read(ctx):
    d = ctx.driver
    if ctx.trace is None or d.kind != "whole_run" or not ctx.setup.members:
        return None
    t = sum(e.end_us - e.start_us for e in ctx.trace.device
            if KERNEL in e.name and "true" in e.name) * 1e-6
    if t <= 0:
        return None
    coupled = bool(ctx.setup.conf["model"]["prognostic_mean"])
    bound = roofline.whole_run_step_s(ctx.slots, ctx.cells, d.save_every,
                                      deposit=coupled) * ctx.trace_steps
    return 100.0 * bound / t
