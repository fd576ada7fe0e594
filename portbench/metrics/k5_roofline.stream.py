"""k5_roofline.stream: K5's bound for the traced steps with the bytes of
the rays past the card's on-chip capacity counted stage by stage
(portbench.roofline_stream, from the rays' covered cells), over the device
time of K5, the ``kStream=false`` instantiation of
``step_resident_kernel``, in them.  For a column larger than any kernel
can hold on chip, where ``k5_roofline``'s bound leaves those bytes out."""

from portbench import roofline_stream

KERNEL = "step_resident_kernel"


def read(ctx):
    d = ctx.driver
    if ctx.trace is None or d.kind != "whole_run":
        return None
    t = sum(e.end_us - e.start_us for e in ctx.trace.device
            if KERNEL in e.name and "false" in e.name) * 1e-6
    if t <= 0:
        return None
    coupled = bool(ctx.setup.conf["model"]["prognostic_mean"])
    bound = roofline_stream.whole_run_step_s(ctx.slots, ctx.cells, d.save_every,
                                             deposit=coupled) * ctx.trace_steps
    return 100.0 * bound / t
