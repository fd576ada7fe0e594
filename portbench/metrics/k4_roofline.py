"""k4_roofline: K4's bound for one launch (portbench.roofline: 81 B a ray,
each input and output once, and the operations of the rays' covered
cells) over K4's mean device time a launch (``stage_kernel``) in the
traced window."""

from portbench import roofline

KERNEL = "stage_kernel"


def read(ctx):
    if ctx.trace is None or ctx.driver.kind != "stepwise":
        return None
    ks = [e for e in ctx.trace.device if KERNEL in e.name]
    if not ks:
        return None
    t = sum(e.end_us - e.start_us for e in ks) * 1e-6 / len(ks)
    return 100.0 * roofline.k4_launch_s(ctx.slots, ctx.cells) / t
