"""k1_roofline: K1's bound for one call (portbench.roofline_k1: the
activity byte of every slot, one value row, both edges and the phase
volume of each active ray, from the frames' active rays and covered
cells), over K1's mean device time a call (``project_kernel``) in the
traced window.  The experiment driver deposits each saved frame twice:
the wave action on the face grid's cells, its flux on the center grid's;
the bound is the mean of the two."""

from portbench import roofline_k1

KERNEL = "project_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    ks = [e for e in ctx.trace.device if KERNEL in e.name]
    if not ks:
        return None
    t = sum(e.end_us - e.start_us for e in ks) * 1e-6 / len(ks)
    n_cell = ctx.setup.bg.centers.shape[0]
    bound = 0.5 * sum(roofline_k1.k1_call_s(ctx.slots, ctx.active_rays, cells,
                                            ctx.cells)
                      for cells in (n_cell, n_cell - 1))
    return 100.0 * bound / t
