"""program_idle_share: the share of the traced window's wall time in which
the device was idle (a gap between two device operations) while the host
was inside one of the program's spans (``msgwam.*``): the idle time the
program's own host code causes.  ``idle_share`` less this is the idle time
caused outside the program."""

from portbench import spans, trace


def read(ctx):
    w = ctx.trace
    if w is None or not w.device:
        return None
    inside = spans.covered(spans.program(w), lambda name: True)
    if not inside:
        return None
    idle = spans.intersect(trace.gaps(w.device), inside)
    return 100.0 * spans.length(idle) * 1e-6 / w.wall_s
