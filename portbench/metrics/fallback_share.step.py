"""fallback_share.step: the share of K4's tile windows in the traced window
that left the first window (the second tier or the full width), counted by
the kernel itself (the program's ``profiling.counts()``, read after the
window)."""

from portbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.fallback_share(spans.program_counts(), ("K4",))
