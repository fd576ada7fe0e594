"""fallback_share.day: the share of the whole-run kernels' (K5-K7) tile
windows in the traced window that left the first window (the second tier
or the full width), counted by the kernels themselves (the program's
``profiling.counts()``, read after the window)."""

from portbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.fallback_share(spans.program_counts(), ("K5", "K6", "K7"))
