"""stream_share.day: the share, in %, of the whole-run kernels' (K5-K7)
tile-stages in the traced window whose state was streamed through device
memory rather than held on chip, from the placement the program counts
from each launch's block plan (``profiling.counts()["placement"]``, read
after the window); ``None`` for a program that counts none."""

from portbench import spans

KERNELS = ("K5", "K6", "K7")


def read(ctx):
    if ctx.trace is None:
        return None
    placement = (spans.program_counts() or {}).get("placement")
    if not placement:
        return None
    kernels = [placement[k] for k in KERNELS if k in placement]
    streamed = sum(p["streamed"] for p in kernels)
    total = streamed + sum(p["on_chip"] for p in kernels)
    return 100.0 * streamed / total if total else None
