"""host_gap_ms.day: the mean idle time between one whole-run kernel
launch (K5 or K6, ``step_resident_kernel``) and the next, over every
launch of the traced window, day boundaries included: the host's launch
loop as the device sees it."""

from portbench import trace

KERNEL = "step_resident_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    g = trace.kernel_gaps_s(ctx.trace.device, KERNEL)
    return 1e3 * sum(g) / len(g) if g else None
