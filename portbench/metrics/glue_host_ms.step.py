"""glue_host_ms.step: the host time of the program's step entries
(``msgwam.step`` and ``msgwam.simulate``, their union) less the part its
launch spans cover, per model step of the traced window: the torch glue
and Python of a step loop around the kernels."""

from portbench import spans


def read(ctx):
    if ctx.trace is None or not ctx.trace_steps:
        return None
    events = spans.program(ctx.trace)
    entries = ("msgwam.step", "msgwam.simulate")
    if not spans.covered(events, spans.named(*entries)):
        return None
    return 1e-3 * spans.self_us(events, entries) / ctx.trace_steps
