"""loop_host_ms.day: the host time of the program's whole runs
(``msgwam.whole_run``) less the part its launch spans cover, per launch of
the traced window: the host launch loop of K5-K7 (the checks, the wind
table, the templates, the frames and each launch's scratch)."""

from portbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    events = spans.program(ctx.trace)
    n = spans.launches(events)
    if not n or not spans.covered(events, spans.named("msgwam.whole_run")):
        return None
    return 1e-3 * spans.self_us(events, ("msgwam.whole_run",)) / n
