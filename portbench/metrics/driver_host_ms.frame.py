"""driver_host_ms.frame: the time of the traced requests of the
experiment driver (the union of the ``portbench.request`` spans) outside
the program's whole runs (``msgwam.whole_run``) and outside the whole-run
kernel's device time (``step_resident_kernel``), per saved frame: the
driver's per-frame host path (its synchronize and reads, the frame's pack
and copy to the host, the history writer, the diagnostics' deposits, the
checkpoints) while no step runs.  The wait for the kernel in the
synchronize after each launch is not the driver's and is left out."""

from portbench import spans

KERNEL = "step_resident_kernel"


def read(ctx):
    w = ctx.trace
    if w is None or ctx.driver.kind != "cli_run":
        return None
    requests = spans.covered(w.host, spans.named("portbench.request"))
    if not requests:
        return None
    steps = spans.union(
        [(e.start_us, e.end_us) for e in w.host if e.name == "msgwam.whole_run"]
        + [(e.start_us, e.end_us) for e in w.device if KERNEL in e.name])
    us = spans.length(requests) - spans.length(spans.intersect(requests, steps))
    return 1e-3 * us / (ctx.trace_requests * ctx.driver.n_launches)
