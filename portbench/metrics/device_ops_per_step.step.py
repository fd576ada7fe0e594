"""device_ops_per_step.step: device operations (kernels and copies) of
the traced window per model step, in a step loop: the torch glue and host
copies around the port's kernels."""


def read(ctx):
    if ctx.trace is None or ctx.driver.kind != "stepwise" or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.trace_steps
