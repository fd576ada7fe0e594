"""setup_s: from the start of the process to the first timed request
(host clock): the build where the checkout has none, the inputs, the
warm-up request."""


def read(ctx):
    return ctx.setup_s
