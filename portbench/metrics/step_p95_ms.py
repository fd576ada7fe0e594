"""step_p95_ms: the 95th percentile, by the nearest rank, over every
request of the measured window of a step loop, each timed on the host
from the caller's call to its wind profile arriving on the host.  Nothing
to read in a mix whose requests are not single steps."""

from portbench import stats


def read(ctx):
    if ctx.driver.kind != "stepwise" or ctx.driver.steps != 1:
        return None
    return stats.percentile(ctx.durations, 95.0) * 1e3
