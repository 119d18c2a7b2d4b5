"""step_ms_p95: the 95th percentile of every step's wall time in the
measured window (the call on the whole batch, then the observation on the
host), in ms, over all steps of the window."""

import statistics


def read(ctx):
    if len(ctx.step_s) < 2:
        return None
    return statistics.quantiles(ctx.step_s, n=100, method="inclusive")[94] * 1e3
