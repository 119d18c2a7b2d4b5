"""device_idle_pct: the share of the profiled window (the measured loop,
steps unsynced inside) in which no kernel, copy or set ran on the card."""


def read(ctx):
    p = ctx.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
