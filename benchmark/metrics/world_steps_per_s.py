"""world_steps_per_s: worlds x steps completed in the measured window,
over the window's seconds (host clock; each step ends in a device sync)."""


def read(ctx):
    return ctx.n_worlds * len(ctx.step_s) / ctx.window_s
