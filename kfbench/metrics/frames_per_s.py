"""Steady frames completed in the window over the window's wall time."""


def read(ctx):
    return ctx["frames"] / ctx["window_s"]
