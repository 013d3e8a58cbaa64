"""100% less the device's busy share of the traced span: the union of
the device intervals of the profiler's trace over the span from the
first to the last (``trace.py``); nothing without device activity."""


def read(ctx):
    trace = ctx.get("trace")
    return None if trace is None else trace.idle_share_pct()
