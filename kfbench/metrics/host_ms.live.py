"""Median over the window's frames of a frame's latency less the device
time between CUDA events recorded around its ``compute_frames_scan``
call (the hand-in, the graph replay and its copies): the host's own
share of a frame."""

import statistics


def read(ctx):
    vals = ctx.get("host_ms")
    return statistics.median(vals) if vals else None
