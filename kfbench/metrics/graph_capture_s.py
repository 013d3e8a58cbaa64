"""Capture plus instantiate seconds of the cell's CUDA graph signatures,
as ``ScanGraphs.captures`` records them."""


def read(ctx):
    caps = ctx.get("captures")
    if not caps:
        return None
    return sum(c["capture_s"] + c["instantiate_s"] for c in caps)
