"""Mean latency of all frames of the window, each from its hand-in to
its pose on the host; nothing where the mix reads no pose a call."""


def read(ctx):
    lat = ctx.get("latencies_s")
    if not lat:
        return None
    return 1e3 * sum(lat) / len(lat)
