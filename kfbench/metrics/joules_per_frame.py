"""The card's NVML energy counter across the window over the frames
completed (``energy.py``); nothing where there is no counter."""


def read(ctx):
    if ctx.get("joules") is None:
        return None
    return ctx["joules"] / ctx["frames"]
