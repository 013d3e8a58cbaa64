"""Process start to the window's start: imports, CUDA and the program's
kernels, the frames, frames 0-4 and the graph captures."""


def read(ctx):
    return ctx["setup_s"]
