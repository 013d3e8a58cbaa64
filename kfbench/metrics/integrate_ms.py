"""Device ms a frame of ``KFusion.integration``, captured as a CUDA graph of
its own and replayed in turn with the other phases (``phases.py``)."""


def read(ctx):
    return ctx.get("phase_ms", {}).get("integration")
