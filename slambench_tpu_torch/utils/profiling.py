"""A device trace of a region (port of ``slambench_tpu/utils/
profiling.py:trace``).

``trace(logdir)`` writes a ``torch.profiler`` Chrome trace of the
enclosed region to ``logdir/trace.json``. On the card it records CUDA
activity only: the counterpart of JAX's ``device_trace_options``, which
turns the host and python tracers off so that host events cannot crowd
the device's out of the trace buffer. On the CPU there is no device
activity: it records the CPU's and says so on stderr.

It leaves CUPTI subscribed after the region: every later eager launch
of the process is slower (by about a third a frame on the H100), so
trace after the timing. With ``TEARDOWN_CUPTI=1`` a second session after
a teardown hung the process at exit on the H100 (``tools/
profile_frame.py --trace`` after its profiled window).
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch


@contextlib.contextmanager
def trace(logdir: str, device: torch.device = torch.device("cuda")):
    """Trace the enclosed region on ``device``; yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    if device.type == "cuda":
        activities = [ProfilerActivity.CUDA]
    else:
        print(f"trace: no device on {device}; {logdir} holds the CPU's "
              "trace", file=sys.stderr)
        activities = [ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        yield logdir
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
