"""The traced stretch: a ``torch.profiler`` trace of a few of the mix's
calls after the window, read into device intervals and host spans.

``Trace`` holds what the readers in ``kfbench/metrics/`` take: the
device's busy seconds and the traced span (``busy_and_span``, the union
of the device intervals, a copy of ``chip_smoke.py:trace_idle_share``'s
arithmetic), the device operations that took most time, and the
longest idle gaps named by the innermost host span that was open at
their middle (the harness labels its own steps with
``record_function``).
"""

from __future__ import annotations

import collections
from typing import Callable, List, Optional, Tuple

import torch

from kfbench import stats


class Trace:
    def __init__(self, device_events: List[Tuple[str, float, float]],
                 host_events: List[Tuple[str, float, float]],
                 window_s: float):
        self.device_events = device_events      # (name, start s, end s)
        self.host_events = host_events
        self.window_s = window_s
        iv = [(a, b) for _, a, b in device_events]
        self.busy_s, self.span_s = stats.busy_and_span(iv)
        self._iv = iv

    @property
    def has_device(self) -> bool:
        return self.busy_s > 0

    def idle_share_pct(self) -> Optional[float]:
        if not self.has_device:
            return None
        return stats.idle_share_pct(self.busy_s, self.span_s)

    def top_ops(self, n: int = 10) -> List[list]:
        tot: dict = collections.defaultdict(float)
        for name, a, b in self.device_events:
            tot[name] += b - a
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        out = []
        for a, b in sorted(stats.gaps(self._iv),
                           key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (a + b)
            name, best = "no host span", None
            for hn, ha, hb in self.host_events:
                if ha <= mid <= hb and (best is None or ha > best):
                    name, best = hn, ha
            out.append([name, b - a])
        return out


def _events(prof) -> list:
    """(name, start ns, duration ns, on device) of every event. The
    harness's ``record_function`` labels also show on the device's lane
    (as ``gpu_user_annotation``), spanning their launches: they are host
    spans here, not device work."""
    cuda = torch.autograd.DeviceType.CUDA
    try:
        evs = prof.profiler.kineto_results.events()
        return [(e.name(), e.start_ns(), e.duration_ns(),
                 e.device_type() == cuda and not e.is_user_annotation())
                for e in evs]
    except AttributeError:
        return [(e.name, e.time_range.start * 1000,
                 (e.time_range.end - e.time_range.start) * 1000,
                 e.device_type == cuda and not e.is_user_annotation)
                for e in prof.events()]


def traced(fn: Callable[[], None], device: torch.device) -> Trace:
    """Run ``fn`` under the profiler (device and host activity) and read
    the trace. ``window_s`` is the host clock around ``fn`` and the
    synchronize after it."""
    import time
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for name, start, dur, on_dev in _events(prof):
        if dur <= 0:
            continue
        rec = (name, start * 1e-9, (start + dur) * 1e-9)
        (dev if on_dev else host).append(rec)
    return Trace(dev, host, window_s)
