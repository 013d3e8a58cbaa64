"""Per-kernel timing in the reference's KERNEL_TIMINGS format.

The reference gates per-kernel timing on the KERNEL_TIMINGS environment
variable and prints ``name duration_ns size`` lines to stderr
(reference: kfusion/src/cpp/kernels.cpp:16-37, 57), which
``eval/check_kernels.py`` aggregates. The port times the production
dispatches where they run: a span around a kernel launch or an op
records two CUDA events on the current stream and adds no host sync, so
the ICP loop runs exactly as it does untimed. The events are read once a
frame, after the frame's fence (``flush``). On the CPU the ops run
synchronously and a span reads the host clock instead.

An event pair measures the stream's time between the two records. Where
the host enqueues slower than the card runs (the ICP solve's many small
ops), that time includes the card waiting for the host: it is the time
the dispatch took on the stream, not the sum of its kernels.

With the variable unset a span is a shared no-op context: nothing is
recorded and nothing is printed.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import List, Tuple

import torch

_NULL = contextlib.nullcontext()


class KernelTimings:
    """Spans of one pipeline's dispatches: ``with t.span("integrate",
    n): ...`` records the span; ``t.flush()`` after the device fence
    prints one ``name ns size`` line per span and forgets them."""

    def __init__(self, device: torch.device):
        # The reference's env gate (cpp/kernels.cpp:69-70).
        self.enabled = bool(os.environ.get("KERNEL_TIMINGS"))
        self._cuda = torch.device(device).type == "cuda"
        self._spans: List[Tuple[str, int, object, object]] = []

    def span(self, name: str, size: int = 0):
        if not self.enabled:
            return _NULL
        return _Span(self, name, size)

    def _now(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter_ns()

    def flush(self, stream=None) -> List[Tuple[str, int, int]]:
        """Print and return ``(name, ns, size)`` of every span recorded
        since the last flush. Call it after the device fence: on the card
        it reads the events, waiting for the last one."""
        out = []
        if self._spans and self._cuda:
            self._spans[-1][3].synchronize()
        for name, size, start, end in self._spans:
            if self._cuda:
                ns = int(round(start.elapsed_time(end) * 1e6))
            else:
                ns = end - start
            out.append((name, ns, size))
        self._spans.clear()
        stream = sys.stderr if stream is None else stream
        for name, ns, size in out:
            print(f"{name} {ns} {size}", file=stream)
        return out


class _Span:
    __slots__ = ("owner", "name", "size", "start")

    def __init__(self, owner: KernelTimings, name: str, size: int):
        self.owner, self.name, self.size = owner, name, size

    def __enter__(self):
        self.start = self.owner._now()
        return self

    def __exit__(self, *exc):
        self.owner._spans.append((self.name, self.size, self.start,
                                  self.owner._now()))
        return False
