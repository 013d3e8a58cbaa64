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
the dispatch took on the stream, not the sum of its kernels. The hand
kernels' wrappers take a span and have their C entry point record its
two events right around the launch (``device_events``), so those spans
hold the kernel and the launch's own latency, not the wrapper's host
work. Event pairs are kept in a pool and reused after each flush.

With the variable unset, or set to ``xprof`` (the device-trace route of
``frontend/benchmark.py``, which times no span), a span is a shared
no-op context (``NULL_SPAN``): nothing is recorded and nothing is
printed.

``KernelTimer`` and ``timed`` are the reference's own contract, as the
JAX package has them (``slambench_tpu/utils/timers.py``): the host clock
around one dispatch, a device fence on its result at the end (the CUDA
TOCK's ``cudaDeviceSynchronize``, reference: cuda/kernels.cu:23-38) and
the line printed at once. ``frontend/timed.py`` times every kernel of
its frame that way; the fence serialises the host and the card, so the
time holds the launch and the fence's round trip.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Tuple

import torch


def kernel_timings_enabled() -> bool:
    """KERNEL_TIMINGS env gate (reference: cpp/kernels.cpp:69-70)."""
    return bool(os.environ.get("KERNEL_TIMINGS"))


def spans_enabled() -> bool:
    """KERNEL_TIMINGS is set to a value that asks for spans: anything but
    empty and ``xprof``."""
    value = os.environ.get("KERNEL_TIMINGS", "")
    return bool(value) and value.lower() != "xprof"


def xprof_enabled() -> bool:
    """KERNEL_TIMINGS=xprof: the device-trace route."""
    return os.environ.get("KERNEL_TIMINGS", "").lower() == "xprof"


class _NullSpan:
    """The span when timing is off: a no-op context, and no events for a
    kernel's launch."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def device_events(self) -> Tuple[int, int]:
        return 0, 0


NULL_SPAN = _NullSpan()


class KernelTimings:
    """Spans of one pipeline's dispatches: ``with t.span("integrate",
    n): ...`` records the span; ``t.flush()`` after the device fence
    prints one ``name ns size`` line per span and forgets them."""

    def __init__(self, device: torch.device):
        # The reference's env gate (cpp/kernels.cpp:69-70).
        self.enabled = spans_enabled()
        self._cuda = torch.device(device).type == "cuda"
        self._spans: List[Tuple[str, int, object, object]] = []
        self._free: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def span(self, name: str, size: int = 0):
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, size)

    def _event_pair(self) -> Tuple[torch.cuda.Event, torch.cuda.Event]:
        """Two timing events from the pool; a new pair is recorded once
        so that its CUDA events exist (torch creates them lazily)."""
        if self._free:
            return self._free.pop()
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        for ev in pair:
            ev.record()
        return pair

    def flush(self, stream=None) -> List[Tuple[str, int, int]]:
        """Print and return ``(name, ns, size)`` of every span recorded
        since the last flush. Call it after the device fence: on the card
        it reads the events, waiting for the last one."""
        out = []
        if self._spans and self._cuda:
            for _, _, _, end in self._spans:
                end.synchronize()
        for name, size, start, end in self._spans:
            if self._cuda:
                ns = int(round(start.elapsed_time(end) * 1e6))
                self._free.append((start, end))
            else:
                ns = end - start
            out.append((name, ns, size))
        self._spans.clear()
        stream = sys.stderr if stream is None else stream
        for name, ns, size in out:
            print(f"{name} {ns} {size}", file=stream)
        return out


class _Span:
    __slots__ = ("owner", "name", "size", "start", "events")

    def __init__(self, owner: KernelTimings, name: str, size: int):
        self.owner, self.name, self.size = owner, name, size

    def __enter__(self):
        if self.owner._cuda:
            self.events = self.owner._event_pair()
            self.events[0].record()
        else:
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.owner._cuda:
            start, end = self.events
            end.record()
        else:
            start, end = self.start, time.perf_counter_ns()
        self.owner._spans.append((self.name, self.size, start, end))
        return False

    def device_events(self) -> Tuple[int, int]:
        """The raw handles of an event pair for a kernel's C entry point
        to record around its launch; the span is logged at once."""
        start, end = self.owner._event_pair()
        self.owner._spans.append((self.name, self.size, start, end))
        return start.cuda_event, end.cuda_event


def _cuda_device_of(value) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``value`` (a tensor, or a
    tuple, list or dict of them), else None."""
    if isinstance(value, torch.Tensor):
        return value.device if value.is_cuda else None
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        for item in value:
            device = _cuda_device_of(item)
            if device is not None:
                return device
    return None


class KernelTimer:
    """``with KernelTimer("track", size) as t: t.result = fn()`` prints
    ``track <ns> <size>`` to stderr when enabled, after fencing the
    device that holds the assigned result.

    Assign the value to be fenced to ``.result`` inside the block (or it
    times only the host's dispatch, like an unfenced TOCK). On the CPU the
    ops run synchronously and the host clock alone is read.
    """

    def __init__(self, name: str, size: int = 0, stream=None,
                 enabled: Optional[bool] = None):
        self.name = name
        self.size = size
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = (kernel_timings_enabled()
                        if enabled is None else enabled)
        self.result = None
        self.elapsed_ns = 0

    def __enter__(self):
        if self.enabled:
            self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        device = _cuda_device_of(self.result)
        if device is not None:
            torch.cuda.synchronize(device)
        self.elapsed_ns = time.monotonic_ns() - self._t0
        print(f"{self.name} {self.elapsed_ns} {self.size}",
              file=self.stream)
        return False


def timed(name: str, fn, *args, size: int = 0, **kwargs):
    """Run ``fn`` under a KernelTimer, fencing its output."""
    with KernelTimer(name, size) as t:
        t.result = fn(*args, **kwargs)
    return t.result
