"""Kernel times and bounds on the card.

``per_launch_ms`` times a run of back-to-back calls between one pair of
CUDA events and divides by their count. A spin kernel
(``torch.cuda._sleep``) queued ahead of the start event holds the card
while the host queues the calls, so a short kernel is timed by the card's
work and not by the host's launch rate. When the host cannot queue the
calls before the spin ends (a plain-torch twin issues hundreds of small
kernels a call), the reading is flagged ``host_bound``: it then includes
the host's pacing.

``graph_ms`` times the calls captured once as a CUDA graph and
replayed: the card's time with no host pacing. ``timed_row`` gives a
step both readings as one row, the form ``tools/profile_frame.py`` and
``tools/probe_r3.py`` print.

``call_ms`` is the tuning tools' reading: ``per_launch_ms`` on the card,
the host clock on the CPU (where the tools label their lines so).

``bound_ms`` is the least time the card could take for the same work:
the larger of the bytes moved over the memory rate and the operations
over the float32 rate (published H100 SXM peaks, at the 700 W limit).
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
L2_BYTES = 50e6                  # H100 L2 cache
SM_CLOCK_HZ = 1.98e9             # H100 SXM max SM clock: sizes the spin
MAX_SPIN_S = 0.05


def bound_ms(nbytes: float, ops: float = 0.0) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def bound_by(nbytes: float, ops: float = 0.0) -> str:
    return ("operations" if ops / F32_OPS_PER_S > nbytes / HBM_BYTES_PER_S
            else "bytes")


def per_launch_ms(fn: Callable[[], object], reps: int = 100,
                  runs: int = 5) -> Tuple[float, bool]:
    """(median over ``runs`` of the per-call ms of ``reps`` back-to-back
    calls, whether the host paced the calls in most runs)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    spin_cycles = int(min(2.0 * (time.perf_counter() - t0), MAX_SPIN_S)
                      * SM_CLOCK_HZ)
    times, paced = [], 0
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        paced += bool(start.query())
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), paced > runs // 2


class Chain:
    """A step that feeds ``fn`` its own last output (``carry``), starting
    from ``start``. It holds the input of the first call made under a
    capture: a graph's replays read it, and the chain would drop it."""

    def __init__(self, fn: Callable[[object], object], start: object):
        self.fn, self.carry, self.held = fn, start, None

    def __call__(self) -> None:
        if self.held is None and torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing():
            self.held = self.carry
        self.carry = self.fn(self.carry)


def graph_ms(step: Callable[[], object], reps: int, device: torch.device,
             runs: int = 3) -> float:
    """ms a step: ``reps`` back-to-back calls of ``step`` captured once as
    a CUDA graph, then the median over ``runs`` replays, each timed by a
    CUDA-event pair, divided by ``reps``: the card's time for the steps
    with no host pacing (JAX's in-jit ``fori_loop``). A step that chains
    keeps its carry where the next call reads it, so the graph chains
    the ``reps`` steps too.

    ``step`` first runs once eagerly on the capture's side stream, as
    ``graphs.py`` warms up: that builds the kernels, allocates K2F's
    per-stream scratch and fills ``geometry.constant``'s cache, none of
    which a capture allows. A step that reads the host cannot be
    captured, and the capture raises."""
    stream = torch.cuda.Stream(device)
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        step()
    cur.wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            step()
    graph.replay()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def timed_row(step: Callable[[], object], reps: int, device: torch.device,
              route: str, runs: int = 3,
              eager: Optional[Callable[[], object]] = None,
              graph: bool = True) -> dict:
    """The row of ``reps`` calls on the card, as the tools print it:
    ``{"ms", "eager_ms", "host_bound", "route", "reps"}``. ``ms`` is
    ``step`` as a graph replay (``graph_ms``; the eager reading where
    ``graph`` is False, for a step that reads the host), ``eager_ms`` and
    ``host_bound`` are ``eager`` (by default ``step``) from
    ``per_launch_ms``. On the CPU each step runs once and every reading
    is None."""
    eager = eager or step
    if device.type != "cuda":
        step()
        if eager is not step:
            eager()
        ms = eager_ms = paced = None
    else:
        eager_ms, paced = per_launch_ms(eager, reps, runs)
        ms = graph_ms(step, reps, device, runs) if graph else eager_ms
    return {"ms": ms, "eager_ms": eager_ms, "host_bound": paced,
            "route": route, "reps": reps}


def call_ms(fn: Callable[[], object], reps: int, device: torch.device,
            runs: int = 3) -> float:
    """ms a call of ``fn``: ``per_launch_ms`` (the median of ``runs``) on
    the card; on the CPU the host clock over ``reps`` calls after one
    warm-up call."""
    if device.type == "cuda":
        return per_launch_ms(fn, reps, runs)[0]
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3
