"""Kernel times and bounds on the card.

``per_launch_ms`` times a run of back-to-back calls between one pair of
CUDA events and divides by their count. A spin kernel
(``torch.cuda._sleep``) queued ahead of the start event holds the card
while the host queues the calls, so a short kernel is timed by the card's
work and not by the host's launch rate. When the host cannot queue the
calls before the spin ends (a plain-torch twin issues hundreds of small
kernels a call), the reading is flagged ``host_bound``: it then includes
the host's pacing.

``call_ms`` is the tuning tools' reading: ``per_launch_ms`` on the card,
the host clock on the CPU (where the tools label their lines so).

``bound_ms`` is the least time the card could take for the same work:
the larger of the bytes moved over the memory rate and the operations
over the float32 rate (published H100 SXM peaks, at the 700 W limit).
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Tuple

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
