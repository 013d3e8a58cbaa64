"""The window's arithmetic: percentiles, the union of device intervals
and the integrate's least bytes.

Pure Python on plain inputs, so the CPU tests hold every
formula that turns a run's readings into a metric.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

# Published peak of one NVIDIA H100 SXM (HBM3), NVIDIA's data sheet.
HBM_BYTES_PER_S = 3.35e12


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) over all ``values`` by nearest
    rank: the smallest value with at least ``q`` of them at or below."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Merged, sorted, disjoint cover of ``(start, end)`` intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_and_span(intervals: Sequence[Tuple[float, float]]
                  ) -> Tuple[float, float]:
    """(time covered by at least one interval, first start to last
    end)."""
    merged = union(intervals)
    if not merged:
        return 0.0, 0.0
    busy = sum(b - a for a, b in merged)
    return busy, merged[-1][1] - merged[0][0]


def idle_share_pct(busy: float, span: float) -> float:
    """100% less the busy share of the span (``chip_smoke.py:
    trace_idle_share``'s arithmetic)."""
    return 100.0 * (1.0 - busy / span)


def gaps(intervals: Sequence[Tuple[float, float]]
         ) -> List[Tuple[float, float]]:
    """The idle stretches between the merged intervals, in order."""
    merged = union(intervals)
    return [(merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]


def integrate_bytes(updated_voxels: float, depth_pixels: int) -> float:
    """The least bytes a frame's integrate moves: each voxel it updates
    read and written once as an int16 value and an int8 weight (3 bytes
    each way), and the float32 depth map read once."""
    return 6.0 * updated_voxels + 4.0 * depth_pixels


def roofline_pct(nbytes: float, ms: float,
                 bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    """The least time for ``nbytes`` at the peak rate over the time
    taken, in percent."""
    return 100.0 * (nbytes / bytes_per_s) / (ms * 1e-3)
