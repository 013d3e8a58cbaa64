"""PerfStats: typed, insertion-ordered named metric series.

A copy of ``slambench_tpu/utils/perfstats.py`` (the port imports nothing
of the JAX package).

Re-implementation of the reference's performance-statistics registry
(reference: kfusion/thirdparty/perfstats.h:32-360): named series with a
type tag (TIME/POWER/ENERGY/DISTANCE/FRAME/...), per-sample insertion,
per-frame row printing, and a final summary with mean/std/min/max per
series. One module-level ``Stats`` instance mirrors the reference's
global (reference: mainQt.cpp:31).
"""

from __future__ import annotations

import sys
import time
from enum import Enum
from typing import Dict, List, Optional


class StatType(Enum):
    """Series type tags (reference: perfstats.h:32-46)."""
    TIME = "time"
    COUNT = "count"
    PERCENTAGE = "percentage"
    ENERGY = "energy"
    POWER = "power"
    VOLTAGE = "voltage"
    CURRENT = "current"
    FREQUENCY = "frequency"
    INT = "int"
    DOUBLE = "double"
    DISTANCE = "distance"
    FRAME = "frame"
    UNDEFINED = "undefined"


class PerfStats:
    def __init__(self):
        self._order: List[str] = []
        self._data: Dict[str, List[float]] = {}
        self._types: Dict[str, StatType] = {}
        self._last_print_len = 0

    def sample(self, key: str, value: float,
               type_: StatType = StatType.UNDEFINED) -> None:
        """Append a sample (reference: perfstats.h:90-110)."""
        if key not in self._data:
            self._order.append(key)
            self._data[key] = []
            self._types[key] = type_
        self._data[key].append(float(value))

    def start(self) -> float:
        self._start_time = time.monotonic()
        return self._start_time

    def sample_time(self, key: str) -> float:
        """Sample elapsed wall time since the previous mark under ``key``
        and reset the mark (the reference's double-call idiom)."""
        now = time.monotonic()
        elapsed = now - getattr(self, "_start_time", now)
        self.sample(key, elapsed, StatType.TIME)
        self._start_time = now
        return elapsed

    def get(self, key: str) -> List[float]:
        return self._data.get(key, [])

    def last(self, key: str) -> Optional[float]:
        v = self._data.get(key)
        return v[-1] if v else None

    def mean(self, key: str) -> float:
        v = self._data.get(key, [])
        return sum(v) / len(v) if v else 0.0

    def reset(self, key: Optional[str] = None) -> None:
        if key is None:
            self._order.clear()
            self._data.clear()
            self._types.clear()
        else:
            self._data[key] = []

    @property
    def keys(self) -> List[str]:
        return list(self._order)

    def print_header(self, out=sys.stdout) -> None:
        print("\t".join(self._order), file=out)

    def print_row(self, out=sys.stdout) -> None:
        """Last sample of each series, tab-separated
        (reference: perfstats.h:150-230 ``print``)."""
        row = []
        for k in self._order:
            v = self.last(k)
            row.append("" if v is None else "%10.7f" % v)
        print("\t".join(row), file=out)

    def print_all_data(self, out=sys.stdout) -> None:
        """Final summary: mean/σ/min/max per series
        (reference: perfstats.h:240-360 ``print_all_data``)."""
        for k in self._order:
            v = self._data[k]
            if not v:
                continue
            n = len(v)
            mean = sum(v) / n
            var = sum((x - mean) ** 2 for x in v) / n
            print("%-24s mean: %12.7f  std: %12.7f  min: %12.7f  "
                  "max: %12.7f  n: %d"
                  % (k, mean, var ** 0.5, min(v), max(v), n), file=out)


# Global instance, like the reference's `PerfStats Stats`
# (reference: mainQt.cpp:31).
Stats = PerfStats()
