"""Instrumentation: performance statistics, kernel timers, power/energy
monitoring, buffer comparators (the reference's L6 layer: perfstats.h,
PowerMonitor, TICK/TOCK macros, commons.h comparators)."""

from slambench_tpu_torch.utils.timers import (  # noqa: F401
    KernelTimer, kernel_timings_enabled, timed,
)
