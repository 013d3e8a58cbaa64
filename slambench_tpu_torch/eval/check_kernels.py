"""Per-kernel timing statistics from 'name nanoseconds' stderr streams
(a copy of ``slambench_tpu/eval/check_kernels.py``; the port imports
nothing of the JAX package).

Re-implementation of the reference's kernel-log aggregator
(reference: kfusion/thirdparty/checkKernels.py): parses lines of
``kernelName duration_ns [size]`` (produced with KERNEL_TIMINGS set:
on the phased CLI by ``frontend/timed.py``, the reference's rows with K1
and K2 as ``bilateralFilter`` and ``reduce``; on the other routes by
``utils/timers.py``'s spans), unifies backend-specific kernel-name
variants (reference: checkKernels.py:16-32) and prints
count/min/max/mean per kernel. On the spans' routes the port's two
fused kernels give one row each for a pair of the reference's rows; the
table says which pair (on the card their spans are events that the
kernels' C entry points record right around the launch, so a span holds
the launch's latency and the kernel), and ``missing_rows`` checks a log
against the row set of the JAX package's KERNEL_TIMINGS route.

CLI: ``python -m slambench_tpu_torch.eval.check_kernels <kernels.log>``.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

# Kernel-name unification across backends
# (reference: checkKernels.py:16-32 merges CUDA/OpenCL/CPP variants).
UNIFY = {
    "mm2metersKernel": "mm2meters",
    "mm2meters": "mm2meters",
    "bilateralFilterKernel": "bilateralFilter",
    "bilateral_filter": "bilateralFilter",
    "halfSampleRobustImageKernel": "halfSampleRobustImage",
    "half_sample": "halfSampleRobustImage",
    "depth2vertexKernel": "depth2vertex",
    "depth2vertex": "depth2vertex",
    "vertex2normalKernel": "vertex2normal",
    "vertex2normal": "vertex2normal",
    "trackKernel": "track",
    "track": "track",
    "reduceKernel": "reduce",
    "reduce": "reduce",
    "track_and_reduce": "track+reduce",
    "integrateKernel": "integrate",
    "integrate": "integrate",
    "raycastKernel": "raycast",
    "raycast": "raycast",
    "renderDepthKernel": "renderDepth",
    "renderTrackKernel": "renderTrack",
    "renderVolumeKernel": "renderVolume",
    "initVolumeKernel": "initVolume",
    "updatePoseKernel": "updatePose",
    "solve": "updatePose",
    "checkPoseKernel": "checkPose",
    "renderDepth": "renderDepth",
    "renderTrack": "renderTrack",
    "renderVolume": "renderVolume",
    # TPU-only kernel (min-mip maintenance; no reference counterpart).
    "make_min_mip": "minMip",
    # The port's fused hand kernels: K1F and K2F.
    "mm2m_bilateral": "mm2meters+bilateralFilter",
    "track_reduce": "track+reduce",
}


# The rows of the JAX package's KERNEL_TIMINGS route
# (slambench_tpu/frontend/timed.py:117-193).
JAX_ROWS = ("mm2meters", "bilateralFilter", "halfSampleRobustImage",
            "depth2vertex", "vertex2normal", "track", "reduce",
            "updatePose", "checkPose", "integrate", "minMip", "raycast")

# A fused row stands for the pair of reference rows its kernel computes.
FUSED_ROWS = {
    "mm2meters+bilateralFilter": ("mm2meters", "bilateralFilter"),
    "track+reduce": ("track", "reduce"),
}


def missing_rows(agg: Dict[str, np.ndarray]) -> List[str]:
    """The JAX route's row names that ``agg`` has no row for, a fused
    row counting for both of its pair."""
    have = set(agg)
    for fused, pair in FUSED_ROWS.items():
        if fused in agg:
            have.update(pair)
    return [name for name in JAX_ROWS if name not in have]


def aggregate_kernel_log(path_or_lines) -> Dict[str, np.ndarray]:
    """Aggregate a kernel-timing stream into name -> durations_ns."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines: List[str] = f.read().splitlines()
    else:
        lines = list(path_or_lines)
    out: Dict[str, List[float]] = {}
    for line in lines:
        parts = line.split()
        if len(parts) < 2:
            continue
        name = UNIFY.get(parts[0], parts[0])
        try:
            ns = float(parts[1])
        except ValueError:
            continue
        out.setdefault(name, []).append(ns)
    return {k: np.asarray(v) for k, v in out.items()}


def print_statistics(agg: Dict[str, np.ndarray], out=sys.stdout) -> None:
    total = 0.0
    for name in sorted(agg.keys()):
        v = agg[name]
        total += float(np.sum(v))
        print("%28.28s\tcount : %d\tMin : %10.0f\tMax : %10.0f\tMean : %10.0f"
              % (name, len(v), np.min(v), np.max(v), np.mean(v)), file=out)
    print("%28.28s\tTotal ns : %0.0f" % ("ALL", total), file=out)
    for fused, pair in FUSED_ROWS.items():
        if fused in agg:
            print("%28.28s\tstands for %s (one fused kernel launch; on "
                  "the card the span is the launch and the kernel)"
                  % (fused, " + ".join(pair)), file=out)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("I need one parameter, the kernel timing log file.")
        return 1
    agg = aggregate_kernel_log(argv[0])
    print_statistics(agg)
    missing = missing_rows(agg)
    if missing:
        print("%28.28s\t%s" % ("missing JAX rows", ", ".join(missing)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
