"""The card's cost of a kernel in a CUDA graph replay, apart from the
program: a graph of many one-element adds, replayed and timed with CUDA
events. A run reads it before and after its window, so each run says
which speed the card was in (``PERF.md``: replays of the same graph
take one of two times for seconds to minutes)."""

from __future__ import annotations

import statistics
from typing import Tuple


def launch_us(device, kernels: int = 2000, replays: int = 5
              ) -> Tuple[float, float]:
    """Device microseconds a kernel, the median over ``replays`` replays
    of a graph of ``kernels`` in-place adds on one float: (launched on
    an idle stream, queued behind a 20 ms sleep kernel). Behind the
    sleep the host has handed over the whole graph before the device
    reaches it, so the second reads the device alone; the first also
    reads how fast the host hands the graph's kernels over."""
    import torch
    x = torch.zeros(1, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        x.add_(1.0)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(kernels):
            x.add_(1.0)
    cycles = 40_000_000                 # ~20 ms at the H100's ~1.98 GHz
    out = []
    for queued in (False, True):
        ms = []
        for _ in range(replays):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(cycles)
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        out.append(1e3 * statistics.median(ms) / kernels)
    del graph
    return out[0], out[1]

