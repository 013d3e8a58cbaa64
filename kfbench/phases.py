"""Device ms of each phase of the frame step, each phase captured as a
CUDA graph of its own.

The phases are ``KFusion.preprocessing``, ``tracking``,
``integration(on_device=True)`` and ``raycasting(early_exit=False)``,
the steps ``KFusion.scan_step`` chains on the graph route. All four
graphs read and write one set of static state buffers, as
``graphs.py:PeriodGraph`` does for a whole period, so replaying them in
turn chains the phases frame after frame. Each replay sits between a
pair of CUDA events; a spin kernel queued first holds the card while
the host queues the replays, so the events time the card's work and
not the host's pace (the arithmetic of ``tools/timing.py:graph_ms`` and
``per_launch_ms``, which ``tools/profile_frame.py:op_rows`` uses).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

PHASES = ("preprocessing", "tracking", "integration", "raycasting")
SPIN_CYCLES = 100_000_000          # about 50 ms at the H100's SM clock


class PhaseGraphs:
    def __init__(self, kf, state, depth_shape):
        dev = kf.device
        self.kf = kf
        self.names = tuple(f.name for f in dataclasses.fields(state))
        self.state_type = type(state)
        self.buf = {n: getattr(state, n).clone() for n in self.names}
        self.depth = torch.empty(depth_shape, dtype=torch.int32, device=dev)
        self.fns = {
            "preprocessing": lambda s: kf.preprocessing(s, self.depth),
            "tracking": kf.tracking,
            "integration": lambda s: kf.integration(
                s, integrate_frame=True, force_integrate=False,
                on_device=True),
            "raycasting": lambda s: kf.raycasting(s, early_exit=False),
        }
        stream = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):          # warm-up, dropped
            s = self.state_type(**{n: b.clone()
                                   for n, b in self.buf.items()})
            for name in PHASES:
                s = self.fns[name](s)
        cur.wait_stream(stream)
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        for name in PHASES:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=stream):
                self._body(self.fns[name])
            self.graphs[name] = g
        torch.cuda.synchronize(dev)

    def _body(self, fn) -> None:
        """One phase from the buffers, its new leaves written back (a
        leaf sharing storage with a buffer is cloned first)."""
        s = fn(self.state_type(**self.buf))
        storages = {b.untyped_storage().data_ptr()
                    for b in self.buf.values()}
        pending = []
        for n in self.names:
            new, buf = getattr(s, n), self.buf[n]
            if new.data_ptr() == buf.data_ptr():
                continue
            if new.untyped_storage().data_ptr() in storages:
                new = new.clone()
            pending.append((buf, new))
        for buf, new in pending:
            buf.copy_(new)

    def run(self, depths: torch.Tensor) -> dict:
        """Replay the phases over ``depths [n, H, W]`` in turn: ``{"ms":
        {phase: device ms a frame}, "poses": [n] poses and "depths": [n]
        float depth maps the integrate of each frame used}``."""
        n = depths.shape[0]
        ev = {p: [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(n)]
              for p in PHASES}
        poses: List[torch.Tensor] = []
        fds: List[torch.Tensor] = []
        torch.cuda._sleep(SPIN_CYCLES)
        for i in range(n):
            self.depth.copy_(depths[i])
            for p in PHASES:
                ev[p][i][0].record()
                self.graphs[p].replay()
                ev[p][i][1].record()
                if p == "integration":
                    poses.append(self.buf["pose"].clone())
                    fds.append(self.buf["float_depth"].clone())
        torch.cuda.synchronize(self.kf.device)
        ms = {p: sum(a.elapsed_time(b) for a, b in ev[p]) / n
              for p in PHASES}
        return {"ms": ms, "poses": poses, "depths": fds}
