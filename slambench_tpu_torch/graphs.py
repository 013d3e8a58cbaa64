"""CUDA graphs of the frame step: the port's counterpart of ``jax.jit`` of
the ``lax.scan`` bodies in ``slambench_tpu/pipeline.py``
(``_compute_frames_scan``, ``_compute_frames_scan_rated``).

``ScanGraphs.run`` runs a batch of gate periods on the card. Each period
is one replay of a graph that holds ``KFusion.scan_step`` once per frame
of the period (K1F once and K2F 19 times a tracked frame at pyramid
10,5,4, with every plain-torch op between them). A graph is captured
once per signature, the counterpart of one compile: the period's gates,
the frame shape, the backend, the motion model and the warm start.

* **Static buffers.** The graph reads the state from a copy of every
  leaf and the period's frames from a depth buffer, and ends by writing
  each new leaf back into the state copy, so replays chain with no host
  work. A batch copies its state in first and hands out a clone of the
  buffers at the end: the state a caller holds is never the graph's.
* **Outputs.** The graph writes each frame's ``scan_row`` (position,
  tracked, integrated) into a ``[L, 5]`` buffer; after each replay one
  device-to-device copy puts it into the batch's output, which the host
  reads once.
* **Warm-up.** Before capture the period runs once eagerly on the
  capture's side stream, on the static buffers (its result is
  dropped). That builds the nvcc kernels, allocates K2F's per-stream
  scratch and ticket outside the graph's pool (the ticket is left 0 by
  the last block of every launch, so replays reuse it), and fills
  ``geometry.constant``'s cache (an uncached constant is a host copy,
  which a capture refuses).
* **Launches.** The wrappers count their eager launches (the warm-up's
  among them) and, apart, the calls recorded under capture
  (``fused_captured``); a replay passes no wrapper. ``launches`` tallies
  the hand kernels the replays launch: the calls recorded in the
  period's capture, once per replay.

A failed capture or replay raises; nothing falls back to the eager
step. KERNEL_TIMINGS spans are CUDA events that a replay cannot re-time,
so the route refuses to run with them on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import torch

from slambench_tpu_torch.ops.hopper import bilateral, reduce


def scan_row(state) -> torch.Tensor:
    """One frame's outputs as f32 ``[5]``: the pose translation, then
    tracked and integrated as 0/1 (all exact in float32)."""
    return torch.cat([state.pose[:3, 3],
                      state.tracked.to(torch.float32).reshape(1),
                      state.integrated.to(torch.float32).reshape(1)])


def unpack_rows(rows: torch.Tensor) -> dict:
    """``[N, 5]`` rows -> JAX's scan outputs ``{"pos": [N, 3],
    "tracked": [N], "integrated": [N]}``."""
    return {"pos": rows[:, :3], "tracked": rows[:, 3] != 0,
            "integrated": rows[:, 4] != 0}


def _hand_captured() -> Dict[str, int]:
    return {"K1F": bilateral.fused_captured, "K2F": reduce.fused_captured}


class PeriodGraph:
    """One captured gate period and its static buffers."""

    def __init__(self, kf, state, depth_shape: Tuple[int, int],
                 gates: tuple):
        dev = kf.device
        self.kf, self.gates = kf, gates
        self.names = tuple(f.name for f in dataclasses.fields(state))
        self.state = {n: getattr(state, n).clone() for n in self.names}
        self.state_type = type(state)
        self.depth = torch.empty((len(gates), *depth_shape),
                                 dtype=torch.int32, device=dev)
        self.out = torch.empty((len(gates), 5), dtype=torch.float32,
                               device=dev)
        self.graph = torch.cuda.CUDAGraph()
        self.captured: Dict[str, int] = {}
        self.capture_s = self.instantiate_s = 0.0

    def load(self, state) -> None:
        for n in self.names:
            self.state[n].copy_(getattr(state, n))

    def export(self):
        """A clone of the state buffers as a state."""
        return self.state_type(**{n: b.clone()
                                  for n, b in self.state.items()})

    def _period(self):
        """The period's steps from the static buffers; returns the new
        state and writes each frame's row into ``out``."""
        s = self.state_type(**self.state)
        for i, (tracking_on, integrate_frame) in enumerate(self.gates):
            s = self.kf.scan_step(s, self.depth[i], tracking_on=tracking_on,
                                  integrate_frame=integrate_frame)
            self.out[i].copy_(scan_row(s))
        return s

    def _body(self) -> None:
        """The captured body: the period, then every new leaf into its
        state buffer. A leaf that still is its buffer is skipped; one
        that shares storage with another buffer (``old_pose`` is the
        incoming ``pose``) is cloned before any buffer is written."""
        s = self._period()
        buffers = {b.untyped_storage().data_ptr()
                   for b in self.state.values()}
        pending = []
        for n in self.names:
            new, buf = getattr(s, n), self.state[n]
            if new.data_ptr() == buf.data_ptr():
                continue
            if new.untyped_storage().data_ptr() in buffers:
                new = new.clone()
            pending.append((buf, new))
        for buf, new in pending:
            buf.copy_(new)

    def capture(self, stream: torch.cuda.Stream) -> None:
        """Warm up on ``stream``, then capture the body there."""
        cur = torch.cuda.current_stream(self.kf.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            self._period()
        cur.wait_stream(stream)
        before = _hand_captured()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, stream=stream):
            self._body()
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        self.captured = {k: v - before[k]
                         for k, v in _hand_captured().items()}
        self.capture_s, self.instantiate_s = t1 - t0, t2 - t1


class ScanGraphs:
    """The captured periods of one ``KFusion``, by signature, and the
    tally of the hand kernels their replays ran."""

    def __init__(self, kf):
        self.kf = kf
        self._graphs: Dict[tuple, PeriodGraph] = {}
        self._stream = None
        self.launches = {"K1F": 0, "K2F": 0}
        self.captures: List[dict] = []

    def run(self, state, depths: torch.Tensor, gates: tuple):
        """``depths [K, L, H, W]`` (int32 on the card) as K replays of the
        period graph of ``gates`` (one ``(tracking_on, integrate_frame)``
        pair a frame). Returns the new state and the ``[K * L, 5]`` rows."""
        kf = self.kf
        if kf.timings.enabled:
            raise RuntimeError(
                "KERNEL_TIMINGS spans cannot time a CUDA graph replay: run "
                "the batched routes with KERNEL_TIMINGS unset or =xprof")
        K, L = depths.shape[:2]
        if L != len(gates):
            raise ValueError(f"{L} frames a period, {len(gates)} gates")
        # What one capture depends on (the counterpart of a compile key).
        sig = (gates, tuple(depths.shape[2:]), kf.backend, kf.motion_model,
               kf.warm_start)
        pg = self._graphs.get(sig)
        if pg is None:
            pg = PeriodGraph(kf, state, tuple(depths.shape[2:]), gates)
            pg.depth.copy_(depths[0])
            if self._stream is None:
                self._stream = torch.cuda.Stream(kf.device)
            try:
                pg.capture(self._stream)
            except RuntimeError as exc:
                raise RuntimeError(f"CUDA graph capture of the frame step "
                                   f"failed (signature {sig}): {exc}") \
                    from exc
            self._graphs[sig] = pg
            self.captures.append({"signature": sig,
                                  "capture_s": pg.capture_s,
                                  "instantiate_s": pg.instantiate_s,
                                  "launches": dict(pg.captured)})
        else:
            pg.load(state)
        rows = torch.empty((K, L, 5), dtype=torch.float32, device=kf.device)
        for i in range(K):
            pg.depth.copy_(depths[i])
            pg.graph.replay()
            rows[i].copy_(pg.out)
            for k, n in pg.captured.items():
                self.launches[k] += n
        return pg.export(), rows.reshape(K * L, 5)
