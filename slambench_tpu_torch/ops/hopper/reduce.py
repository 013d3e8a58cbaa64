"""K2 wrappers: the ICP normal-equations reduction as hand-written CUDA
kernels, alone and fused with ``track``.

Both replace ``slambench_tpu/ops/pallas/reduce.py:reduce_track_pallas``;
the kernels are the two entry points of ``csrc/reduce.cu`` (one launch
each, deterministic):

* ``reduce_track_cuda(data)`` takes TrackData, the Pallas kernel's
  contract; its plain twin is ``plain`` (``ops/track.py:reduce_track``);
* ``track_reduce_cuda(...)`` runs ``ops/track.py:track`` inside the
  kernel and returns ``(out[32], result[h, w])`` without forming error
  or J in device memory; its plain twin is ``track_reduce_plain``. The
  ICP loop of ``pipeline.py`` calls it.

Both take ``threads``, the threads a block of the launch: 128, 256, 512
or 1024, each a template instantiation of the same kernel. It stands in
for JAX's ``SLAMBENCH_TILE_ROWS`` (``ops/pallas/reduce.py:35``, rows a
Pallas grid step, which has no CUDA meaning): the work-group size that
the reference's OCLWrapper tunes (``thirdparty/OCLWrapper.cpp:77-132``;
``tools/autotune.py reduce`` sweeps it). The default, 256, is
``SLAMBENCH_REDUCE_THREADS`` when that is set (another value raises).
The grid is ``ceil(n / threads)`` blocks, capped at ``MAX_BLOCKS``, so
the order of the sums depends on ``threads`` and the pixel count.

On CPU tensors each wrapper runs its twin (``threads`` is checked, and
has no other meaning there); on CUDA tensors it launches its kernel or
raises. ``track_reduce_cuda``'s ``span`` (a
``utils/timers.py`` span, or None) has its two CUDA events recorded by
the C entry point right around the launch; on the CPU it is entered
around the twin.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.ops.hopper import build
from slambench_tpu_torch.ops.track import TrackData, track
from slambench_tpu_torch.ops.track import reduce_track as plain
from slambench_tpu_torch.utils.timers import NULL_SPAN

THREAD_COUNTS = (128, 256, 512, 1024)


def _threads_from_env() -> int:
    raw = os.environ.get("SLAMBENCH_REDUCE_THREADS", "256")
    if raw not in tuple(str(t) for t in THREAD_COUNTS):
        raise ValueError(f"SLAMBENCH_REDUCE_THREADS={raw!r}: use one of "
                         f"{THREAD_COUNTS}")
    return int(raw)


THREADS = _threads_from_env()
# The grid gives one pixel per thread up to 4 blocks per SM of an H100
# (132 SMs); larger inputs loop. It depends only on the pixel count and
# the threads a block, so the kernels' summation order does too.
MAX_BLOCKS = 4 * 132

# Kernel launches since the last reset (chip_smoke.py reads these).
launches = 0          # reduce_track_cuda
fused_launches = 0    # track_reduce_cuda
# track_reduce_cuda calls recorded into a CUDA graph under capture: not
# launches; each replay of the graph launches them (graphs.py tallies).
fused_captured = 0

# Per (device, stream): the [MAX_BLOCKS, 32] block partials and the
# last-block ticket (left 0 by every launch). Allocated at first use.
_Scratch = Tuple[torch.Tensor, torch.Tensor]
_scratch: Dict[Tuple[torch.device, int], _Scratch] = {}


def grid_blocks(n: int, threads: int = THREADS) -> int:
    return max(1, min(MAX_BLOCKS, -(-n // threads)))


def _check_threads(threads: int) -> None:
    if threads not in THREAD_COUNTS:
        raise ValueError(f"threads must be one of {THREAD_COUNTS}, got "
                         f"{threads}")


def _scratch_for(device: torch.device, stream: int) -> _Scratch:
    key = (device, stream)
    if key not in _scratch:
        _scratch[key] = (
            torch.empty((MAX_BLOCKS, 32), dtype=torch.float32, device=device),
            torch.zeros((1,), dtype=torch.int32, device=device))
    return _scratch[key]


def _device_of(tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _check_contiguous(tensors, what: str) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} must be contiguous")


def reduce_track_cuda(data: TrackData, threads: int = THREADS
                      ) -> torch.Tensor:
    """Packed 32-float reduction of TrackData (ops.track contract)."""
    global launches
    _check_threads(threads)
    result, error, J = data["result"], data["error"], data["J"]
    if result.dtype != torch.int32 or error.dtype != torch.float32 \
            or J.dtype != torch.float32:
        raise ValueError(f"dtypes must be int32/float32/float32, got "
                         f"{result.dtype}/{error.dtype}/{J.dtype}")
    if error.shape != result.shape or J.shape != (6, *result.shape):
        raise ValueError(f"shapes must be [h,w], [h,w], [6,h,w]; got "
                         f"{tuple(result.shape)}, {tuple(error.shape)}, "
                         f"{tuple(J.shape)}")
    device = _device_of((result, error, J))
    if device.type == "cpu":
        return plain(data)
    _check_contiguous((result, error, J), "TrackData tensors")
    n = result.numel()
    stream = torch.cuda.current_stream(device).cuda_stream
    partials, ticket = _scratch_for(device, stream)
    out = torch.empty((32,), dtype=torch.float32, device=device)
    status = build.load().slb_reduce_track_f32(
        result.data_ptr(), error.data_ptr(), J.data_ptr(),
        partials.data_ptr(), ticket.data_ptr(), out.data_ptr(), n,
        grid_blocks(n, threads), MAX_BLOCKS, threads, stream)
    build.check(status, "reduce kernel")
    launches += 1
    return out


def track_reduce_plain(in_vertex, in_normal, ref_vertex, ref_normal, pose,
                       view, dist_threshold=params.DIST_THRESHOLD,
                       normal_threshold=params.NORMAL_THRESHOLD
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's plain twin: ``track``, then ``reduce_track``."""
    data = track(in_vertex, in_normal, ref_vertex, ref_normal, pose, view,
                 dist_threshold, normal_threshold)
    return plain(data), data["result"]


def track_reduce_cuda(in_vertex: torch.Tensor,
                      in_normal: torch.Tensor,
                      ref_vertex: torch.Tensor,
                      ref_normal: torch.Tensor,
                      pose: torch.Tensor,
                      view: torch.Tensor,
                      dist_threshold: float = params.DIST_THRESHOLD,
                      normal_threshold: float = params.NORMAL_THRESHOLD,
                      span=None, threads: int = THREADS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ICP iteration's data term, ``ops/track.py:track_and_reduce``
    without the TrackData: returns (packed 32 floats, result codes
    [h, w] int32). ``in_*`` are [3, h, w] level maps, ``ref_*`` [3, H, W]
    at full size, ``pose`` and ``view`` [4, 4]; all float32 on one
    device. Nothing is read back to the host."""
    global fused_launches, fused_captured
    _check_threads(threads)
    tensors = (in_vertex, in_normal, ref_vertex, ref_normal, pose, view)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("dtypes must all be float32, got "
                         f"{[str(t.dtype) for t in tensors]}")
    if in_vertex.dim() != 3 or in_vertex.shape[0] != 3 \
            or in_normal.shape != in_vertex.shape \
            or ref_vertex.dim() != 3 or ref_vertex.shape[0] != 3 \
            or ref_normal.shape != ref_vertex.shape \
            or pose.shape != (4, 4) or view.shape != (4, 4):
        raise ValueError(
            "shapes must be [3,h,w] x2, [3,H,W] x2, [4,4] x2; got "
            f"{[tuple(t.shape) for t in tensors]}")
    device = _device_of(tensors)
    span = NULL_SPAN if span is None else span
    if device.type == "cpu":
        with span:
            return track_reduce_plain(*tensors, dist_threshold,
                                      normal_threshold)
    _check_contiguous(tensors, "track_reduce inputs")
    _, h, w = in_vertex.shape
    _, H, W = ref_vertex.shape
    n = h * w
    stream = torch.cuda.current_stream(device).cuda_stream
    partials, ticket = _scratch_for(device, stream)
    out = torch.empty((32,), dtype=torch.float32, device=device)
    result = torch.empty((h, w), dtype=torch.int32, device=device)
    status = build.load().slb_track_reduce_f32(
        in_vertex.data_ptr(), in_normal.data_ptr(), ref_vertex.data_ptr(),
        ref_normal.data_ptr(), pose.data_ptr(), view.data_ptr(),
        result.data_ptr(), partials.data_ptr(), ticket.data_ptr(),
        out.data_ptr(), n, H, W, dist_threshold, normal_threshold,
        grid_blocks(n, threads), MAX_BLOCKS, threads, stream,
        *span.device_events())
    build.check(status, "track_reduce kernel")
    if torch.cuda.is_current_stream_capturing():
        fused_captured += 1
    else:
        fused_launches += 1
    return out, result
