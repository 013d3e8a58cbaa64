"""K1 and K1F wrappers: the bilateral filter as hand-written CUDA
kernels, alone and fused with ``mm2meters``.

Both replace ``slambench_tpu/ops/pallas/bilateral.py:
bilateral_filter_pallas``; the kernels are the two entry points of
``csrc/bilateral.cu``, one tiled device body:

* ``bilateral_filter_cuda(depth, gaussian)`` takes metre depth, the
  Pallas kernel's contract; its plain twin is ``plain``
  (``ops/preprocess.py:bilateral_filter``);
* ``mm2m_bilateral_cuda(depth_mm, ratio, gaussian)`` takes the int32
  millimetre frame and returns ``(float_depth, scaled_depth0)``; its
  plain twin is ``mm2m_bilateral_plain`` (``mm2meters`` then
  ``bilateral_filter``). ``KFusion.preprocessing`` calls it once a frame.

On CPU tensors each wrapper runs its twin; on CUDA tensors it launches
its kernel or raises. ``mm2m_bilateral_cuda``'s ``span`` (a
``utils/timers.py`` span, or None) has its two CUDA events recorded by
the C entry point right around the launch; on the CPU it is entered
around the twin.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.ops.hopper import build
from slambench_tpu_torch.ops.preprocess import bilateral_filter as plain
from slambench_tpu_torch.ops.preprocess import mm2meters
from slambench_tpu_torch.utils.timers import NULL_SPAN

# Kernel launches since the last reset (chip_smoke.py reads these).
launches = 0          # bilateral_filter_cuda
fused_launches = 0    # mm2m_bilateral_cuda
# Calls recorded into a CUDA graph under capture: not launches; each
# replay of the graph launches them (graphs.py tallies).
captured = 0          # bilateral_filter_cuda
fused_captured = 0    # mm2m_bilateral_cuda


def _lut(gaussian, r: int) -> np.ndarray:
    lut = np.ascontiguousarray(np.asarray(gaussian, dtype=np.float32))
    if r != 2 or lut.shape != (5,):
        raise ValueError(f"the kernel takes radius 2 and a 5-tap LUT, got "
                         f"r={r}, LUT {lut.shape}")
    return lut


def _e2(e_d: float) -> float:
    return float(np.float32(e_d * e_d * 2.0))


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError("the frame must be contiguous")


def bilateral_filter_cuda(depth: torch.Tensor, gaussian,
                          e_d: float = params.E_DELTA,
                          r: int = params.RADIUS) -> torch.Tensor:
    """Bilateral-filtered depth; ``gaussian`` is the 5-tap host LUT."""
    global launches, captured
    lut = _lut(gaussian, r)
    if depth.dim() != 2 or depth.dtype != torch.float32:
        raise ValueError(f"depth must be a 2-D float32 tensor, got "
                         f"{tuple(depth.shape)} {depth.dtype}")
    _check_device(depth)
    if depth.device.type == "cpu":
        return plain(depth, lut, e_d, r)
    H, W = depth.shape
    out = torch.empty_like(depth)
    status = build.load().slb_bilateral_f32(
        depth.data_ptr(), out.data_ptr(), H, W,
        lut.ctypes.data_as(ctypes.c_void_p), _e2(e_d),
        torch.cuda.current_stream(depth.device).cuda_stream)
    build.check(status, "bilateral kernel")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out


def mm2m_bilateral_plain(depth_mm: torch.Tensor, ratio: int, gaussian,
                         e_d: float = params.E_DELTA,
                         r: int = params.RADIUS
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's plain twin: ``mm2meters``, then the filter."""
    fd = mm2meters(depth_mm, ratio).contiguous()
    return fd, plain(fd, gaussian, e_d, r)


def mm2m_bilateral_cuda(depth_mm: torch.Tensor, ratio: int, gaussian,
                        e_d: float = params.E_DELTA,
                        r: int = params.RADIUS,
                        span=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(float_depth, scaled_depth0) of an int32 millimetre frame read at
    stride ``ratio``: metres by IEEE division, and their bilateral
    filter, each ``ceil(in / ratio)`` per axis."""
    global fused_launches, fused_captured
    lut = _lut(gaussian, r)
    if depth_mm.dim() != 2 or depth_mm.dtype != torch.int32:
        raise ValueError(f"depth_mm must be a 2-D int32 tensor, got "
                         f"{tuple(depth_mm.shape)} {depth_mm.dtype}")
    if not isinstance(ratio, (int, np.integer)) or ratio < 1:
        raise ValueError(f"ratio must be an integer >= 1, got {ratio!r}")
    if depth_mm.numel() == 0:
        raise ValueError("the frame is empty")
    _check_device(depth_mm)
    span = NULL_SPAN if span is None else span
    if depth_mm.device.type == "cpu":
        with span:
            return mm2m_bilateral_plain(depth_mm, ratio, lut, e_d, r)
    Hin, Win = depth_mm.shape
    shape = (-(-Hin // ratio), -(-Win // ratio))
    fd = torch.empty(shape, dtype=torch.float32, device=depth_mm.device)
    sd = torch.empty_like(fd)
    status = build.load().slb_mm2m_bilateral_f32(
        depth_mm.data_ptr(), fd.data_ptr(), sd.data_ptr(), Hin, Win,
        int(ratio), lut.ctypes.data_as(ctypes.c_void_p), _e2(e_d),
        torch.cuda.current_stream(depth_mm.device).cuda_stream,
        *span.device_events())
    build.check(status, "mm2meters + bilateral kernel")
    if torch.cuda.is_current_stream_capturing():
        fused_captured += 1
    else:
        fused_launches += 1
    return fd, sd
