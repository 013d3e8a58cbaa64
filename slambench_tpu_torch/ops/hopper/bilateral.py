"""K1 wrapper: the bilateral filter as a hand-written CUDA kernel.

Replaces ``slambench_tpu/ops/pallas/bilateral.py:bilateral_filter_pallas``;
the kernel is ``csrc/bilateral.cu``. On a CPU tensor the wrapper runs the
plain-torch twin ``bilateral_filter`` (ops/preprocess.py, re-exported
here as ``plain``); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.ops.hopper import build
from slambench_tpu_torch.ops.preprocess import bilateral_filter as plain

# Kernel launches since the last reset (chip_smoke.py reads this).
launches = 0


def bilateral_filter_cuda(depth: torch.Tensor, gaussian,
                          e_d: float = params.E_DELTA,
                          r: int = params.RADIUS) -> torch.Tensor:
    """Bilateral-filtered depth; ``gaussian`` is the 5-tap host LUT."""
    global launches
    lut = np.ascontiguousarray(np.asarray(gaussian, dtype=np.float32))
    if depth.dim() != 2 or depth.dtype != torch.float32:
        raise ValueError(f"depth must be a 2-D float32 tensor, got "
                         f"{tuple(depth.shape)} {depth.dtype}")
    if r != 2 or lut.shape != (5,):
        raise ValueError(f"the kernel takes radius 2 and a 5-tap LUT, got "
                         f"r={r}, LUT {lut.shape}")
    if depth.device.type == "cpu":
        return plain(depth, lut, e_d, r)
    if depth.device.type != "cuda":
        raise ValueError(f"unsupported device {depth.device}")
    if not depth.is_contiguous():
        raise ValueError("depth must be contiguous")
    H, W = depth.shape
    out = torch.empty_like(depth)
    e2 = float(np.float32(e_d * e_d * 2.0))
    lib = build.load()
    status = lib.slb_bilateral_f32(
        depth.data_ptr(), out.data_ptr(), H, W,
        lut.ctypes.data_as(ctypes.c_void_p), e2,
        torch.cuda.current_stream(depth.device).cuda_stream)
    build.check(status, "bilateral kernel")
    launches += 1
    return out
