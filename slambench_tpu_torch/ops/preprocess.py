"""Depth preprocessing: mm->m downsample, the plain bilateral filter and
robust half-sampling (port of ``slambench_tpu/ops/preprocess.py``).

``bilateral_filter`` here is the plain-torch twin of the hand-written
CUDA kernel K1 (``ops/hopper/bilateral.py``); the frame step calls the
wrapper, which launches the kernel on CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.geometry import constant


def make_gaussian(delta: float = params.DELTA,
                  radius: int = params.RADIUS) -> np.ndarray:
    """Spatial gaussian LUT of the bilateral filter
    (reference: cpp/kernels.cpp:100-108)."""
    i = np.arange(2 * radius + 1, dtype=np.float32)
    x = i - radius
    return np.exp(-(x * x) / (2.0 * delta * delta)).astype(np.float32)


def mm_to_meters(mm: torch.Tensor) -> torch.Tensor:
    """float32 metres from integer millimetres by IEEE division, the JAX
    package's ``astype(f32) / 1000``. PyTorch's CUDA kernel turns a
    division by a host scalar into a product with its reciprocal, which
    is one ulp off for about half of all millimetre values, so the
    divisor here is a tensor on the same device."""
    return mm.to(torch.float32) / constant((1000.0,), torch.float32,
                                           mm.device)


def mm2meters(depth_mm: torch.Tensor, ratio: int) -> torch.Tensor:
    """uint16 millimetre depth (any integer dtype) -> float32 metres by
    strided subsampling (reference: cpp/kernels.cpp:562-589)."""
    return mm_to_meters(depth_mm[::ratio, ::ratio])


def _uintwrap_index(size: int, d: int, device) -> torch.Tensor:
    """Source index of ``i + d`` under the reference's unsigned clamp: a
    read past either edge takes the last row/column
    (reference: cpp/kernels.cpp:181-182)."""
    i = torch.arange(size, device=device) + d
    return torch.where((i < 0) | (i > size - 1),
                       torch.full_like(i, size - 1), i)


def _shift_uintwrap(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[y, x] = img[wrap(y+dy), wrap(x+dx)]`` (see _uintwrap_index)."""
    H, W = img.shape
    return img[_uintwrap_index(H, dy, img.device)][
        :, _uintwrap_index(W, dx, img.device)]


def bilateral_filter(depth: torch.Tensor,
                     gaussian,
                     e_d: float = params.E_DELTA,
                     r: int = params.RADIUS) -> torch.Tensor:
    """5x5 gaussian-space x gaussian-range bilateral filter of depth
    (reference: cpp/kernels.cpp:159-198): zero-depth pixels stay zero,
    neighbours with depth <= 0 are left out of both sums."""
    g = np.asarray(gaussian, dtype=np.float32)
    e_d_squared_2 = e_d * e_d * 2.0
    t = torch.zeros_like(depth)
    s = torch.zeros_like(depth)
    center = depth
    zero = torch.zeros_like(depth)
    for j in range(-r, r + 1):       # y offset
        for i in range(-r, r + 1):   # x offset
            cur = _shift_uintwrap(depth, j, i)
            mod = (cur - center) ** 2
            gg = float(g[i + r] * g[j + r])     # the f32 product
            factor = gg * torch.exp(-mod / e_d_squared_2)
            valid = cur > 0
            t = t + torch.where(valid, factor * cur, zero)
            s = s + torch.where(valid, factor, zero)
    out = t / s
    return torch.where(center == 0.0, zero, out)


def half_sample_robust(depth: torch.Tensor, e_d: float,
                       r: int = 1) -> torch.Tensor:
    """Edge-preserving 2x downsample for the ICP pyramid
    (reference: cpp/kernels.cpp:591-626): average of the ``[-r+1, r]^2``
    window around ``2*(x, y)`` within ``e_d`` of the centre, indices
    clamped to ``2*outSize - 1``."""
    H, W = depth.shape
    oh, ow = H // 2, W // 2
    center = depth[0:2 * oh:2, 0:2 * ow:2]
    t = torch.zeros((oh, ow), dtype=depth.dtype, device=depth.device)
    s = torch.zeros_like(t)
    zero = torch.zeros_like(t)
    one = torch.ones_like(t)
    for i in range(-r + 1, r + 1):      # y offset
        for j in range(-r + 1, r + 1):  # x offset
            ys = torch.clamp(2 * torch.arange(oh, device=depth.device) + i,
                             0, 2 * oh - 1)
            xs = torch.clamp(2 * torch.arange(ow, device=depth.device) + j,
                             0, 2 * ow - 1)
            cur = depth[ys][:, xs]
            ok = torch.abs(cur - center) < e_d
            t = t + torch.where(ok, cur, zero)
            s = s + torch.where(ok, one, zero)
    return t / s
