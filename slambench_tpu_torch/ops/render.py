"""Diagnostic render kernels: depth colormap, ICP-result colours, shaded
volume raycast, normal visualisation (port of
``slambench_tpu/ops/render.py``; reference: cpp/kernels.cpp:794-913 and
the ``gs2rgb`` colormap, commons.h:86-147).

Outputs are uint8 RGBA images [H, W, 4] with a zero alpha byte. Every
float -> uint8 pack goes through ``casts.f32_to_u8``, XLA's cast: a unit
normal component of +1 gives 128 + 128 = 256.0, which saturates to 255
(a plain ``.to(torch.uint8)`` wraps it to 0).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.casts import f32_to_i32, f32_to_u8
from slambench_tpu_torch.geometry import constant, dot3, length3, normalize3
from slambench_tpu_torch.ops.raycast import raycast
from slambench_tpu_torch.volume import Dim3, grad


def _select(sx: torch.Tensor, values, default: torch.Tensor) -> torch.Tensor:
    """``jnp.select([sx == 0, ..., sx == 5], values, default)``."""
    out = default
    for i in reversed(range(len(values))):
        out = torch.where(sx == i, values[i], out)
    return out


def _gs2rgb(h: torch.Tensor) -> torch.Tensor:
    """Rainbow colormap, h in [0, 1] -> float r, g, b stacked [3, ...]
    (reference: commons.h:86-147)."""
    v = 0.75
    m = 0.25
    sv = 0.6667
    h6 = h * 6.0
    sextant = torch.floor(h6)
    fract = h6 - sextant
    vsf = v * sv * fract
    mid1 = m + vsf
    mid2 = v - vsf
    sx = f32_to_i32(sextant)
    vv = torch.full_like(h, v)
    mm = torch.full_like(h, m)
    zz = torch.zeros_like(h)
    r = _select(sx, [vv, mid2, mm, mm, mid1, vv], zz)
    g = _select(sx, [mid1, vv, vv, mid2, mm, mm], zz)
    b = _select(sx, [mm, mm, mid1, vv, vv, mid2], zz)
    return torch.stack([r, g, b])


def _pack_rgba(r: torch.Tensor, g: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Float [0, 255] channels -> uint8 RGBA (alpha 0), cast as XLA does."""
    return f32_to_u8(torch.stack([r, g, b, torch.zeros_like(r)], dim=-1))


def render_depth(depth: torch.Tensor,
                 near_plane: float = params.NEAR_PLANE,
                 far_plane: float = params.FAR_PLANE) -> torch.Tensor:
    """Depth -> rainbow RGBA; white below the near plane, black beyond
    the far plane (reference: cpp/kernels.cpp:814-842)."""
    range_scale = 1.0 / (far_plane - near_plane)
    d = (depth - near_plane) * range_scale
    rgb = _gs2rgb(d) * 255.0
    is_near = depth < near_plane
    is_far = depth > far_plane
    white = torch.full_like(depth, 255.0)
    black = torch.zeros_like(depth)
    r, g, b = (torch.where(is_near, white, torch.where(is_far, black, c))
               for c in rgb)
    return _pack_rgba(r, g, b)


# ICP diagnostic palette (reference: cpp/kernels.cpp:853-874), indexed by
# 0 default, 1 tracked, 2..6 the codes -1..-5.
_TRACK_COLORS = np.array([
    [255, 128, 128, 0],   # default
    [128, 128, 128, 0],   # 1: tracked, grey
    [0, 0, 0, 0],         # -1: no input, black
    [255, 0, 0, 0],       # -2: not in image, red
    [0, 255, 0, 0],       # -3: no correspondence, green
    [0, 0, 255, 0],       # -4: too far, blue
    [255, 255, 0, 0],     # -5: wrong normal, yellow
], dtype=np.uint8)


def render_track(result: torch.Tensor) -> torch.Tensor:
    """ICP result-code image (reference: cpp/kernels.cpp:844-878)."""
    idx = torch.zeros_like(result, dtype=torch.int64)
    for i, code in enumerate((1, -1, -2, -3, -4, -5)):
        idx = torch.where(result == code, i + 1, idx)
    palette = constant(tuple(map(tuple, _TRACK_COLORS.tolist())),
                       torch.uint8, result.device)
    return palette[idx]


def render_volume(tsdf: torch.Tensor, dim: Dim3, view: torch.Tensor,
                  image_size: Tuple[int, int],
                  near_plane: float = params.NEAR_PLANE,
                  far_plane: float = params.FAR_PLANE,
                  step: float = 0.0078125, large_step: float = 0.075,
                  light: Tuple[float, float, float] = params.LIGHT,
                  ambient: Tuple[float, float, float] = params.AMBIENT,
                  mip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raycast from ``view`` with diffuse shading (reference:
    cpp/kernels.cpp:880-913). With ``mip`` (the state's min-mip) the
    march is the fast tiers' min-mip raycast; without it, the oracle
    march."""
    if mip is not None:
        from slambench_tpu_torch.ops.raycast_fast import raycast_fast
        hit_pos, t_hit = raycast_fast(tsdf, mip, dim, view, image_size,
                                      near_plane, far_plane, step,
                                      large_step)
    else:
        hit_pos, t_hit = raycast(tsdf, dim, view, image_size, near_plane,
                                 far_plane, step, large_step)
    return shade(hit_pos, t_hit, grad(tsdf, dim, hit_pos), light, ambient)


def shade(hit_pos: torch.Tensor, t_hit: torch.Tensor, g: torch.Tensor,
          light: Tuple[float, float, float] = params.LIGHT,
          ambient: Tuple[float, float, float] = params.AMBIENT
          ) -> torch.Tensor:
    """Diffuse shading of raycast hits (positions, distances, 0 for a
    miss, and the TSDF gradient there) as RGBA (reference:
    cpp/kernels.cpp:895-910)."""
    dev = hit_pos.device
    light_a = constant(tuple(light), torch.float32, dev).reshape(3, 1, 1)
    ambient_a = constant(tuple(ambient), torch.float32, dev).reshape(3, 1, 1)
    diff_dir = normalize3(light_a - hit_pos)
    dir_term = torch.clamp(dot3(normalize3(g), diff_dir), min=0.0)
    col = torch.clamp(dir_term[None] + ambient_a, 0.0, 1.0) * 255.0
    lit = (t_hit > 0) & (length3(g) > 0)
    col = torch.where(lit[None], col, torch.zeros_like(col))
    return _pack_rgba(col[0], col[1], col[2])


def render_normal(normal: torch.Tensor) -> torch.Tensor:
    """Normals -> RGB (reference: cpp/kernels.cpp:794-812; uchar3 there,
    padded to RGBA here)."""
    n = normalize3(normal)
    invalid = normal[0] == params.INVALID
    zero = torch.zeros_like(invalid, dtype=normal.dtype)
    r, g, b = (torch.where(invalid, zero, c * 128.0 + 128.0) for c in n)
    return _pack_rgba(r, g, b)
