"""Camera rays and the ray/volume-box clip (port of the parts of
``slambench_tpu/ops/raycast.py`` the fast raycast uses; reference:
cpp/kernels.cpp:674-700). The oracle march (``masked_march``,
``raycast_maps``: the ``jnp`` backend) is not ported yet."""

from __future__ import annotations

from typing import Tuple

import torch

from slambench_tpu_torch.geometry import constant, get_translation
from slambench_tpu_torch.volume import Dim3


def camera_rays(view: torch.Tensor, image_size: Tuple[int, int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(origin [3], unnormalized direction [3, H, W]):
    ``direction = rotate(view, (x, y, 1))``."""
    H, W = image_size
    origin = get_translation(view)
    x = torch.arange(W, dtype=torch.float32, device=view.device)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=view.device)[:, None]
    direction = torch.stack([
        (view[0, 0] * x + view[0, 1] * y + view[0, 2]).expand(H, W),
        (view[1, 0] * x + view[1, 1] * y + view[1, 2]).expand(H, W),
        (view[2, 0] * x + view[2, 1] * y + view[2, 2]).expand(H, W),
    ])
    return origin, direction


def ray_box_clip(origin: torch.Tensor, direction: torch.Tensor, dim: Dim3,
                 near_plane: float, far_plane: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray (tnear, tfar) against the volume box [0, dim], with the
    reference's fmaxf(fmaxf(x,y), fmaxf(x,z)) association."""
    o = origin.reshape(3, 1, 1)
    dim_a = constant(tuple(dim), torch.float32,
                     direction.device).reshape(3, 1, 1)
    inv_r = 1.0 / direction
    tbot = -inv_r * o
    ttop = inv_r * (dim_a - o)
    tmin = torch.minimum(ttop, tbot)
    tmax = torch.maximum(ttop, tbot)
    largest_tmin = torch.maximum(torch.maximum(tmin[0], tmin[1]),
                                 torch.maximum(tmin[0], tmin[2]))
    smallest_tmax = torch.minimum(torch.minimum(tmax[0], tmax[1]),
                                  torch.minimum(tmax[0], tmax[2]))
    tnear = torch.clamp(largest_tmin, min=near_plane)
    tfar = torch.clamp(smallest_tmax, max=far_plane)
    return tnear, tfar
