"""Camera rays, the ray/volume-box clip and the oracle raycast (port of
``slambench_tpu/ops/raycast.py``; reference: cpp/kernels.cpp:674-757).

The oracle march is the reference's per-ray loop run in lockstep over
the whole image: every live ray advances with its own two-speed step on
the trilinear field, rays retire as they hit or leave the clip range,
and a finished ray is frozen by ``torch.where``. It is the ``jnp``
backend's raycast and the render route without a min-mip; the fast
tiers march the min-mip instead (``raycast_fast.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.geometry import (
    constant, get_translation, length3, normalize3,
)
from slambench_tpu_torch.volume import Dim3, grad, interp

# Iterations between the host's reads of "any ray live". The loop stops
# at the first read that finds none (masked iterations after the last
# ray retires change nothing), or at ``max_iters``.
MARCH_CHECK_EVERY = 4


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


def masked_march(sample, tnear: torch.Tensor, tfar: torch.Tensor,
                 step: float, large_step: float, max_iters: int,
                 early_exit: bool = True) -> torch.Tensor:
    """Lockstep two-speed march to the TSDF zero crossing; returns
    ``t_hit`` (0 where no hit).

    ``sample(t)`` gives the TSDF along each ray at ``t``. The reference's
    per-ray semantics (cpp/kernels.cpp:702-721): start at ``tnear`` with
    ``large_step``; a ray whose first sample is <= 0 started inside and
    gives no hit; on ``f_tt < 0`` refine to ``t + stepsize * f_tt /
    (f_t - f_tt)`` with the step size from before the update. At most
    ``max_iters`` iterations, as in the JAX ``while_loop``.
    ``early_exit=False`` runs all ``max_iters`` iterations with no host
    read (the CUDA graph route): every write is gated by ``live``, so a
    done ray does not change and the result is the same bits.
    """
    f_t = sample(tnear)
    done = ~((tnear < tfar) & (f_t > 0))
    t = tnear
    stepsize = torch.full_like(tnear, large_step)
    t_hit = torch.zeros_like(tnear)
    iters = 0
    while iters < max_iters and (not early_exit or bool((~done).any())):
        n = min(MARCH_CHECK_EVERY, max_iters - iters)
        for _ in range(n):
            f_tt = sample(t)
            live = ~done
            is_hit = live & (f_tt < 0.0)
            t_hit = torch.where(is_hit, t + stepsize * f_tt / (f_t - f_tt),
                                t_hit)
            cont = live & ~is_hit
            new_step = torch.where(f_tt < 0.8, step, stepsize)
            stepsize = torch.where(cont, new_step, stepsize)
            f_t = torch.where(cont, f_tt, f_t)
            t = torch.where(cont, t + new_step, t)
            done = done | is_hit | (cont & (t >= tfar))
        iters += n
    return t_hit


def raycast(tsdf: torch.Tensor, dim: Dim3, view: torch.Tensor,
            image_size: Tuple[int, int], near_plane: float, far_plane: float,
            step: float, large_step: float, early_exit: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """March every ray of the virtual camera ``view`` (``pose @ K^-1``)
    through the TSDF: hit positions [3, H, W] (0 where no hit) and hit
    distances [H, W] (> 0 marks a hit). ``early_exit`` as in
    ``masked_march``."""
    origin, direction = camera_rays(view, image_size)
    o = origin.reshape(3, 1, 1)
    tnear, tfar = ray_box_clip(origin, direction, dim, near_plane, far_plane)

    def sample(t):
        return interp(tsdf, dim, o + direction * t[None])

    # Worst case: the whole clip range at the fine step.
    max_iters = int((far_plane - near_plane) / step) + 2
    t_hit = masked_march(sample, tnear, tfar, step, large_step, max_iters,
                         early_exit)
    hit_pos = o + direction * t_hit[None]
    hit_pos = torch.where(t_hit[None] > 0, hit_pos, torch.zeros_like(hit_pos))
    return hit_pos, t_hit


def raycast_maps(tsdf: torch.Tensor, dim: Dim3, view: torch.Tensor,
                 image_size: Tuple[int, int],
                 near_plane: float = params.NEAR_PLANE,
                 far_plane: float = params.FAR_PLANE,
                 step: float = 0.0078125, large_step: float = 0.075,
                 early_exit: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``raycastKernel`` (cpp/kernels.cpp:726-757):
    vertex and normal maps; on a hit the normal is the normalised TSDF
    gradient (INVALID where it vanishes), on a miss vertex 0 and normal
    (INVALID, 0, 0). ``early_exit`` as in ``masked_march``."""
    hit_pos, t_hit = raycast(tsdf, dim, view, image_size, near_plane,
                             far_plane, step, large_step, early_exit)
    g = grad(tsdf, dim, hit_pos)
    hit = t_hit > 0
    invalid = torch.zeros_like(g)
    invalid[0] = params.INVALID
    normal = torch.where((hit & (length3(g) != 0))[None], normalize3(g),
                         invalid)
    vertex = torch.where(hit[None], hit_pos, torch.zeros_like(hit_pos))
    return vertex, normal
