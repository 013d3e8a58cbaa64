"""TSDF volume integration (port of ``slambench_tpu/ops/integrate.py``'s
monolithic ``integrate``; reference: cpp/kernels.cpp:628-673).

Plain torch over the whole ``[Z, Y, X]`` grid: every voxel's camera-space
position in closed form, one depth gather, the running-average update.
The frustum block cull of the JAX package (``integrate_blocks``) is not
ported; on the H100 this op becomes the hand kernel K3 in a later change.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.casts import f32_to_i32
from slambench_tpu_torch.volume import Dim3, pack_tsdf, voxel_centers_axis


def integrate(tsdf: torch.Tensor,
              weight: torch.Tensor,
              depth: torch.Tensor,
              inv_track: torch.Tensor,
              K: torch.Tensor,
              mu: float,
              max_weight: float = params.MAX_WEIGHT,
              dim: Dim3 = (2.0, 2.0, 2.0),
              gate: Optional[torch.Tensor] = None,
              z_offset: int = 0,
              z_total: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse one depth frame into the TSDF; returns new (tsdf, weight).

    Per voxel: skip if camera z < 1e-4, the projection falls outside the
    image, or depth == 0; else diff = (depth - z) * norm_correction and,
    if diff > -mu, value <- clamp((w*v + min(1, diff/mu)) / (w+1), -1, 1),
    w <- min(w + 1, maxweight).

    ``gate`` (a 0-d bool tensor) is the device-side counterpart of JAX's
    ``lax.cond`` around the update: it joins the voxel mask, so where it
    is false no voxel changes and the host reads nothing.

    ``z_offset`` / ``z_total`` fuse into a z-slab (the sharded step,
    ``parallel/step.py``): local plane ``z`` is centred at global plane
    ``z + z_offset`` of a ``z_total``-deep volume (JAX's ``integrate``
    arguments of the same names); with ``z_total`` 0 the volume is
    whole."""
    H, W = depth.shape
    sz, sy, sx = tsdf.shape
    dev = tsdf.device

    X = voxel_centers_axis(sx, dim[0], dev)[None, None, :]
    Y = voxel_centers_axis(sy, dim[1], dev)[None, :, None]
    if z_total:
        Z = (torch.arange(sz, dtype=torch.float32, device=dev) + z_offset
             + 0.5) * (dim[2] / z_total)
    else:
        Z = voxel_centers_axis(sz, dim[2], dev)
    Z = Z[:, None, None]

    M = inv_track
    px = M[0, 0] * X + M[0, 1] * Y + M[0, 2] * Z + M[0, 3]
    py = M[1, 0] * X + M[1, 1] * Y + M[1, 2] * Z + M[1, 3]
    pz = M[2, 0] * X + M[2, 1] * Y + M[2, 2] * Z + M[2, 3]

    cx = K[0, 0] * px + K[0, 1] * py + K[0, 2] * pz + K[0, 3]
    cy = K[1, 0] * px + K[1, 1] * py + K[1, 2] * pz + K[1, 3]
    cz = K[2, 0] * px + K[2, 1] * py + K[2, 2] * pz + K[2, 3]

    u = cx / cz + 0.5
    v = cy / cz + 0.5

    in_front = pz >= 1e-4
    in_img = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)

    ui = torch.clamp(f32_to_i32(u), 0, W - 1)
    vi = torch.clamp(f32_to_i32(v), 0, H - 1)
    d = depth.reshape(-1)[(vi * W + ui).long()]

    corr = torch.sqrt(1.0 + (px / pz) ** 2 + (py / pz) ** 2)
    diff = (d - cz) * corr

    update = in_front & in_img & (d != 0) & (diff > -mu)
    if gate is not None:
        update = update & gate

    sdf = torch.clamp(diff / mu, max=1.0)
    w = weight.to(torch.float32)
    val = tsdf.to(torch.float32) * params.TSDF_INV_SCALE
    new_val = torch.clamp((w * val + sdf) / (w + 1.0), -1.0, 1.0)
    new_w = torch.clamp(w + 1.0, max=max_weight)

    tsdf_out = torch.where(update, pack_tsdf(new_val), tsdf)
    weight_out = torch.where(update, new_w.to(weight.dtype), weight)
    return tsdf_out, weight_out
