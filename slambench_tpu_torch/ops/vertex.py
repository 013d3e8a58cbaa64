"""Depth back-projection to a vertex map and normal estimation
(port of ``slambench_tpu/ops/vertex.py``; reference:
cpp/kernels.cpp:200-249). Maps are component-first ``[3, H, W]`` f32."""

from __future__ import annotations

import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.geometry import cross3, normalize3


def depth2vertex(depth: torch.Tensor, inv_k: torch.Tensor) -> torch.Tensor:
    """``vertex = depth * rotate(invK, (x, y, 1))`` for positive depth,
    zero otherwise (no +0.5 pixel centre, as in the reference)."""
    H, W = depth.shape
    x = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    rx = inv_k[0, 0] * x + inv_k[0, 1] * y + inv_k[0, 2]
    ry = inv_k[1, 0] * x + inv_k[1, 1] * y + inv_k[1, 2]
    rz = inv_k[2, 2].expand(H, W)
    ray = torch.stack([rx.expand(H, W), ry.expand(H, W), rz])
    vert = depth[None] * ray
    return torch.where(depth[None] > 0, vert, torch.zeros_like(vert))


def vertex2normal(vertex: torch.Tensor) -> torch.Tensor:
    """Central-difference cross-product normals; any neighbour with
    ``z == 0`` marks the pixel invalid (x component = INVALID = -2)."""
    _, H, W = vertex.shape
    left = torch.cat([vertex[:, :, :1], vertex[:, :, :-1]], dim=2)
    right = torch.cat([vertex[:, :, 1:], vertex[:, :, -1:]], dim=2)
    up = torch.cat([vertex[:, :1, :], vertex[:, :-1, :]], dim=1)
    down = torch.cat([vertex[:, 1:, :], vertex[:, -1:, :]], dim=1)

    invalid = ((left[2] == 0) | (right[2] == 0)
               | (up[2] == 0) | (down[2] == 0))
    n = normalize3(cross3(down - up, right - left))
    marker = torch.zeros_like(n)
    marker[0] = params.INVALID
    return torch.where(invalid[None], marker, n)
