"""Projective data association (ICP correspondence) and the plain
normal-equations reduction (port of ``slambench_tpu/ops/track.py``;
reference: kfusion/src/cpp/kernels.cpp:251-560).

``reduce_track`` is the plain-torch twin of the hand-written CUDA kernel
K2 (``ops/hopper/reduce.py``), with the same packed 32-float output
``[err^2, JTe(6), triu(JTJ)(21), count, n_-4, n_-5, n_other]``; ``track``
then ``reduce_track`` is the twin of the fused kernel K2F
(``reduce.track_reduce_cuda``), which the frame step calls.

Track result codes (reference: cpp/kernels.cpp:514-553):
  1 tracked / -1 no input / -2 projects outside image /
  -3 no reference normal / -4 too far / -5 wrong normal.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.casts import f32_to_i32
from slambench_tpu_torch.geometry import (
    cross3, dot3, length3, rotate, transform,
)

TrackData = Dict[str, torch.Tensor]  # result [h,w] i32, error [h,w] f32, J [6,h,w] f32


def track(in_vertex: torch.Tensor,
          in_normal: torch.Tensor,
          ref_vertex: torch.Tensor,
          ref_normal: torch.Tensor,
          t_track: torch.Tensor,
          view: torch.Tensor,
          dist_threshold: float = params.DIST_THRESHOLD,
          normal_threshold: float = params.NORMAL_THRESHOLD) -> TrackData:
    """Per-pixel ICP correspondence against the raycast reference maps.

    ``in_*`` are [3, h, w] pyramid-level maps; ``ref_*`` are [3, H, W] at
    full computation size, even on the coarse levels.
    """
    _, H, W = ref_vertex.shape

    proj_vertex = transform(t_track, in_vertex)
    proj_pos = transform(view, proj_vertex)
    # z == 0 gives inf/nan, classed as out of bounds (-2).
    px = proj_pos[0] / proj_pos[2] + 0.5
    py = proj_pos[1] / proj_pos[2] + 0.5

    in_bounds = ((px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
                 & torch.isfinite(px) & torch.isfinite(py))

    # Cast with XLA's semantics (NaN -> 0, saturate), then clamp, so a
    # -2 pixel gathers where the JAX package's does.
    u = torch.clamp(f32_to_i32(px), 0, W - 1)
    v = torch.clamp(f32_to_i32(py), 0, H - 1)
    flat = (v * W + u).long()

    refs = torch.cat([ref_normal.reshape(3, -1),
                      ref_vertex.reshape(3, -1)], dim=0)
    ref_nv = refs[:, flat]                                  # [6, h, w]
    ref_n, ref_v = ref_nv[:3], ref_nv[3:]

    no_input = in_normal[0] == params.INVALID
    ref_invalid = ref_n[0] == params.INVALID

    diff = ref_v - proj_vertex
    proj_normal = rotate(t_track, in_normal)

    too_far = length3(diff) > dist_threshold
    wrong_normal = dot3(proj_normal, ref_n) < normal_threshold

    # Priority chain mirrors the reference's early-continue order.
    result = torch.ones(px.shape, dtype=torch.int32, device=px.device)
    result = torch.where(wrong_normal, -5, result)
    result = torch.where(too_far, -4, result)
    result = torch.where(ref_invalid, -3, result)
    result = torch.where(~in_bounds, -2, result)
    result = torch.where(no_input, -1, result).to(torch.int32)

    error = dot3(ref_n, diff)
    J = torch.cat([ref_n, cross3(proj_vertex, ref_n)], dim=0)  # [6,h,w]
    return {"result": result, "error": error.to(torch.float32),
            "J": J.to(torch.float32)}


def reduce_track(data: TrackData) -> torch.Tensor:
    """Plain reduction of TrackData into the packed 32-float vector
    (reference: cpp/kernels.cpp:251-495): one masked Gram product."""
    result = data["result"].reshape(-1)
    error = data["error"].reshape(-1)
    J = data["J"].reshape(6, -1)

    vf = (result >= 1).to(torch.float32)
    A = torch.cat([(error * vf)[None, :], J * vf[None, :]], dim=0)  # [7, N]
    G = torch.matmul(A, A.T)                                       # [7, 7]

    iu = torch.triu_indices(6, 6, device=G.device)
    triu = G[1:7, 1:7][iu[0], iu[1]]
    n_valid = vf.sum()
    n_far = (result == -4).to(torch.float32).sum()
    n_wrong = (result == -5).to(torch.float32).sum()
    n_other = ((result < 1) & (result > -4)).to(torch.float32).sum()
    info = torch.stack([n_valid, n_far, n_wrong, n_other])
    return torch.cat([G[0, 0:1], G[0, 1:7], triu, info]).to(torch.float32)


def track_and_reduce(in_vertex: torch.Tensor,
                     in_normal: torch.Tensor,
                     ref_vertex: torch.Tensor,
                     ref_normal: torch.Tensor,
                     t_track: torch.Tensor,
                     view: torch.Tensor,
                     dist_threshold: float = params.DIST_THRESHOLD,
                     normal_threshold: float = params.NORMAL_THRESHOLD,
                     ) -> Tuple[torch.Tensor, TrackData]:
    """One ICP iteration's data term: ``track``, then the K2 reduction
    (the CUDA kernel on CUDA tensors, its plain twin on the CPU)."""
    from slambench_tpu_torch.ops.hopper.reduce import reduce_track_cuda
    data = track(in_vertex, in_normal, ref_vertex, ref_normal,
                 t_track, view, dist_threshold, normal_threshold)
    return reduce_track_cuda(data), data
