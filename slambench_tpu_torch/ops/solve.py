"""Pose update (6x6 Gauss-Newton solve + SE(3) retraction) and the pose
acceptance test (port of ``slambench_tpu/ops/solve.py``; reference:
cpp/kernels.cpp:759-792). Both stay on the device: no host read."""

from __future__ import annotations

from typing import Tuple

import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.geometry import (
    mat4mul, se3_exp, solve_normal_equations,
)


def update_pose(pose: torch.Tensor, reduction: torch.Tensor,
                icp_threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pose <- exp(solve(JTJ, JTe)) @ pose``; returns (new_pose,
    converged) with convergence ``|x| < icp_threshold``."""
    x = solve_normal_equations(reduction[1:28])
    new_pose = mat4mul(se3_exp(x), pose)
    converged = torch.linalg.vector_norm(x) < icp_threshold
    return new_pose, converged


def check_pose(pose: torch.Tensor, old_pose: torch.Tensor,
               reduction: torch.Tensor, image_size: Tuple[int, int],
               track_threshold: float = params.TRACK_THRESHOLD,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reject (revert to ``old_pose``) when the RMS residual exceeds 2e-2
    m or fewer than ``track_threshold`` of the pixels tracked. An all-zero
    reduction gives RMS 0/0 = NaN, which never rejects (NaN > x is
    false); the count test rejects instead, as in the reference."""
    h, w = image_size
    rms = torch.sqrt(reduction[0] / reduction[28])
    bad = (rms > params.RMS_RESIDUAL_BOUND) \
        | (reduction[28] / (h * w) < track_threshold)
    return torch.where(bad, old_pose, pose), ~bad
