"""Synthetic living-room dataset with an exact ground-truth trajectory
(port of ``slambench_tpu/io/synthetic.py``).

The same analytic SDF scene, the same numpy trajectory (copied exactly,
so ground-truth poses are identical to the JAX package's) and the same
sphere tracing, run on a given ``torch.device``. Output: a RAW container
of planar-z millimetre depth plus a freiburg ground-truth file.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from slambench_tpu_torch.io.raw import RawWriter

SCENE_VERSION = 2


@dataclasses.dataclass
class SyntheticScene:
    """An analytic SDF scene inside the volume [0, dim]^3: inset walls, two
    spheres, two boxes and a pillar (see the JAX package for the why)."""
    dim: Tuple[float, float, float] = (4.8, 4.8, 4.8)
    wall_inset: float = 0.25

    def sdf(self, p: torch.Tensor) -> torch.Tensor:
        """Signed distance (positive in free space) at ``p`` [3, ...]."""
        dx, dy, dz = self.dim
        x, y, z = p[0], p[1], p[2]

        w = self.wall_inset * dx / 4.8
        room = torch.minimum(
            torch.minimum(torch.minimum(x - w, dx - w - x),
                          torch.minimum(y - w, dy - w - y)),
            torch.minimum(z - w, dz - w - z))

        def sphere(c, r):
            return torch.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2
                              + (z - c[2]) ** 2) - r

        def box(c, h):
            qx = torch.abs(x - c[0]) - h[0]
            qy = torch.abs(y - c[1]) - h[1]
            qz = torch.abs(z - c[2]) - h[2]
            outside = torch.sqrt(torch.clamp(qx, min=0.0) ** 2
                                 + torch.clamp(qy, min=0.0) ** 2
                                 + torch.clamp(qz, min=0.0) ** 2)
            inside = torch.clamp(torch.maximum(qx, torch.maximum(qy, qz)),
                                 max=0.0)
            return outside + inside

        s = dx / 4.8
        d = room
        d = torch.minimum(d, sphere((2.6 * s, 2.2 * s, 3.4 * s), 0.5 * s))
        d = torch.minimum(d, box((1.4 * s, 3.4 * s, 3.2 * s),
                                 (0.45 * s, 0.5 * s, 0.45 * s)))
        d = torch.minimum(d, box((3.4 * s, 1.2 * s, 2.6 * s),
                                 (0.5 * s, 0.35 * s, 0.4 * s)))
        d = torch.minimum(d, box((1.0 * s, 1.1 * s, 3.8 * s),
                                 (0.3 * s, 1.1 * s, 0.3 * s)))
        d = torch.minimum(d, sphere((3.8 * s, 3.8 * s, 3.9 * s), 0.35 * s))
        return d


def _rot_yx(yaw: float, pitch: float) -> np.ndarray:
    """Camera-to-world rotation: yaw about +y then pitch about +x."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return Ry @ Rx


def orbit_trajectory(n_frames: int,
                     init_pos: Sequence[float],
                     amp: float = 0.25,
                     yaw_amp: float = 0.12,
                     pitch_amp: float = 0.05,
                     period: int = 60) -> np.ndarray:
    """Smooth looping c2w trajectory [N, 4, 4], starting at ``init_pos``
    with identity rotation and a quadratic ease-in over 10 frames; the
    angular rate is set by ``period``, not by ``n_frames``."""
    poses = np.zeros((n_frames, 4, 4), np.float32)
    p0 = np.asarray(init_pos, np.float32)
    ramp = 10
    for i in range(n_frames):
        s = i * i / (2.0 * ramp) if i < ramp else i - ramp * 0.5
        ph = 2.0 * np.pi * s / max(period, 1)
        t = p0 + np.array([
            amp * np.sin(ph),
            0.5 * amp * (1 - np.cos(ph)),
            0.6 * amp * np.sin(2 * ph),
        ], np.float32)
        R = _rot_yx(yaw_amp * np.sin(ph), pitch_amp * (1 - np.cos(ph)))
        poses[i, :3, :3] = R
        poses[i, :3, 3] = t
        poses[i, 3, 3] = 1.0
    return poses


def render_depth_frame(scene: SyntheticScene,
                       pose: np.ndarray,
                       k: Sequence[float],
                       image_size: Tuple[int, int],
                       device: torch.device,
                       max_range: float = 6.0,
                       n_steps: int = 96) -> np.ndarray:
    """Sphere-trace one planar-z depth image on ``device``; returns uint16
    millimetres [H, W] on the host."""
    W, H = image_size
    fx, fy, cx, cy = k
    u = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    dir_cam = torch.stack([
        ((u - cx) / fx).expand(H, W),
        ((v - cy) / fy).expand(H, W),
        torch.ones((H, W), dtype=torch.float32, device=device),
    ])
    pose_t = torch.as_tensor(np.asarray(pose, np.float32), device=device)
    R = pose_t[:3, :3]
    o = pose_t[:3, 3].reshape(3, 1, 1)
    dw = torch.stack([
        R[0, 0] * dir_cam[0] + R[0, 1] * dir_cam[1] + R[0, 2] * dir_cam[2],
        R[1, 0] * dir_cam[0] + R[1, 1] * dir_cam[1] + R[1, 2] * dir_cam[2],
        R[2, 0] * dir_cam[0] + R[2, 1] * dir_cam[1] + R[2, 2] * dir_cam[2],
    ])
    norm = torch.sqrt(dir_cam[0] ** 2 + dir_cam[1] ** 2 + dir_cam[2] ** 2)
    du = dw / norm[None]

    t = torch.full((H, W), 1e-3, dtype=torch.float32, device=device)
    for _ in range(n_steps):
        d = scene.sdf(o + du * t[None])
        t = t + torch.clamp(d, min=1e-4) * (t < max_range)
    hit = t < max_range
    depth_mm = torch.where(hit, (t / norm) * 1000.0, torch.zeros_like(t))
    return torch.clamp(depth_mm, 0, 65535).to(torch.int32).cpu().numpy() \
        .astype(np.uint16)


def write_gt_freiburg(path: str, poses: np.ndarray) -> None:
    """Ground truth in the checkPos convention: x/z deltas from the
    start, y negated (reference: thirdparty/checkPos.py:104)."""
    p0 = poses[0, :3, 3]
    with open(path, "w") as f:
        for i, pose in enumerate(poses):
            d = pose[:3, 3] - p0
            f.write("%d %.9f %.9f %.9f 0 0 0 1\n" % (i + 1, d[0], -d[1], d[2]))


def generate_dataset(out_dir: str,
                     device: torch.device,
                     n_frames: int = 60,
                     image_size: Tuple[int, int] = (640, 480),
                     k: Optional[Sequence[float]] = None,
                     dim: Tuple[float, float, float] = (4.8, 4.8, 4.8),
                     init_pos_factor: Sequence[float] = (0.34, 0.5, 0.24),
                     amp: float = 0.25,
                     period: int = 60,
                     name: str = "synth") -> dict:
    """Render a RAW container + ground-truth file; returns a manifest with
    the paths and the exact poses."""
    os.makedirs(out_dir, exist_ok=True)
    W, H = image_size
    if k is None:
        kscale = W / 640.0
        k = (481.2 * kscale, 480.0 * kscale, (W / 2), (H / 2))
    scene = SyntheticScene(dim=dim)
    init_pos = [f * d for f, d in zip(init_pos_factor, dim)]
    poses = orbit_trajectory(n_frames, init_pos, amp=amp, period=period)

    raw_path = os.path.join(out_dir, f"{name}.raw")
    gt_path = os.path.join(out_dir, f"{name}.gt.freiburg")
    with RawWriter(raw_path, W, H) as wr:
        for i in range(n_frames):
            wr.write(render_depth_frame(scene, poses[i], k, image_size,
                                        device))
    write_gt_freiburg(gt_path, poses)
    with open(os.path.join(out_dir, f"{name}.scene_version"), "w") as f:
        f.write(str(SCENE_VERSION))
    return {"raw": raw_path, "gt": gt_path, "poses": poses,
            "camera": tuple(k), "image_size": image_size, "dim": dim,
            "init_pos_factor": tuple(init_pos_factor)}
