"""Seeded depth frames of the synthetic living room (a copy of
``slambench_tpu_torch/io/synthetic.py``'s scene, orbit and sphere
tracer, made batched and seeded for the benchmark).

The scene and the orbit are the deployment's: the same room, the same
amplitude and period, the camera starting at the deployment's initial
pose. The seed varies the frames within the deployment and nothing
else: the orbit's direction (+1 or -1 on its phase) and a Kinect-like
axial depth noise (Nguyen, Izadi and Lovell 2012: sigma(z) = 0.0012 +
0.0019 (z - 0.4)^2 m), drawn by a ``torch.Generator`` on the frames'
device. Every seed gives the same number of frames of the same size.

``render_frames`` sphere-traces many frames in one batched march, so
set-up makes a lap of 640x480 frames in a few large calls.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

EASE_IN = 10            # frames of the orbit's quadratic ease-in


def scene_sdf(p: torch.Tensor, dim: Sequence[float]) -> torch.Tensor:
    """Signed distance (positive in free space) at ``p [3, ...]`` of the
    room inside ``[0, dim]^3``: inset walls, two spheres, two boxes and
    a pillar."""
    dx, dy, dz = dim
    x, y, z = p[0], p[1], p[2]
    w = 0.25 * dx / 4.8
    d = torch.minimum(
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
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return ry @ rx


def orbit(n_frames: int, init_pos: Sequence[float], amp: float,
          period: int, direction: int = 1, yaw_amp: float = 0.12,
          pitch_amp: float = 0.05) -> np.ndarray:
    """Camera-to-world poses ``[n, 4, 4]`` of the looping orbit, from
    ``init_pos`` with identity rotation and a quadratic ease-in over
    ``EASE_IN`` frames; ``direction`` (+1 or -1) runs it either way.
    Past the ease-in, frame ``i + period`` has frame ``i``'s pose."""
    poses = np.zeros((n_frames, 4, 4), np.float32)
    p0 = np.asarray(init_pos, np.float32)
    for i in range(n_frames):
        s = i * i / (2.0 * EASE_IN) if i < EASE_IN else i - EASE_IN * 0.5
        ph = direction * 2.0 * np.pi * s / period
        t = p0 + np.array([amp * np.sin(ph),
                           0.5 * amp * (1 - np.cos(ph)),
                           0.6 * amp * np.sin(2 * ph)], np.float32)
        poses[i, :3, :3] = _rot_yx(yaw_amp * np.sin(ph),
                                   pitch_amp * (1 - np.cos(ph)))
        poses[i, :3, 3] = t
        poses[i, 3, 3] = 1.0
    return poses


def lap_frames(period: int) -> int:
    """Frames generated for a deployment: the ease-in and one lap."""
    return EASE_IN + period


def frame_index(frame: int, period: int) -> int:
    """The generated frame that stream frame ``frame`` shows: the stream
    cycles through the lap once the ease-in is over."""
    if frame < EASE_IN + period:
        return frame
    return EASE_IN + (frame - EASE_IN) % period


def render_frames(poses: np.ndarray, camera: Sequence[float],
                  image_size: Tuple[int, int], dim: Sequence[float],
                  generator: torch.Generator, device: torch.device,
                  noise: bool = True, batch: int = 10,
                  max_range: float = 6.0, n_steps: int = 96
                  ) -> torch.Tensor:
    """Planar-z depth in millimetres, int32 ``[n, H, W]`` on ``device``:
    each pose's frame sphere-traced (``batch`` frames a march), then the
    axial noise drawn from ``generator`` (on ``device``), rounded to
    whole millimetres and clamped to uint16's range."""
    W, H = image_size
    fx, fy, cx, cy = camera
    u = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    dir_cam = torch.stack([((u - cx) / fx).expand(H, W),
                           ((v - cy) / fy).expand(H, W),
                           torch.ones((H, W), dtype=torch.float32,
                                      device=device)])
    norm = torch.sqrt((dir_cam ** 2).sum(0))
    unit = (dir_cam / norm).reshape(3, 1, H * W)
    out = torch.empty((len(poses), H, W), dtype=torch.int32, device=device)
    for b0 in range(0, len(poses), batch):
        pb = torch.as_tensor(poses[b0:b0 + batch], device=device)
        rot, org = pb[:, :3, :3], pb[:, :3, 3]
        du = torch.einsum("bij,jkn->ibn", rot, unit)       # [3, b, HW]
        o = org.T[:, :, None]                                # [3, b, 1]
        t = torch.full(du.shape[1:], 1e-3, dtype=torch.float32,
                       device=device)
        for _ in range(n_steps):
            d = scene_sdf(o + du * t[None], dim)
            t = t + torch.clamp(d, min=1e-4) * (t < max_range)
        z = torch.where(t < max_range, t / norm.reshape(1, -1),
                        torch.zeros_like(t))
        if noise:
            sigma = 0.0012 + 0.0019 * (z - 0.4) ** 2
            eps = torch.randn(z.shape, generator=generator, device=device)
            z = torch.where(z > 0, z + sigma * eps, z)
        mm = torch.clamp(torch.round(z * 1000.0), 0, 65535)
        out[b0:b0 + len(pb)] = mm.to(torch.int32).reshape(-1, H, W)
    return out


def make_stream(setting: dict, seed: int, device: torch.device,
                noise: bool = True) -> dict:
    """The deployment's frames for ``seed``: ``{"depth": int32 [n, H, W]
    on device, "poses": c2w [n, 4, 4] numpy, "direction": +1/-1}`` with
    ``n`` = the ease-in and one lap. ``setting`` is a configuration
    file's dict (``input_size``, ``camera``, ``volume_size``,
    ``init_pose``, ``orbit``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    direction = 1 if int(torch.randint(2, (1,), generator=gen,
                                       device=device)) else -1
    dim = setting["volume_size"]
    init = [f * d for f, d in zip(setting["init_pose"], dim)]
    orb = setting["orbit"]
    n = lap_frames(orb["period"])
    poses = orbit(n, init, orb["amp"], orb["period"], direction)
    depth = render_frames(poses, setting["camera"], setting["input_size"],
                          dim, gen, device, noise=noise)
    return {"depth": depth, "poses": poses, "direction": direction}


def stream_depths(stream: dict, first: int, count: int,
                  period: int) -> torch.Tensor:
    """Stream frames ``first .. first + count - 1`` as one stacked
    tensor of the stream's device."""
    idx = [frame_index(f, period) for f in range(first, first + count)]
    return stream["depth"][torch.as_tensor(idx, device=stream["depth"]
                                           .device)]


def ground_truth(stream: dict, frames: Sequence[int], period: int
                 ) -> np.ndarray:
    """Camera positions ``[len(frames), 3]`` of stream frames."""
    return np.stack([stream["poses"][frame_index(f, period)][:3, 3]
                     for f in frames])


def same_frame_ate(pos: np.ndarray, gt: np.ndarray) -> dict:
    """Mean and max distance (m) between the tracked and the true camera
    positions of the same frames (``bench.py``'s ATE)."""
    err = np.linalg.norm(np.asarray(pos, np.float64)
                         - np.asarray(gt, np.float64), axis=1)
    if not len(err):
        return {"ate_mean_m": math.nan, "ate_max_m": math.nan}
    return {"ate_mean_m": float(err.mean()), "ate_max_m": float(err.max())}
