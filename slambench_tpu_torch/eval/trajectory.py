"""Trajectory import/export in TUM-RGBD and ICL-NUIM formats.

A copy of ``slambench_tpu/eval/trajectory.py`` (the port imports nothing
of the JAX package).

The reference consumes ICL-NUIM 'freiburg' ground-truth files
(reference: thirdparty/checkPos.py:18-20); this module adds symmetric
writers/readers so long runs (and the pose-graph-corrected trajectories)
can be evaluated with standard external tooling (TUM evaluate_ate) as
well as the in-repo checkPos-equivalent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q
    return np.array([x, y, z, w])


def write_tum(path: str, poses: np.ndarray,
              timestamps: Optional[np.ndarray] = None,
              fps: float = 30.0) -> None:
    """TUM format: ``timestamp tx ty tz qx qy qz qw`` per line."""
    n = len(poses)
    if timestamps is None:
        timestamps = np.arange(n) / fps
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses):
            t = T[:3, 3]
            q = _rot_to_quat(T[:3, :3])
            f.write("%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f\n"
                    % (ts, t[0], t[1], t[2], q[0], q[1], q[2], q[3]))


def read_tum(path: str) -> np.ndarray:
    """Positions [N, 3] from a TUM trajectory file."""
    out = []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) >= 4:
            out.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(out)


def ate_rmse(est: np.ndarray, gt: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error RMSE after optional SE(3) alignment
    (Horn's method) — the TUM evaluate_ate metric for long runs."""
    n = min(len(est), len(gt))
    est, gt = est[:n].astype(np.float64), gt[:n].astype(np.float64)
    if align and n >= 3:
        mu_e = est.mean(0)
        mu_g = gt.mean(0)
        E = est - mu_e
        Gm = gt - mu_g
        U, _, Vt = np.linalg.svd(E.T @ Gm)
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R = Vt.T @ S @ U.T
        est = (R @ E.T).T + mu_g
        gt = Gm + mu_g
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))
