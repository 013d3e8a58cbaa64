"""Pose-graph optimization on SE(3) (port of
``slambench_tpu/models/posegraph.py``).

* Edges carry relative-pose measurements ``T_ij`` (ICP odometry or loop
  closures); the residual of edge (i, j) is ``r = log(T_ij^-1 T_i^-1
  T_j)`` in se(3).
* One Gauss-Newton iteration evaluates every edge's residual and its
  central-difference Jacobians (12 perturbation directions) as one
  batch: ``edge_residual`` is mapped over ``E * 25`` pose triples with
  ``torch.func.vmap``, so no Python loop runs over edges. The 12x12
  blocks are scattered into a dense ``[N, N, 6, 6]`` normal matrix with
  ``index_add_`` and the damped system is solved with
  ``torch.linalg.solve`` in float32, on the poses' device.
* Gauge freedom is fixed by a strong prior on pose 0.

With ``group`` (a ``parallel/mesh.py`` ``Mesh``; JAX's ``axis_name``)
each rank holds a share of the edges and one all-reduce
of ``(H, b)`` and the residual an iteration completes the system, which
every rank then solves alike.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from slambench_tpu_torch.geometry import (
    mat4mul, rigid_inverse, se3_exp, se3_log,
)
from slambench_tpu_torch.policy import resolve_device

_F32 = torch.float32


def edge_residual(Ti: torch.Tensor, Tj: torch.Tensor,
                  Tij: torch.Tensor) -> torch.Tensor:
    """r = log(T_ij^-1 T_i^-1 T_j): zero when the measurement holds."""
    Z = mat4mul(rigid_inverse(Tij), mat4mul(rigid_inverse(Ti), Tj))
    return se3_log(Z)


_residuals = torch.func.vmap(edge_residual)
_exps = torch.func.vmap(se3_exp)


def _edge_jacobians(Ti, Tj, Tij, eps: float = 1e-4):
    """Central-difference Jacobians of the residual wrt right-perturbed
    ``T_i``, ``T_j`` for a batch of E edges: ``r(T_i exp(x_i), T_j
    exp(x_j))``. Returns (Ji [E, 6, 6], Jj [E, 6, 6], r [E, 6])."""
    E = Ti.shape[0]
    basis = torch.eye(6, dtype=_F32, device=Ti.device) * eps
    steps = _exps(torch.cat([basis, -basis]))          # [12, 4, 4]
    Ti_pert = torch.matmul(Ti[:, None], steps[None])   # [E, 12, 4, 4]
    Tj_pert = torch.matmul(Tj[:, None], steps[None])
    a = torch.cat([Ti[:, None], Ti_pert, Ti[:, None].expand(E, 12, 4, 4)],
                  dim=1)                               # [E, 25, 4, 4]
    b = torch.cat([Tj[:, None], Tj[:, None].expand(E, 12, 4, 4), Tj_pert],
                  dim=1)
    m = Tij[:, None].expand(E, 25, 4, 4)
    r = _residuals(a.reshape(-1, 4, 4), b.reshape(-1, 4, 4),
                   m.reshape(-1, 4, 4)).reshape(E, 25, 6)
    # Column k of J is (r(+e_k) - r(-e_k)) / 2eps; rows of r_i are k.
    Ji = ((r[:, 1:7] - r[:, 7:13]) / (2 * eps)).transpose(1, 2)
    Jj = ((r[:, 13:19] - r[:, 19:25]) / (2 * eps)).transpose(1, 2)
    return Ji, Jj, r[:, 0]


def optimize_pose_graph(poses: torch.Tensor,
                        edges_ij: torch.Tensor,
                        edges_T: torch.Tensor,
                        edges_w: torch.Tensor,
                        n_iters: int = 10,
                        damping: float = 1e-6,
                        prior_weight: float = 1e6,
                        group=None,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton pose-graph optimization.

    Args:
      poses: [N, 4, 4] initial absolute poses.
      edges_ij: [E, 2] int (i, j) indices.
      edges_T: [E, 4, 4] measured relative poses T_ij.
      edges_w: [E] per-edge weights (0 masks an edge out, so padded
        edge buffers are inert).
      group: all-reduce (H, b) over this mesh's ranks (``Mesh.psum``;
        edge-sharded mode: each rank passes its own edges and the same
        poses).

    Returns (optimized poses [N, 4, 4], the total weighted squared
    residual of the last iteration, before its update). Nothing is read
    back to the host.
    """
    N = poses.shape[0]
    dev = poses.device
    idx_i = edges_ij[:, 0].to(torch.int64)
    idx_j = edges_ij[:, 1].to(torch.int64)
    w = edges_w.to(_F32)[:, None, None]
    eye6 = torch.eye(6, dtype=_F32, device=dev)
    eye6n = torch.eye(6 * N, dtype=_F32, device=dev)
    total_r2 = torch.zeros((), dtype=_F32, device=dev)
    for _ in range(n_iters):
        Ji, Jj, r = _edge_jacobians(poses[idx_i], poses[idx_j], edges_T)
        JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
        Hii = w * torch.matmul(JiT, Ji)
        Hjj = w * torch.matmul(JjT, Jj)
        Hij = w * torch.matmul(JiT, Jj)
        bi = w[:, :, 0] * torch.matmul(JiT, r[:, :, None])[:, :, 0]
        bj = w[:, :, 0] * torch.matmul(JjT, r[:, :, None])[:, :, 0]
        r2 = w[:, 0, 0] * (r * r).sum(dim=1)

        # Assemble the 6N x 6N system block by block.
        H = torch.zeros((N * N, 6, 6), dtype=_F32, device=dev)
        H.index_add_(0, idx_i * N + idx_i, Hii)
        H.index_add_(0, idx_j * N + idx_j, Hjj)
        H.index_add_(0, idx_i * N + idx_j, Hij)
        H.index_add_(0, idx_j * N + idx_i, Hij.transpose(1, 2))
        b = torch.zeros((N, 6), dtype=_F32, device=dev)
        b.index_add_(0, idx_i, bi)
        b.index_add_(0, idx_j, bj)
        total_r2 = r2.sum()
        if group is not None:
            H, b, total_r2 = (group.psum(x, "pose_graph_psum")
                              for x in (H, b, total_r2))

        # Gauge prior on pose 0.
        H[0] += prior_weight * eye6
        Hd = H.reshape(N, N, 6, 6).permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
        Hd = Hd + damping * eye6n
        delta = torch.linalg.solve(Hd, -b.reshape(-1)).reshape(N, 6)
        poses = torch.matmul(poses, _exps(delta))
    return poses, total_r2


class PoseGraph:
    """Host-side pose graph: grows keyframe poses and edges as
    numpy arrays and optimizes them on ``device``. The edge buffer is
    padded to the next power of two (unused slots weigh zero), as in the
    JAX package, where it bounds recompilation. ``device`` defaults to
    the card, as JAX's optimizes on its default device; without a card
    it raises (``policy.resolve_device``)."""

    def __init__(self, device="cuda"):
        self.poses: list = []
        self.edges: list = []       # (i, j, T_ij 4x4, weight)
        self.device = resolve_device(str(device))

    def add_pose(self, pose: np.ndarray) -> int:
        self.poses.append(np.asarray(pose, np.float32))
        return len(self.poses) - 1

    def add_edge(self, i: int, j: int, T_ij: np.ndarray,
                 weight: float = 1.0) -> None:
        self.edges.append((i, j, np.asarray(T_ij, np.float32),
                           float(weight)))

    def add_odometry_edge(self, i: int, j: int, weight: float = 1.0):
        """Measurement = current relative pose between stored poses."""
        T_ij = np.linalg.inv(self.poses[i]) @ self.poses[j]
        self.add_edge(i, j, T_ij, weight)

    def optimize(self, n_iters: int = 10) -> np.ndarray:
        n = len(self.poses)
        e = len(self.edges)
        if n == 0:
            return np.zeros((0, 4, 4), np.float32)
        cap = 1
        while cap < max(e, 1):
            cap *= 2
        ij = np.zeros((cap, 2), np.int64)
        T = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
        w = np.zeros((cap,), np.float32)
        for k, (i, j, Tij, wt) in enumerate(self.edges):
            ij[k] = (i, j)
            T[k] = Tij
            w[k] = wt
        dev = self.device
        out, _ = optimize_pose_graph(
            torch.from_numpy(np.stack(self.poses)).to(dev),
            torch.from_numpy(ij).to(dev), torch.from_numpy(T).to(dev),
            torch.from_numpy(w).to(dev), n_iters=n_iters)
        result = out.cpu().numpy()
        self.poses = [result[k] for k in range(n)]
        return result
