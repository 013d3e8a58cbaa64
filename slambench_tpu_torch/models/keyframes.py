"""Keyframe selection and the pose-graph-corrected KinectFusion wrapper
(port of ``slambench_tpu/models/keyframes.py``).

The KinectFusion frame step is untouched (frame-to-model odometry); this
wrapper:

* promotes frames to **keyframes** on translation/rotation thresholds,
  keeping the pose on the host and a downsampled vertex/normal snapshot
  on the pipeline's device (made contiguous once, at promotion);
* links consecutive keyframes with odometry edges;
* finds **loop-closure candidates** by pose proximity among
  non-consecutive keyframes and verifies each by aligning the two
  snapshots with a fixed number of point-to-plane ICP iterations: K2F
  (``ops/hopper/reduce.py:track_reduce_cuda``; its plain twin on the
  CPU) and the port's ``update_pose``, with no host read until the
  iterations are done;
* periodically optimizes the pose graph (or runs bundle adjustment over
  snapshot landmarks) and reports the corrected trajectory. The TSDF is
  not re-deformed: the correction is applied at export.

Host reads: one a frame (the pose, as in JAX) and one per verified
candidate (the reduction's residual and count with the relative pose).

With KERNEL_TIMINGS set, the pipeline's spans (``utils/timers.py``) also
time each candidate's alignment (``loopClosureAlign``, size the snapshot
pixels), each pose-graph optimization (``poseGraph``, size the edges)
and each bundle adjustment after its pose graph (``bundleAdjust``, size
the keyframes); unset, they cost nothing.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.geometry import (
    get_camera_matrix, mat4mul, rigid_inverse, se3_log,
)
from slambench_tpu_torch.models.ba import bundle_adjust
from slambench_tpu_torch.models.posegraph import PoseGraph
from slambench_tpu_torch.ops.hopper.reduce import track_reduce_cuda
from slambench_tpu_torch.ops.solve import update_pose
from slambench_tpu_torch.pipeline import KFusion, KFusionState
from slambench_tpu_torch.utils.timers import NULL_SPAN

Snapshot = Union[torch.Tensor, np.ndarray]


@dataclasses.dataclass
class Keyframe:
    index: int                 # pose-graph node id
    frame: int                 # source frame number
    pose: np.ndarray           # [4, 4] odometry pose at creation
    vertex: Snapshot           # [3, h, w] downsampled vertex map
    normal: Snapshot           # [3, h, w] downsampled normal map

    def on_host(self) -> "Keyframe":
        """This keyframe with numpy snapshots (``build_ba_problem``)."""
        return dataclasses.replace(self, vertex=np.asarray(
            self.vertex.cpu()), normal=np.asarray(self.normal.cpu()))


class KeyframeStore:
    """Keyframe promotion policy + storage."""

    def __init__(self, trans_threshold: float = 0.15,
                 rot_threshold: float = 0.15,
                 downsample: int = 2):
        self.trans_threshold = trans_threshold
        self.rot_threshold = rot_threshold
        self.downsample = downsample
        self.keyframes: List[Keyframe] = []

    def should_promote(self, pose: np.ndarray) -> bool:
        if not self.keyframes:
            return True
        last = self.keyframes[-1].pose
        rel = np.linalg.inv(last) @ pose
        x = se3_log(torch.as_tensor(rel, dtype=torch.float32)).numpy()
        return bool(np.linalg.norm(x[:3]) > self.trans_threshold
                    or np.linalg.norm(x[3:]) > self.rot_threshold)

    def promote(self, frame: int, pose: np.ndarray, vertex: torch.Tensor,
                normal: torch.Tensor) -> Keyframe:
        """Store a keyframe; the snapshots are strided copies of the
        [3, H, W] maps, contiguous, on the maps' device."""
        s = self.downsample

        def snapshot(x: torch.Tensor) -> torch.Tensor:
            return x[:, ::s, ::s].to(torch.float32).clone(
                memory_format=torch.contiguous_format)

        kf = Keyframe(index=len(self.keyframes), frame=frame,
                      pose=np.asarray(pose, np.float32),
                      vertex=snapshot(vertex), normal=snapshot(normal))
        self.keyframes.append(kf)
        return kf

    def loop_candidates(self, kf: Keyframe, min_gap: int = 5,
                        radius: float = 0.5) -> List[Keyframe]:
        out = []
        p = kf.pose[:3, 3]
        for other in self.keyframes[: max(0, kf.index - min_gap)]:
            if np.linalg.norm(other.pose[:3, 3] - p) < radius:
                out.append(other)
        return out


def build_ba_problem(keyframes: List[Keyframe],
                     poses_cur: Optional[List[np.ndarray]] = None,
                     cell: float = 0.075,
                     stride: int = 2,
                     min_views: int = 2,
                     max_obs: int = 16384):
    """Construct a bundle-adjustment problem from keyframe snapshots
    (numpy snapshots: ``Keyframe.on_host``).

    Measurements are the keyframes' back-projected surface points in
    their own CAMERA frames (fixed data: stored snapshot vertices
    un-projected through the creation pose). Landmarks are found by
    VOXEL HASHING those points in the CURRENT pose estimates' world
    frame (``poses_cur``, e.g. the pose-graph solution BA refines):
    points are quantized to ``cell``-sized world cells and every cell
    seen by >= ``min_views`` keyframes becomes one landmark,
    initialized at the mean of its re-projected points. The models/ba.py
    residual model is ``r = T_i^-1 X_l - z`` (depth-camera BA).
    Returns (poses0 [N,4,4], landmarks0 [M,3], obs_cam, obs_lm, obs_z,
    obs_w) as numpy arrays, or None when fewer than 2 keyframes or no
    multi-view landmark exists. Observations beyond ``max_obs`` are
    dropped (deterministically, in keyframe order); the rest are padded
    to the next power of two with zero weight.
    """
    if len(keyframes) < 2:
        return None
    if poses_cur is None:
        poses_cur = [kf.pose for kf in keyframes]
    cells: dict = {}
    for kf in keyframes:
        v = kf.vertex[:, ::stride, ::stride].reshape(3, -1)   # world
        n0 = kf.normal[0, ::stride, ::stride].reshape(-1)
        valid = (n0 != params.INVALID) & (np.abs(v).sum(axis=0) > 0)
        pts = v[:, valid].T                                    # [P, 3]
        if not len(pts):
            continue
        # Fixed camera-frame measurements via the CREATION pose...
        Rinv = kf.pose[:3, :3].T
        t = kf.pose[:3, 3]
        zc = (Rinv @ (pts - t).T).T                            # camera
        # ...hashed/initialized in the CURRENT estimate's world frame.
        P = np.asarray(poses_cur[kf.index], np.float32)
        xw = (P[:3, :3] @ zc.T).T + P[:3, 3]
        keys = np.floor(xw / cell).astype(np.int64)
        for key, pw, pc in zip(map(tuple, keys), xw, zc):
            cells.setdefault(key, {}).setdefault(kf.index, []).append(
                (pw, pc))
    obs_cam, obs_lm, obs_z, lms = [], [], [], []
    for key, views in cells.items():
        if len(views) < min_views:
            continue
        lm_id = len(lms)
        world_mean = np.mean([pw for vs in views.values()
                              for (pw, _pc) in vs], axis=0)
        lms.append(world_mean)
        for kf_idx, vs in views.items():
            obs_cam.append(kf_idx)
            obs_lm.append(lm_id)
            obs_z.append(np.mean([pc for (_pw, pc) in vs], axis=0))
    if not lms:
        return None
    obs_cam = np.asarray(obs_cam, np.int32)[:max_obs]
    obs_lm = np.asarray(obs_lm, np.int32)[:max_obs]
    obs_z = np.asarray(obs_z, np.float32)[:max_obs]
    k = len(obs_cam)
    cap = 1
    while cap < k:
        cap *= 2
    pad = cap - k
    obs_cam = np.concatenate([obs_cam, np.zeros(pad, np.int32)])
    obs_lm = np.concatenate([obs_lm, np.zeros(pad, np.int32)])
    obs_z = np.concatenate([obs_z, np.zeros((pad, 3), np.float32)])
    obs_w = np.concatenate([np.ones(k, np.float32),
                            np.zeros(pad, np.float32)])
    poses0 = np.stack([kf.pose for kf in keyframes]).astype(np.float32)
    return (poses0, np.stack(lms).astype(np.float32),
            obs_cam, obs_lm, obs_z, obs_w)


def _cap(x: int, lo: int = 8) -> int:
    """The power-of-two tier (at least ``lo``) that holds ``x``."""
    c = lo
    while c < x:
        c *= 2
    return c


class PoseGraphKFusion:
    """KFusion + keyframing + pose-graph / bundle-adjustment backend.

    ``backend="posegraph"`` optimizes the keyframe pose graph (odometry
    + loop-closure edges); ``backend="ba"`` instead runs the sparse
    Schur-complement bundle adjuster (models/ba.py) on snapshot-derived
    landmarks, seeded from the pose graph, and keeps the pose-graph
    solution while the BA problem is degenerate (no multi-view landmark
    yet). Everything runs on the pipeline's device."""

    def __init__(self, kfusion: KFusion,
                 keyframe_store: Optional[KeyframeStore] = None,
                 optimize_every: int = 5,
                 icp_iters: int = 5,
                 backend: str = "posegraph"):
        if backend not in ("posegraph", "ba"):
            raise ValueError(f"unknown keyframe backend {backend!r}")
        self.kf = kfusion
        self.device = kfusion.device
        self.store = keyframe_store or KeyframeStore()
        self.graph = PoseGraph(device=self.device)
        self.optimize_every = optimize_every
        self.icp_iters = icp_iters
        self.backend = backend
        self.alignments = 0        # loop candidates verified by ICP
        self._trajectory: List[np.ndarray] = []
        self._kf_of_frame: List[int] = []

        # Snapshots are stored downsampled, so projective association on
        # the snapshot grid uses the correspondingly scaled intrinsics
        # (the pyramid-level convention of pipeline.py's tracking).
        camera = torch.tensor(self.kf.camera, dtype=torch.float32,
                              device=self.device)
        self._K = get_camera_matrix(camera / float(self.store.downsample))

    def _span(self, name: str, size: int):
        """A span of the pipeline's KERNEL_TIMINGS (a no-op when it is
        off, or for a stand-in pipeline without timings)."""
        timings = getattr(self.kf, "timings", None)
        return NULL_SPAN if timings is None else timings.span(name, size)

    def align(self, src_v, src_n, dst_v, dst_n, init_rel, view):
        """``icp_iters`` point-to-plane ICP iterations aligning snapshot
        src onto dst's map; returns (relative pose, the last iteration's
        32-float reduction), both on the device. ``view`` must be ``K @
        inv(dst.pose)``: the snapshots are WORLD-frame raycast maps on
        dst's pixel grid, so a world point is associated through dst's
        camera. No early exit and no host read."""
        rel = init_rel
        red = torch.zeros((32,), dtype=torch.float32, device=rel.device)
        for _ in range(self.icp_iters):
            red, _ = track_reduce_cuda(src_v, src_n, dst_v, dst_n, rel, view)
            rel, _ = update_pose(rel, red, 1e-6)
        return rel, red

    def process_frame(self, state: KFusionState, depth, frame: int,
                      tracking_rate: int = 1, integration_rate: int = 2
                      ) -> KFusionState:
        state = self.kf.process_frame(state, depth, frame,
                                      tracking_rate, integration_rate)
        pose = state.pose.cpu().numpy()          # the frame's host read
        self._trajectory.append(pose)

        if self.store.should_promote(pose) and frame > 3:
            kf = self.store.promote(frame, pose, state.ref_vertex,
                                    state.ref_normal)
            node = self.graph.add_pose(pose)
            assert node == kf.index
            if kf.index > 0:
                self.graph.add_odometry_edge(kf.index - 1, kf.index,
                                             weight=1.0)
            eye = torch.eye(4, dtype=torch.float32, device=self.device)
            npix = kf.vertex.shape[1] * kf.vertex.shape[2]
            for cand in self.store.loop_candidates(kf):
                # The stored maps are world-frame raycast maps, so the
                # ICP measures the (small) relative world correction
                # aligning kf's snapshot onto cand's, from identity.
                with self._span("loopClosureAlign", npix):
                    cand_pose = torch.as_tensor(cand.pose,
                                                device=self.device)
                    rel, red = self.align(
                        kf.vertex, kf.normal, cand.vertex, cand.normal,
                        eye, mat4mul(self._K, rigid_inverse(cand_pose)))
                    host = torch.cat([red[0:1], red[28:29],
                                      rel.reshape(-1)]).cpu().numpy()
                self.alignments += 1
                count = float(host[1])
                # Acceptance needs BOTH gates the tracker uses
                # (ops/solve.check_pose): enough inliers AND a small
                # point-plane RMS. The inlier count alone passes
                # wrong-but-overlapping alignments (two parallel walls
                # agree on normals while sliding); the RMS exposes them.
                rms = float(np.sqrt(host[0] / np.float32(count))) \
                    if count > 0 else float("inf")
                if (count / npix > 0.3
                        and rms < params.RMS_RESIDUAL_BOUND):
                    # rel corrects kf's world points onto cand's map:
                    # measured T_cand_kf = inv(P_cand) @ rel @ P_kf.
                    T_ij = (np.linalg.inv(cand.pose)
                            @ host[2:].reshape(4, 4) @ kf.pose)
                    self.graph.add_edge(cand.index, kf.index, T_ij,
                                        weight=min(count / npix, 1.0))
            if (len(self.store.keyframes) % self.optimize_every == 0
                    and len(self.graph.edges) > 1):
                if self.backend == "ba":
                    self._optimize_ba()
                else:
                    self._optimize_graph()
        self._kf_of_frame.append(len(self.store.keyframes) - 1)
        return state

    def _optimize_graph(self) -> None:
        with self._span("poseGraph", len(self.graph.edges)):
            self.graph.optimize(n_iters=8)

    def _optimize_ba(self) -> None:
        """Sparse Schur-complement BA over snapshot-derived landmarks,
        seeded from the pose-graph solution: the graph (odometry +
        ICP-verified loop closures) fixes the large-scale drift, then BA
        jointly refines poses and landmarks from the surface
        measurements. The graph's keyframe poses are replaced by the BA
        solution, so :meth:`corrected_trajectory` propagates it. While
        the landmark set is degenerate the pose-graph solution stays."""
        self._optimize_graph()
        with self._span("bundleAdjust", len(self.store.keyframes)):
            self._bundle_adjust()

    def _bundle_adjust(self) -> None:
        prob = build_ba_problem([kf.on_host() for kf in self.store.keyframes],
                                poses_cur=self.graph.poses)
        if prob is None:
            return
        _odo_poses, lms0, cam, lm, z, w = prob
        poses0 = np.stack(self.graph.poses).astype(np.float32)
        # Cameras and landmarks are padded to power-of-two tiers, as in
        # JAX (where the tiers buy compile reuse): padded cameras are
        # identity poses and padded landmarks zeros; no observation
        # references them, so their update is exactly zero.
        n_real, m_real = poses0.shape[0], lms0.shape[0]
        poses_p = np.concatenate(
            [poses0, np.tile(np.eye(4, dtype=np.float32),
                             (_cap(n_real) - n_real, 1, 1))])
        lms_p = np.concatenate(
            [lms0, np.zeros((_cap(m_real) - m_real, 3), np.float32)])

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        # n_cg pinned so the CG depth does not vary with the padding tier.
        out_p, _out_l, _r2 = bundle_adjust(
            dev(poses_p), dev(lms_p), dev(cam), dev(lm), dev(z), dev(w),
            n_iters=4, damping=1e-4, n_cg=64)
        out_p = out_p.cpu().numpy()
        self.graph.poses = [out_p[k] for k in range(n_real)]

    def corrected_trajectory(self) -> np.ndarray:
        """Per-frame poses with the graph's corrections propagated from
        the owning keyframe (frames between keyframes move rigidly with
        their predecessor keyframe)."""
        if not self.store.keyframes:
            return np.stack(self._trajectory) if self._trajectory else \
                np.zeros((0, 4, 4), np.float32)
        opt = [np.asarray(p) for p in self.graph.poses]
        out = []
        for frame, pose in enumerate(self._trajectory):
            k = self._kf_of_frame[frame]
            if k < 0:
                out.append(pose)
                continue
            kf = self.store.keyframes[k]
            correction = opt[k] @ np.linalg.inv(kf.pose)
            out.append(correction @ pose)
        return np.stack(out)
