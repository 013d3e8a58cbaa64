"""Per-kernel timed frame execution: the KERNEL_TIMINGS route (port of
``slambench_tpu/frontend/timed.py``).

The reference wraps every kernel launch in TICK/TOCK macros that fence
the device and print ``name duration_ns size`` to stderr (reference:
kfusion/src/cpp/kernels.cpp:16-37,57; the CUDA TOCK fences with
``cudaDeviceSynchronize``, cuda/kernels.cu:23-38). ``TimedRunner`` runs
the reference's frame in that structure: every kernel is its own
dispatch under ``utils/timers.py:KernelTimer`` (host clock, device fence
on exit), logged under the reference's kernel names, and the
coarse-to-fine ICP runs on the host with one read of the convergence
flag an iteration, breaking the level there (the reference's structure,
opencl/kernels.cpp:793-807). ``eval/check_kernels.py`` reads the lines.

This is another algorithm than the production step
(``KFusion.compute_frame``), as in the JAX package: the ICP stops a
level at convergence instead of running its budget frozen, and on the
min-mip backends every raycast past frame 2 starts at
``warm_start_bound`` of the previous hit distances (production does so
only with ``SLAMBENCH_WARM_START=1``); the integrate is the monolithic
one whatever ``SLAMBENCH_INTEGRATE_BLOCKS`` says.

Two dispatches are the hand kernels: ``bilateralFilter`` is K1
(``ops/hopper/bilateral.py:bilateral_filter_cuda``, metres in) and
``reduce`` is K2 (``ops/hopper/reduce.py:reduce_track_cuda``, TrackData
in), the Pallas kernels' own contracts. On CUDA tensors the wrappers
launch the kernels (or raise); on the CPU they run the plain twins.

The warm start pools the previous hit distances in 8x8 blocks, so on
``fast`` the frame's sides must be multiples of 8: otherwise frame 3
raises ``ValueError`` naming the shape.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.geometry import (
    get_camera_matrix, get_inverse_camera_matrix, mat4mul, rigid_inverse,
)
from slambench_tpu_torch.ops.hopper.bilateral import bilateral_filter_cuda
from slambench_tpu_torch.ops.hopper.reduce import reduce_track_cuda
from slambench_tpu_torch.ops.integrate import integrate
from slambench_tpu_torch.ops.preprocess import half_sample_robust, mm2meters
from slambench_tpu_torch.ops.raycast import raycast_maps
from slambench_tpu_torch.ops.raycast_fast import (
    make_min_mip, raycast_fast_maps, warm_start_bound,
)
from slambench_tpu_torch.ops.solve import check_pose, update_pose
from slambench_tpu_torch.ops.track import track
from slambench_tpu_torch.ops.vertex import depth2vertex, vertex2normal
from slambench_tpu_torch.pipeline import KFusion, KFusionState, cv_predict
from slambench_tpu_torch.utils.timers import KernelTimer


class TimedRunner:
    """Runs one frame kernel by kernel with reference-named timing lines
    on ``stream`` (stderr by default), on ``kf``'s device and settings."""

    def __init__(self, kf: KFusion, stream=None):
        self.kf = kf
        self.stream = stream if stream is not None else sys.stderr
        self._inv_k = [get_inverse_camera_matrix(kf._k / float(1 << i))
                       for i in range(len(kf.iterations))]

    def _timed(self, name: str, size: int, fn, *args):
        with KernelTimer(name, size, stream=self.stream,
                         enabled=True) as t:
            t.result = fn(*args)
        return t.result

    def _bilateral(self, fd: torch.Tensor) -> torch.Tensor:
        return bilateral_filter_cuda(fd, self.kf.gaussian, params.E_DELTA,
                                     params.RADIUS)

    def _half(self, depth: torch.Tensor) -> torch.Tensor:
        return half_sample_robust(depth, params.E_DELTA * 3, 1)

    def _update(self, pose: torch.Tensor, red: torch.Tensor):
        return update_pose(pose, red, self.kf.icp_threshold)

    def _check(self, pose, old_pose, red):
        return check_pose(pose, old_pose, red, (self.kf.H, self.kf.W))

    def _integrate(self, tsdf, weight, fd, pose):
        kf = self.kf
        return integrate(tsdf, weight, fd, rigid_inverse(pose),
                         get_camera_matrix(kf._k), kf.mu, params.MAX_WEIGHT,
                         kf.volume_dimensions)

    def _raycast(self, tsdf, mip, pose, t_init):
        kf = self.kf
        view = mat4mul(pose, self._inv_k[0])
        if kf.backend == "jnp":
            vertex, normal = raycast_maps(
                tsdf, kf.volume_dimensions, view, (kf.H, kf.W),
                params.NEAR_PLANE, params.FAR_PLANE, kf.step, 0.75 * kf.mu)
            return vertex, normal, torch.zeros((kf.H, kf.W),
                                               dtype=torch.float32,
                                               device=kf.device)
        return raycast_fast_maps(
            tsdf, mip, kf.volume_dimensions, view, (kf.H, kf.W),
            params.NEAR_PLANE, params.FAR_PLANE, kf.step, 0.75 * kf.mu,
            t_init=t_init)

    def process_frame(self, state: KFusionState, input_depth, frame: int,
                      tracking_rate: int = 1,
                      integration_rate: int = 2) -> KFusionState:
        """One frame (uint16 millimetres, numpy or tensor) with the
        reference's host-side gates, every kernel timed."""
        kf = self.kf
        H, W = kf.H, kf.W
        npix = H * W
        input_depth = kf.to_device(input_depth)
        ratio = input_depth.shape[1] // W

        fd = self._timed("mm2meters", npix, mm2meters, input_depth, ratio)
        sd0 = self._timed("bilateralFilter", npix, self._bilateral, fd)
        state = dataclasses.replace(state, float_depth=fd,
                                    scaled_depth0=sd0)

        tracked = False
        if frame % tracking_rate == 0:
            levels = len(kf.iterations)
            pyr = [sd0]
            for i in range(1, levels):
                pyr.append(self._timed("halfSampleRobustImage",
                                       npix >> (2 * i), self._half,
                                       pyr[-1]))
            verts, norms = [], []
            for i in range(levels):
                v = self._timed("depth2vertex", npix >> (2 * i),
                                depth2vertex, pyr[i], self._inv_k[i])
                n = self._timed("vertex2normal", npix >> (2 * i),
                                vertex2normal, v)
                verts.append(v)
                norms.append(n)

            old_pose = state.pose
            view = mat4mul(get_camera_matrix(kf._k),
                           rigid_inverse(state.raycast_pose))
            # The ICP's initial pose follows the motion model, as in
            # KFusion._icp.
            if kf.motion_model == "cv":
                pose = cv_predict(state.pose, state.old_pose)
            else:
                pose = state.pose
            red = state.reduction
            track_result = state.track_result
            for level in reversed(range(levels)):
                size_l = npix >> (2 * level)
                for _ in range(kf.iterations[level]):
                    data = self._timed("track", size_l, track,
                                       verts[level], norms[level],
                                       state.ref_vertex, state.ref_normal,
                                       pose, view)
                    red = self._timed("reduce", size_l, reduce_track_cuda,
                                      data)
                    pose, conv = self._timed("updatePose", 1, self._update,
                                             pose, red)
                    if level == 0:
                        track_result = data["result"]
                    # The host-side convergence break: the reference reads
                    # the reduction back and breaks every iteration
                    # (opencl/kernels.cpp:793-807).
                    if bool(conv):
                        break
            pose, tracked_dev = self._timed("checkPose", 1, self._check,
                                            pose, old_pose, red)
            tracked = bool(tracked_dev)
            state = dataclasses.replace(
                state, pose=pose, old_pose=old_pose, reduction=red,
                track_result=track_result, tracked=tracked_dev)
        else:
            state = dataclasses.replace(
                state, tracked=torch.zeros((), dtype=torch.bool,
                                           device=kf.device))

        should = (tracked and frame % integration_rate == 0) or frame <= 3
        if should:
            tsdf, weight = self._timed("integrate", npix, self._integrate,
                                       state.tsdf, state.weight,
                                       state.float_depth, state.pose)
            mip = self._timed("minMip", npix, make_min_mip, tsdf)
            state = dataclasses.replace(state, tsdf=tsdf, weight=weight,
                                        mip=mip)
        state = dataclasses.replace(state, integrated=torch.full(
            (), should, dtype=torch.bool, device=kf.device))

        if frame > 2:
            t_init = None
            if kf.backend != "jnp":
                t_init = warm_start_bound(
                    state.prev_t_hit,
                    mat4mul(rigid_inverse(state.raycast_pose), state.pose),
                    params.FAR_PLANE, 0.75 * kf.mu)
            vertex, normal, t_hit = self._timed(
                "raycast", npix, self._raycast, state.tsdf, state.mip,
                state.pose, t_init)
            state = dataclasses.replace(
                state, raycast_pose=state.pose, ref_vertex=vertex,
                ref_normal=normal, prev_t_hit=t_hit)
        return state
