"""The KinectFusion frame step in PyTorch (port of
``slambench_tpu/pipeline.py``: ``KFusionState`` and ``KFusion``).

``KFusionState`` is a frozen dataclass of tensors with the JAX state's
leaf names, dtypes and layouts, so a state converts between the two
packages leaf for leaf (``convert.py``). ``KFusion`` runs the four
phases of the reference's ``Kfusion`` class on one ``torch.device``:

* preprocessing — mm2meters and the bilateral filter in one kernel (K1F);
* tracking — half-sample pyramid, vertex/normal maps, coarse-to-fine
  ICP with one fused track + reduce kernel (K2) per iteration, checkPose;
* integration — TSDF fusion and the min-mip rebuild; with
  ``SLAMBENCH_INTEGRATE_BLOCKS`` set to a grid, the frustum-culled block
  integrate (``integrate_blocks``) on the per-frame route;
* raycasting — the next reference maps: the min-mip skip march, or the
  oracle trilinear march for the ``jnp`` backend.

The backend names ``fast``, ``pallas`` and ``auto`` run the min-mip
march and ``jnp`` the oracle march; every name runs the hand kernels K1F
and K2F on the card. With ``SLAMBENCH_WARM_START=1`` in the environment
when the pipeline is made, the min-mip march starts each ray at the
previous raycast's warm-start bound (``warm_start_bound``; off by
default, as in JAX). The render methods give the reference's three
diagnostic images.

``scan_step`` is the frame step with static gates and no host read:
the integration gate stays on the device (``integration(on_device=
True)``, JAX's ``lax.cond`` as a voxel mask) and the raycast marches its
whole budget. ``compute_frames_scan`` and ``compute_frames_scan_rated``
run it over a batch of frames (JAX's ``lax.scan`` routes): on the card
as replays of a CUDA graph of one gate period (``graphs.py``), on the
CPU as a plain loop.

The ICP loop runs each level's fixed iteration budget with no host read:
a level that converges freezes its pose, reduction and result codes from
the converging iteration on (the JAX ``while_loop`` applies the update of
the step that reports convergence, then stops). ``motion_model="cv"``
starts it from a damped constant-velocity prediction (``cv_predict``),
computed on the device.

With KERNEL_TIMINGS set, ``KFusion.timings`` records a span under the
reference's kernel names (``utils/timers.py``): around each K1F and K2F
launch (its events recorded by the kernel's C entry point, so the span
holds the launch and not the wrapper's host work), each pyramid step,
each level's vertex and normal maps, the pose solve, checkPose,
integrate, the min-mip, the raycast and each render.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from slambench_tpu_torch import graphs, params
from slambench_tpu_torch.geometry import (
    get_camera_matrix, get_inverse_camera_matrix, mat4mul, rigid_inverse,
    se3_exp, se3_log, translation_pose,
)
from slambench_tpu_torch.ops.hopper.bilateral import mm2m_bilateral_cuda
from slambench_tpu_torch.ops.hopper.reduce import track_reduce_cuda
from slambench_tpu_torch.ops.integrate import integrate, integrate_blocks
from slambench_tpu_torch.ops.preprocess import (
    half_sample_robust, make_gaussian,
)
from slambench_tpu_torch.ops.raycast import raycast_maps
from slambench_tpu_torch.ops.raycast_fast import (
    make_min_mip, raycast_fast_maps, warm_start_bound,
)
from slambench_tpu_torch.ops.render import (
    render_depth, render_track, render_volume,
)
from slambench_tpu_torch.ops.solve import check_pose, update_pose
from slambench_tpu_torch.ops.vertex import depth2vertex, vertex2normal
from slambench_tpu_torch.utils.timers import KernelTimings
from slambench_tpu_torch.volume import init_volume

BACKENDS = ("jnp", "fast", "pallas", "auto")
MOTION_MODELS = ("none", "cv")


def parse_block_grid(value: str, resolution: Tuple[int, int, int]
                     ) -> Tuple[int, int, int]:
    """The (z, y, x) block grid of ``SLAMBENCH_INTEGRATE_BLOCKS``, read
    as JAX's ``KFusion`` reads it (``pipeline.py:161-179``): ``NZ``,
    ``NZxNY`` or ``NZxNYxNX``; "0" is 1x1x1 (the monolithic integrate),
    and so is "auto" or "": JAX picks 8x8x2 there only on a TPU. A grid
    that does not divide ``resolution`` (x, y, z) is 1x1x1; a value of
    another form, or a count below 1, raises ``ValueError``."""
    if value in ("auto", "", "0"):
        return (1, 1, 1)
    try:
        parts = [int(v) for v in value.lower().split("x")]
    except ValueError:
        parts = []
    if not 1 <= len(parts) <= 3 or min(parts) < 1:
        raise ValueError(f"SLAMBENCH_INTEGRATE_BLOCKS={value!r}: use NZ, "
                         "NZxNY or NZxNYxNX (positive integers)")
    nz, ny, nx = (parts + [1, 1])[:3]
    rx, ry, rz = resolution
    if rz % nz or ry % ny or rx % nx:
        return (1, 1, 1)
    return (nz, ny, nx)


@dataclasses.dataclass(frozen=True)
class KFusionState:
    """Everything that persists across frames, leaf for leaf the JAX
    package's ``KFusionState``."""
    tsdf: torch.Tensor          # int16 [Z, Y, X]
    weight: torch.Tensor        # int8 [Z, Y, X]
    mip: torch.Tensor           # int16 [Z/8, Y/8, X/8] conservative min-mip
    pose: torch.Tensor          # f32 [4, 4]
    old_pose: torch.Tensor      # f32 [4, 4]
    raycast_pose: torch.Tensor  # f32 [4, 4]
    ref_vertex: torch.Tensor    # f32 [3, H, W] raycast vertex map
    ref_normal: torch.Tensor    # f32 [3, H, W] raycast normal map
    prev_t_hit: torch.Tensor    # f32 [H, W] last raycast hit distances
    float_depth: torch.Tensor   # f32 [H, W] metres (mm2meters output)
    scaled_depth0: torch.Tensor  # f32 [H, W] bilateral-filtered depth
    track_result: torch.Tensor  # i32 [H, W] last ICP result codes
    reduction: torch.Tensor     # f32 [32] packed normal equations
    tracked: torch.Tensor       # bool []
    integrated: torch.Tensor    # bool []


def cv_predict(pose: torch.Tensor, old_pose: torch.Tensor,
               damping: float = 0.5, max_step: float = 0.04) -> torch.Tensor:
    """Damped constant-velocity ICP warm start (JAX ``cv_predict``).

    With ``pose = old_pose @ D``, ``D`` the last camera-frame motion, the
    prediction is ``pose @ exp(damping * clamp(log(D)))``: the twist's
    norm is capped at ``max_step`` and halved, which keeps the guess in
    the coarse level's basin. After a rejected frame ``D = I`` and the
    prediction is the previous pose. All on the device: no host read.
    """
    xi = se3_log(mat4mul(rigid_inverse(old_pose), pose))
    norm = torch.clamp(torch.linalg.vector_norm(xi), min=1e-12)
    scale = damping * torch.clamp(torch.full_like(norm, max_step) / norm,
                                  max=1.0)
    return mat4mul(pose, se3_exp(xi * scale))


class KFusion:
    """Pipeline driver for one run configuration on one device."""

    def __init__(self,
                 computation_size: Tuple[int, int],      # (W, H) ref order
                 volume_resolution: Tuple[int, int, int],
                 volume_dimensions: Tuple[float, float, float],
                 init_pose: Sequence[float],
                 pyramid: Sequence[int],
                 camera: Sequence[float],
                 mu: float = 0.1,
                 icp_threshold: float = 1e-5,
                 backend: str = "fast",
                 motion_model: str = "none",
                 *,
                 device: torch.device):
        # The backend picks the raycast march only: "jnp" the oracle,
        # the others the min-mip march. Kernels K1F/K2F run for all.
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}: use jnp|fast|pallas|auto")
        # ICP start: "none" the previous pose (the reference), "cv" the
        # constant-velocity prediction.
        if motion_model not in MOTION_MODELS:
            raise ValueError(
                f"unknown motion_model {motion_model!r}: use none|cv")
        self.device = torch.device(device)
        W, H = computation_size
        self.W, self.H = W, H
        self.volume_resolution = tuple(int(v) for v in volume_resolution)
        self.volume_dimensions = tuple(float(d) for d in volume_dimensions)
        self.init_pose = tuple(float(p) for p in init_pose)
        self.iterations = tuple(int(i) for i in pyramid)
        self.camera = tuple(float(c) for c in camera)
        self.mu = float(mu)
        self.icp_threshold = float(icp_threshold)
        self.backend = backend
        self.motion_model = motion_model
        # Temporal warm start of the min-mip march (JAX pipeline.py:
        # 384-397): off by default; the oracle march keeps none.
        self.warm_start = (backend != "jnp" and os.environ.get(
            "SLAMBENCH_WARM_START", "0") == "1")
        # Fine ray-march step = min(dim) / max(res) (reference: kernels.h:116).
        self.step = min(self.volume_dimensions) / max(self.volume_resolution)
        # Frustum-culled block integrate (JAX pipeline.py:153-179).
        self.integrate_block_grid = parse_block_grid(
            os.environ.get("SLAMBENCH_INTEGRATE_BLOCKS", "auto"),
            self.volume_resolution)
        self.gaussian = make_gaussian()
        self._levels = len(self.iterations)
        self._k = torch.tensor(self.camera, dtype=torch.float32,
                               device=self.device)
        self.timings = KernelTimings(self.device)
        self.graphs = graphs.ScanGraphs(self)

    # ------------------------------------------------------------------ #

    def init_state(self) -> KFusionState:
        """Fresh state; ``raycast_pose`` starts at the initial pose, as in
        the JAX package (the reference inverts a zero matrix there)."""
        tsdf, weight = init_volume(self.volume_resolution, self.device)
        return self._fresh_state(tsdf, weight, make_min_mip(tsdf))

    def _fresh_state(self, tsdf: torch.Tensor, weight: torch.Tensor,
                     mip: torch.Tensor) -> KFusionState:
        """A fresh state around a fresh volume (or, sharded, slab)."""
        dev = self.device
        pose = translation_pose(self.init_pose, dev)
        H, W = self.H, self.W

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return KFusionState(
            tsdf=tsdf, weight=weight, mip=mip,
            pose=pose.clone(), old_pose=pose.clone(),
            raycast_pose=pose.clone(),
            ref_vertex=zeros(3, H, W), ref_normal=zeros(3, H, W),
            prev_t_hit=zeros(H, W), float_depth=zeros(H, W),
            scaled_depth0=zeros(H, W),
            track_result=zeros(H, W, dtype=torch.int32),
            reduction=zeros(32),
            tracked=zeros(dtype=torch.bool),
            integrated=zeros(dtype=torch.bool))

    def to_device(self, depth) -> torch.Tensor:
        """Upload a uint16 millimetre depth frame (numpy or tensor) as
        int32 on this pipeline's device (torch has few uint16 ops)."""
        if isinstance(depth, np.ndarray):
            depth = torch.from_numpy(np.ascontiguousarray(depth, np.int32))
        return depth.to(device=self.device, dtype=torch.int32)

    # ---------------------------- phases ------------------------------ #

    def preprocessing(self, state: KFusionState,
                      input_depth: torch.Tensor) -> KFusionState:
        """mm->m conversion + bilateral filter, one kernel launch
        (reference: cpp/kernels.cpp:915-922)."""
        ratio = input_depth.shape[1] // self.W
        fd, sd0 = mm2m_bilateral_cuda(
            input_depth, ratio, self.gaussian, params.E_DELTA, params.RADIUS,
            span=self.timings.span("mm2m_bilateral", self.H * self.W))
        return dataclasses.replace(state, float_depth=fd, scaled_depth0=sd0)

    def tracking(self, state: KFusionState, census: bool = False):
        """Pyramid + per-level vertex/normal maps + coarse-to-fine ICP +
        checkPose (reference: cpp/kernels.cpp:924-971).

        ``census=True`` also returns, coarsest level first, each level's
        executed iteration count (int32) and convergence flag (bool) on
        the device: JAX's ``_tracking(with_census=True)``
        (``tools/icp_census.py``). The loop runs each level's whole
        budget either way; the count is the iterations up to and
        including the first that converged, which is what JAX's
        ``while_loop`` runs."""
        verts, norms = self._level_maps(state.scaled_depth0)
        return self._icp(state, verts, norms, census)

    def _level_maps(self, sd0: torch.Tensor):
        """The half-sample pyramid's vertex and normal maps, finest
        level first."""
        span = self.timings.span
        npix = self.H * self.W
        pyr = [sd0]
        for i in range(1, self._levels):
            with span("halfSampleRobustImage", npix >> (2 * i)):
                pyr.append(half_sample_robust(pyr[-1], params.E_DELTA * 3,
                                              1))
        verts, norms = [], []
        for i in range(self._levels):
            inv_k = get_inverse_camera_matrix(self._k / float(1 << i))
            with span("depth2vertex", npix >> (2 * i)):
                v = depth2vertex(pyr[i], inv_k)
            with span("vertex2normal", npix >> (2 * i)):
                n = vertex2normal(v)
            verts.append(v)
            norms.append(n)
        return verts, norms

    def _icp(self, state: KFusionState, verts, norms, census: bool,
             psum=None, gather_result=None):
        """The coarse-to-fine ICP over the level maps ``verts`` /
        ``norms`` and checkPose. ``psum`` completes each iteration's
        reduction across shards and ``gather_result`` reassembles level
        0's result codes (``parallel/step.py``); both are None on one
        device."""
        span = self.timings.span
        old_pose = state.pose
        view = mat4mul(get_camera_matrix(self._k),
                       rigid_inverse(state.raycast_pose))
        if self.motion_model == "cv":
            pose = cv_predict(state.pose, state.old_pose)
        else:
            pose = state.pose
        reduction = state.reduction
        track_result = state.track_result
        counts, convs = [], []

        for level in reversed(range(self._levels)):
            h, w = verts[level].shape[1:]
            level_result = torch.zeros((h, w), dtype=torch.int32,
                                       device=self.device)
            done = torch.zeros((), dtype=torch.bool, device=self.device)
            n_it = 0
            for _ in range(self.iterations[level]):
                red, result = track_reduce_cuda(
                    verts[level], norms[level], state.ref_vertex,
                    state.ref_normal, pose, view,
                    span=span("track_reduce", h * w))
                if psum is not None:
                    red = psum(red)
                with span("updatePose", 1):
                    new_pose, conv = update_pose(pose, red,
                                                 self.icp_threshold)
                pose = torch.where(done, pose, new_pose)
                reduction = torch.where(done, reduction, red)
                level_result = torch.where(done, level_result, result)
                if census:
                    n_it = n_it + (~done).to(torch.int32)
                done = done | conv
            if census:
                counts.append(n_it)
                convs.append(done)
            if level == 0:
                track_result = (level_result if gather_result is None
                                else gather_result(level_result))

        with span("checkPose", 1):
            pose, tracked = check_pose(pose, old_pose, reduction,
                                       (self.H, self.W))
        new_state = dataclasses.replace(
            state, pose=pose, old_pose=old_pose, reduction=reduction,
            track_result=track_result, tracked=tracked)
        if census:
            return new_state, torch.stack([
                torch.as_tensor(c, dtype=torch.int32, device=self.device)
                for c in counts]), torch.stack(convs)
        return new_state

    def skip_tracking(self, state: KFusionState) -> KFusionState:
        """A frame the tracking rate skips: only ``tracked`` changes."""
        return dataclasses.replace(
            state, tracked=torch.zeros((), dtype=torch.bool,
                                       device=self.device))

    def integration(self, state: KFusionState, *, integrate_frame: bool,
                    force_integrate: bool, on_device: bool = False
                    ) -> KFusionState:
        """TSDF fusion gated on pose acceptance and the integration rate
        (reference: cpp/kernels.cpp:988-1004). The accept flag is read on
        the host only when the gates leave it to decide, and the update
        is skipped when it is off. With ``on_device`` the gate stays a 0-d
        bool tensor (JAX's ``lax.cond``): it masks the voxel update, the
        min-mip is rebuilt from the (maybe unchanged) TSDF, and the host
        reads nothing."""
        pose, ok = check_pose(state.pose, state.old_pose, state.reduction,
                              (self.H, self.W))
        tsdf, weight, mip = state.tsdf, state.weight, state.mip
        if on_device:
            should = (ok & integrate_frame) | force_integrate
        else:
            should = force_integrate or (integrate_frame and bool(ok))
        if on_device or should:
            tsdf, weight, mip = self._integrate_volume(
                state, pose, should if on_device else None)
        if not on_device:
            should = torch.full((), should, dtype=torch.bool,
                                device=self.device)
        return dataclasses.replace(
            state, pose=pose, tsdf=tsdf, weight=weight, mip=mip,
            integrated=should)

    def _integrate_volume(self, state: KFusionState, pose: torch.Tensor,
                          gate: Optional[torch.Tensor]):
        """Fuse ``state.float_depth`` into the volume from ``pose``
        (masked by ``gate`` when given) and rebuild the min-mip: (tsdf,
        weight, mip). With a block grid the host-gated route runs the
        frustum-culled ``integrate_blocks`` (the same bits); the gated
        route (``gate``, no host read) keeps the monolithic masked
        integrate, since the visible count depends on the data."""
        args = (state.tsdf, state.weight, state.float_depth,
                rigid_inverse(pose), get_camera_matrix(self._k), self.mu,
                params.MAX_WEIGHT, self.volume_dimensions)
        nz, ny, nx = self.integrate_block_grid
        with self.timings.span("integrate", state.tsdf.numel()):
            if gate is None and (nz, ny, nx) != (1, 1, 1):
                tsdf, weight = integrate_blocks(*args, n_z=nz, n_y=ny,
                                                n_x=nx)
            else:
                tsdf, weight = integrate(*args, gate=gate)
        with self.timings.span("minMip", tsdf.numel()):
            mip = make_min_mip(tsdf)
        return tsdf, weight, mip

    def raycasting(self, state: KFusionState, *, early_exit: bool = True
                   ) -> KFusionState:
        """Surface prediction from the current pose
        (reference: cpp/kernels.cpp:973-986). The oracle march keeps no
        hit distances: ``prev_t_hit`` holds zeros, as in JAX. With the
        warm start on, the min-mip march starts at the bound that the
        previous hit distances and the motion since that raycast give.
        ``early_exit=False`` marches the whole budget with no host read
        (the same bits, ``ops/raycast_fast.py:mip_march``)."""
        view = mat4mul(state.pose, get_inverse_camera_matrix(self._k))
        with self.timings.span("raycast", self.H * self.W):
            if self.backend == "jnp":
                vertex, normal = raycast_maps(
                    state.tsdf, self.volume_dimensions, view,
                    (self.H, self.W), params.NEAR_PLANE, params.FAR_PLANE,
                    self.step, 0.75 * self.mu, early_exit=early_exit)
                t_hit = torch.zeros((self.H, self.W), dtype=torch.float32,
                                    device=self.device)
            else:
                t_init = None
                if self.warm_start:
                    delta = mat4mul(rigid_inverse(state.raycast_pose),
                                    state.pose)
                    t_init = warm_start_bound(
                        state.prev_t_hit, delta, params.FAR_PLANE,
                        0.75 * self.mu)
                vertex, normal, t_hit = raycast_fast_maps(
                    state.tsdf, state.mip, self.volume_dimensions, view,
                    (self.H, self.W), params.NEAR_PLANE, params.FAR_PLANE,
                    self.step, 0.75 * self.mu, t_init=t_init,
                    early_exit=early_exit)
        return dataclasses.replace(
            state, raycast_pose=state.pose, ref_vertex=vertex,
            ref_normal=normal, prev_t_hit=t_hit)

    def compute_frame(self, state: KFusionState, input_depth: torch.Tensor,
                      *, tracking_on: bool, integrate_frame: bool,
                      force_integrate: bool, raycast_on: bool
                      ) -> KFusionState:
        """Preprocess -> track -> integrate -> raycast for one frame
        (reference: cpp/kernels.cpp:1048-1055 ``computeFrame``)."""
        state = self.preprocessing(state, input_depth)
        state = self.tracking(state) if tracking_on \
            else self.skip_tracking(state)
        state = self.integration(state, integrate_frame=integrate_frame,
                                 force_integrate=force_integrate)
        if raycast_on:
            state = self.raycasting(state)
        return state

    def scan_step(self, state: KFusionState, input_depth: torch.Tensor, *,
                  tracking_on: bool = True, integrate_frame: bool = True,
                  force_integrate: bool = False, raycast_on: bool = True
                  ) -> KFusionState:
        """``compute_frame`` with no host read: the integration gate on the
        device and the full-budget march (JAX's ``_scan_step``). The body
        of the batched routes and of their CUDA graph; it gives the same
        state as ``compute_frame`` with the same gates."""
        state = self.preprocessing(state, input_depth)
        state = self.tracking(state) if tracking_on \
            else self.skip_tracking(state)
        state = self.integration(state, integrate_frame=integrate_frame,
                                 force_integrate=force_integrate,
                                 on_device=True)
        if raycast_on:
            state = self.raycasting(state, early_exit=False)
        return state

    def compute_frames_scan(self, state: KFusionState, depths
                            ) -> Tuple[KFusionState, dict]:
        """Steady-state frames ``depths [N, H, W]`` (uint16 mm, numpy or
        tensor) in order, each with the ``-r 1`` gates past frame 3
        (tracking and integration on, no forced integrate, raycast on):
        JAX's ``compute_frames_scan``. Returns the state and
        ``{"pos": [N, 3], "tracked": [N], "integrated": [N]}`` on the
        device, ``pos`` the pose translation after each frame (not
        relative to the initial pose)."""
        depths = self.to_device(depths)
        if depths.dim() != 3:
            raise ValueError(f"depths must be [N, H, W], got "
                             f"{tuple(depths.shape)}")
        return self._scan(state, depths[:, None], ((True, True),))

    def compute_frames_scan_rated(self, state: KFusionState, depths, *,
                                  tracking_rate: int, integration_rate: int,
                                  phase: int) -> Tuple[KFusionState, dict]:
        """Rate-gated frames ``depths [K, L, H, W]``, ``L`` the gate
        period ``lcm(tracking_rate, integration_rate)``: frame ``i`` of a
        block runs with the gates of frame ``phase + i`` (JAX's
        ``compute_frames_scan_rated``). Outputs as in
        ``compute_frames_scan``, flattened frame-major to ``K * L``."""
        period = math.lcm(tracking_rate, integration_rate)
        depths = self.to_device(depths)
        if depths.dim() != 4 or depths.shape[1] != period:
            raise ValueError(f"depths must be [K, {period}, H, W] for the "
                             f"gate period {period}, got "
                             f"{tuple(depths.shape)}")
        gates = tuple((f % tracking_rate == 0, f % integration_rate == 0)
                      for f in range(phase, phase + period))
        return self._scan(state, depths, gates)

    def _scan(self, state: KFusionState, depths: torch.Tensor,
              gates: tuple) -> Tuple[KFusionState, dict]:
        """``depths [K, L, H, W]`` through ``scan_step`` with the period's
        ``(tracking_on, integrate_frame)`` gates: a replayed CUDA graph
        on the card, a loop on the CPU (``_graph_route``)."""
        if self._graph_route():
            state, rows = self.graphs.run(state, depths, gates)
        else:
            out = []
            for block in depths:
                for depth, (track_on, integ) in zip(block, gates):
                    state = self.scan_step(state, depth, tracking_on=track_on,
                                           integrate_frame=integ)
                    out.append(graphs.scan_row(state))
            rows = torch.stack(out)
        return state, graphs.unpack_rows(rows)

    def _graph_route(self) -> bool:
        """Whether the batched routes replay a CUDA graph (on the card)
        or loop ``scan_step`` eagerly (on the CPU)."""
        return self.device.type == "cuda"

    def process_frame(self, state: KFusionState, input_depth, frame: int,
                      tracking_rate: int = 1, integration_rate: int = 2
                      ) -> KFusionState:
        """One frame with the reference's host-side gates
        (reference: benchmark.cpp:125-158, cpp/kernels.cpp:927,994,977)."""
        return self.compute_frame(
            state, self.to_device(input_depth),
            **frame_gates(frame, tracking_rate, integration_rate))

    # ---------------------------- rendering --------------------------- #

    def render_depth_image(self, state: KFusionState) -> torch.Tensor:
        with self.timings.span("renderDepth", self.H * self.W):
            return render_depth(state.float_depth)

    def render_track_image(self, state: KFusionState) -> torch.Tensor:
        with self.timings.span("renderTrack", self.H * self.W):
            return render_track(state.track_result)

    def render_volume_image(self, state: KFusionState) -> torch.Tensor:
        """The shaded volume from the current pose, out to twice the far
        plane; the min-mip march unless the backend is ``jnp``."""
        view = mat4mul(state.pose, get_inverse_camera_matrix(self._k))
        with self.timings.span("renderVolume", self.H * self.W):
            return render_volume(
                state.tsdf, self.volume_dimensions, view, (self.H, self.W),
                params.NEAR_PLANE, params.FAR_PLANE * 2.0, self.step,
                0.75 * self.mu,
                mip=None if self.backend == "jnp" else state.mip)

    # ---------------------------- utilities --------------------------- #

    def get_position(self, state: KFusionState) -> np.ndarray:
        """Pose translation relative to the initial pose
        (reference: kernels.h:150-157)."""
        t = state.pose[:3, 3].cpu().numpy()
        return t - np.asarray(self.init_pose, np.float32)

    def dump_volume(self, state: KFusionState, filename: str) -> None:
        """TSDF shorts, x-fastest: byte-compatible with the reference dump
        (reference: cpp/kernels.cpp:1006-1030)."""
        state.tsdf.cpu().numpy().astype("<i2").tofile(filename)


def frame_gates(frame: int, tracking_rate: int = 1,
                integration_rate: int = 2) -> dict:
    """The reference's per-frame gates as ``compute_frame`` keywords."""
    return dict(tracking_on=(frame % tracking_rate == 0),
                integrate_frame=(frame % integration_rate == 0),
                force_integrate=(frame <= 3),
                raycast_on=(frame > 2))
