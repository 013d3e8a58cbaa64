"""Smoke test of slambench_tpu_torch on one CUDA card (an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero and prints
no ``ok`` line):

1. device — require CUDA, print the card (nvidia-smi name, power limit),
   torch and CUDA versions; apply the full-f32 precision policy;
2. build — compile the hand-written kernels (K1 bilateral alone and
   fused with ``mm2meters`` (K1F), K2 ICP reduction alone and fused with
   ``track`` (K2F), G1-G4 gathers) from
   ``slambench_tpu_torch/ops/hopper/csrc`` with nvcc, one process per
   source, all started together; then the native IO library
   (``slambench_tpu_torch/native/slamio.cpp``) with g++;
3. kernels — ``mm2meters`` must equal IEEE division (numpy) for every
   uint16 value and on the probe frames; each kernel against its
   plain-torch version on the card: K1 and K2 at the frame's shapes (a
   synthetic 640x480 frame at compute-size ratio 2, its pyramid and real
   ICP TrackData); K1F on that frame, on every uint16 value and at a
   ragged size (its metres bit for bit numpy's division, the filtered
   depth within K1_TOL, two calls bit for bit), timed beside the
   ``mm2meters`` + K1 pair it replaces; K2F at the pyramid's shapes, on a
   ragged 13x17 level,
   on a level with no input and on one with holes in both normal maps
   (result codes equal, the reduction within tolerance, two calls bit for
   bit), timed as one CUDA-event pair around back-to-back launches
   (``tools/timing.py``); K2 and K2F at 128, 512 and 1024 threads a
   block on the pyramid's shapes (codes equal, the sums within K2_TOL,
   two calls bit for bit), timed; G1-G4 in every mode at the gather probes'
   shapes (G4 on both routes: the 240x320 image staged, 76% of it in
   every block, and a 720x1280 one from device memory), and on the redesigned
   kernels' edge cases (``tools/gather_probe.py:edge_cases``: misaligned
   indices, 1, 3 and 4k+3 lookups, indices below -n, in [-n, 0), in
   range, at or above n and at the int32 extremes, which must give the
   Pallas bodies' wrap, clip or NaN; tables that do not divide G2's
   bands or its cluster's split, the full 232,448-byte table, G3 at its
   cap and at no multiple of 16 bytes, G4 at 1x1, 37x13, a block's stage
   and the staged route's largest, each also one entry larger), with
   both G4 routes launched, and 50 G2
   flat launches back to back, which must all agree exactly (NaN where
   the twin has NaN);
4. main path — synthesise the traj2-like clip on the card, run the
   port's CLI ``run()`` phased at 256^3 / 4.8 m / 320x240 / pyramid
   10,5,4 / -r 1 / -z 4, check the ATE with the port's check_pos, the
   tracked flags, that the ``.raw`` input went through the native
   reader (its read + upload time beside the numpy reader's), that K1F
   launched once a frame, K2F once an ICP
   iteration, and the metre-in K1 and the unfused K2 not at all; the
   ``rendering`` column > 0 on every frame and ``total >= computation +
   rendering``; on the final state, the depth, track and normal images
   on the card within one grey level of a CPU copy's on >= 99.9% of
   pixels, and the min-mip render route losing <= 0.1% of the oracle
   route's hits; the two-phase march's counters (branches, substeps and
   ray-substeps of each phase) over the run's raycasts and renders;
5. scan — ``--scan-chunk`` as CUDA graph replays at phase 4's settings:
   (a) boot frames 0-4, then ``compute_frames_scan`` in chunks of 8
   against per-frame ``compute_frame`` from the same state, in JAX's
   contract (positions within 1e-4 m, flags equal, < 2% of voxels
   differ, < 1e-4 beyond 2 LSB), with the measured differences, whether
   every leaf is bit for bit equal, the eager min-mip march's substeps a
   raycast, and the replay tally (K1F once, K2F 19 times a frame) of
   every chunk; (b) ``compute_frames_scan_rated`` at ``-r 2`` against
   per-frame dispatch, ``integrated`` alternating exactly; (c) the CLI
   with ``--fused --scan-chunk 8``: ATE mean < 0.03 m, tracked from
   frame 4, computation mean / median / p90 beside phase 4's, capture
   and instantiate time, ``max_memory_allocated`` with the graph; (d)
   K1F and K2F counted in a ``KERNEL_TIMINGS=xprof`` trace of one
   2-frame chunk (exactly 2 and 38) and in the route's tally, and one
   replay's reduction and result codes against the eager
   ``scan_step``'s; (e) one eager ``scan_step`` under
   ``torch.cuda.set_sync_debug_mode("error")``;
6. resume — frames 0-14 with ``--checkpoint``, then ``--resume`` to
   frame 29: the poses equal phase 4's within 1e-6 m;
7. KERNEL_TIMINGS route — the phased CLI with KERNEL_TIMINGS=1, which
   takes ``frontend/timed.py`` (every kernel its own fenced dispatch,
   the ICP breaking on the host, JAX's rows), on the same clip at full
   size: (a) ``--backend fast`` (every raycast past frame 2 warm-started)
   and (b) ``--backend jnp --motion-model cv``; tracked from frame 5, ATE
   mean < 0.03 m for (a) and < 0.06 m for (b); K1 once a frame and K2
   once a ``reduce`` row (as many as the ``track`` and ``updatePose``
   rows), K1F and K2F never; the rows exactly JAX's and the render
   spans; the port's ``eval/check_kernels.py`` table, the fenced row
   means and the executed ICP iterations a frame printed;
8. inputs and observation — (a) the first 12 frames of the clip written
   as an ICL-NUIM scene directory (ASCII euclidean depth, planarized
   back by the reader) with an ``.scf`` file that points at it and sets
   the camera: the scene reader's frames within 1 mm of the RAW frames,
   equal to what ``tools/scene2raw.py``'s numpy path writes and within 1
   LSB of its native path; the CLI (``main``)
   on the ``.scf`` with ``--stats --debug-nans --report-device
   --break-at-frame 10``: 11 rows, K1F once and K2F 19 times a frame,
   tracked from frame 4, the card's NVML rail in the stats block with
   power > 0 W and energy > 0 J, no NaN fault, the device report naming
   the card; (b) frames 0-14 with ``SLAMBENCH_WARM_START=1``: tracked
   from frame 5 and ATE mean below phase 4's bound, the positions'
   distance from phase 4's and the raycasting time beside phase 4's
   printed (JAX's bound is not conservative at its 8x8 block edges, so
   the warm start moves positions by millimetres: PERF.md); (c)
   frames 0-14 with ``--fused --backend jnp --motion-model cv`` and
   KERNEL_TIMINGS=1 (the production oracle + cv step under the spans):
   K1F once a frame, K2F 19 times, tracked from frame 5, ATE mean < 0.06
   m; its log and both of phase 7's have a row for every row name of the
   JAX route (``eval/check_kernels.missing_rows``); the K1F / K2F span
   means and the route's fenced K1 / K2 rows are printed beside phase
   3's kernel times;
9. keyframes — (a) a revisiting orbit (640x480, 44 frames, amp 0.3,
   period 22) through the CLI's ``run()`` at phase 4's settings with
   ``--keyframes`` and with ``--keyframes --ba``: both TUM files with a
   row a frame, at least one loop closure, the corrected trajectory's
   mean error < 0.08 m with orthonormal rotations, K1F once a frame and
   K2F split exactly into 19 launches a tracked frame and 5 a verified
   loop candidate; each route replayed on the CPU's plain route from the
   card's own odometry and snapshots: the same keyframes and edges, and
   edge measurements and corrected poses within 1 mm; the tail ATE
   (frames 22-43) of both routes printed; K2F at the snapshot shape
   against its plain twin; a third, separate ``--keyframes --ba`` run
   with KERNEL_TIMINGS=1 times each alignment, pose-graph optimization
   and bundle adjustment by their spans; (b) the JAX tests'
   coarse setting (160x120, 48^3, thresholds 0.08, optimize every 3
   keyframes) through ``PoseGraphKFusion``: the corrected tail ATE below
   the raw one, and in an offline replay of the same states BA's tail
   ATE at most the pose graph's + 1e-4 m;
10. census — ``tools/icp_census.py --device cuda`` over the clip (phase
   4's settings): executed ICP iterations a level and frame (each within
   its budget), the frozen share of the 19 K2F + updatePose launches a
   frame, K1F once and K2F 19 times a frame; beside it the iterations a
   frame that phase 7's route ran;
11. dashboard — ``frontend/dashboard.py`` served on port 0 over a 6-frame
   clip on the card (started paused, run to frame 4): ``/stats.json``, a
   640x480 ``/tile.png`` (2W x 2H, PNG signature) and a ``/mesh.ply``
   with vertices, then quit; ``frontend/viewer.py`` writes its PNG tiles;
12. mesh — (a) the CLI's ``run()`` with ``--mesh z:1`` (one NCCL rank)
   over the clip: ATE mean < 0.03 m, tracked from frame 5, K1F once and
   K2F 19 times a frame, K1 never; again with ``--fused --scan-chunk 8``
   (CUDA graph replays with the NCCL collectives inside), positions
   within 1e-4 m of (a); (b) ``--mesh z:2`` under ``torchrun
   --nproc-per-node 2``, two ranks on the one card over gloo: the same
   ATE and tracking gates, the ranks' poses equal bit for bit after every
   frame, K1 once and K2F 19 times a frame on each rank, K1F never, and
   the collective tally of a frame equal to ``parallel/comm.py:
   analytic_traffic`` at 19 ICP iterations; ms a frame of (a), (b) and
   phase 4, and the largest position difference (a)-(b); (c) the slab
   raycast at 2 ranks against ``raycast_fast_maps``: JAX's sphere held to
   its exact bounds (hit mismatches < 1%, max |dv| < 1e-5 m, normal dot
   > 0.99 on > 99% of hits), (a)'s final volume to hit mismatches < 1%
   and normal dot > 0.99 on > 98% of common hits (its largest vertex
   difference printed: ROADMAP.md §3); (d)
   ``tools/distributed_probe.py`` at 2 ranks on the card: the psum and
   the ring halo equal their expected values, a full step finite; then
   K1 on a rank's band (124x320) and K2F on the row blocks (120x320,
   60x160, 30x80) against their twins, timed;
13. probe path — run the gather probes (``tools/mosaic_probe.py``, the
   counterpart of the TPU tool that held the Pallas gathers P1-P3, and
   ``tools/gather_probe.py``) at their full shapes; every entry must
   agree with its plain twin and every kernel's launch count must move;
   an empty kernel's time (``tools/k1_split.py`` mode 0) is the floor
   printed beside the rows;
14. tuning — the clip through the CLI's ``main`` in a subprocess (the
   knobs are read at import): (a) with ``SLAMBENCH_MARCH_COMPACT=0``
   (the single-phase march; phase 4 runs the two-phase one) and (b) with
   ``SLAMBENCH_INTEGRATE_BLOCKS=8x8x2`` (the frustum-culled integrate):
   each run's logged positions equal phase 4's bit for bit, K1F once and
   K2F 19 times a frame; the raycasting or integration ms beside phase
   4's, phase 4's and (a)'s march counters, (b)'s visible block share;
   (c) ``tools/autotune.py``'s four sweeps at a few values each (their
   lines read by ``eval/check_kernels.py``), ``tools/march_census.py``
   on the clip after 8 frames and ``tools/probe_integrate.py`` at 256^3;
15. capability — JAX's 1024^3 run (``tests/test_sharded.py:206``):
   ``ShardedKFusion`` at 64x48, 1024^3 / 4.8 m, two gloo ranks on the
   card with 8x8x2 blocks, a bootstrap integrate then a raycast frame
   (``tools/distributed_probe.py --capability 1024``): the wall in
   ``ref_normal``, a zero crossing in ``tsdf[:, ::64, ::64]``; each
   rank's ms and peak memory, and whether a monolithic integrate of its
   slab fits;
16. ops and probes — JAX's per-op roofline rows
   (``tools/profile_frame.py:op_rows``) on the traj2-like clip's state
   after 6 frames at 256^3 / 320x240, each a CUDA graph replay and an
   eager reading: every JAX row present with a positive time, the K1,
   K1F and K2F wrappers launched and captured; ``tools/slice_probe.py``
   at 256^3 and ``tools/probe_r3.py`` at 256^3 with their equalities
   (slice sums bit for bit the scalar gathers', the all-visible slab loop
   bit for bit ``integrate``, the row and lane gathers equal); the CLI
   for 3 frames with ``SLAMBENCH_DEVICE=0`` (its log written) and with
   ``SLAMBENCH_DEVICE`` at the card count (non-zero exit, ``hint:`` on
   stderr); at small reps (``OPS_REPS``), about a minute;
17. report — one JSON line of kernel results (time, plain and library
   time, bound, launches; with the mesh route's rows "K1, mesh band" and
   "K2F, mesh row block", K2's and K2F's ``by_threads``, and K1's and
   K2's launches by route and fenced times on phase 7's route), the
   nvidia-smi line, and the final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

N_FRAMES = 30
PYRAMID = (10, 5, 4)
VOLUME = 256
CLI_ARGS = ["-s", "4.8", "-p", "0.34,0.5,0.24", "-z", "4", "-c", "2",
            "-r", "1", "-k", "481.2,480,320,240", "-v", f"{VOLUME}"]
ATE_MEAN_BOUND = 0.03           # metres, the synth2 class (ROADMAP.md)
CV_ATE_MEAN_BOUND = 0.06        # test_pipeline_e2e.py::test_cv_motion_model_e2e
SCAN_CHUNK = 8                  # phase 5 (a)-(c): --scan-chunk 8
SCAN_XPROF_CHUNK = 2            # phase 5 (d) traces one chunk of 2 frames
SCAN_POS_TOL = 1e-4             # m, test_pipeline_e2e.py:130
RESUME_AT = 15                  # phase 6 checkpoints after frames 0-14
RESUME_TOL = 1e-6               # test_pipeline_e2e.py:183
RENDERING_RATE = 4              # CLI_ARGS' -z
MIP_LOST_SHARE = 1e-3           # of the oracle render's hits
SCENE_FRAMES = 12               # phase 8 writes these as a scene directory
SCENE_BREAK_AT = 10             # ... and runs them with --break-at-frame
SCENE_CAMERA = "481.2,480,320,240"  # the clip's camera, set by the .scf
WARM_FRAMES = 15                # phase 8 (b) runs frames 0-14 warm-started
SPANS_FRAMES = 15               # phase 8 (c): frames 0-14 --fused, spans on
KF_FRAMES, KF_PERIOD, KF_AMP = 44, 22, 0.3   # phase 9's revisiting orbit
KF_TAIL = slice(KF_PERIOD, KF_FRAMES)  # frames 22-43, the second lap
KF_BA_SLACK = 1e-4              # test_ba_backend_beats_posegraph_on_revisit
KF_MEAN_ERR = 0.08              # test_posegraph_kfusion_end_to_end's bound
KF_WITNESS_TOL = 1e-3           # m: card route vs its CPU replay, per pose
DASH_FRAMES = 6                 # phase 11's short clip
CAPABILITY_VOLUME = 1024        # phase 15: tests/test_sharded.py:206
SLAB_NORMAL_SHARE = 0.98        # phase 12 (c), the final volume: the share of
                                # common hits whose normals agree to a dot
                                # > 0.99 (0.9919 read on the H100, PERF.md)
ALIGN_ITERS = 5                 # loop-closure ICP iterations a candidate
JAX_COARSE_TAIL = (0.049, 0.038)  # test_keyframes_e2e.py: raw, corrected
JAX_COARSE_REPLAY = (0.0374, 0.0345)  # test_ba_frontend.py: graph, BA
OPS_WARMUP = 6                  # phase 16: frames before the op rows
OPS_REPS = {"reps": 2, "loop_reps": 4, "solve_iters": 8, "runs": 2}
OPS_CLI_BREAK = 2               # phase 16's CLI run: frames 0-2
# JAX's op rows (slambench_tpu/tools/profile_frame.py:121-455) and its
# scalar readings.
JAX_OP_ROWS = (
    "mm2meters", "bilateral_filter", "track_reduce_L0", "tracking_phase",
    "icp_gather6_L0_per_iter", "icp_gather6_L1_per_iter",
    "icp_gather6_L2_per_iter", "tracking_prep_only",
    "update_pose_solve_per_iter", "icp_full_iter_L0", "integrate",
    "integrate_plus_mip_fused", "make_min_mip", "raycast_cold",
    "raycast_warm", "compute_frame_fused", "gather_vol_random_76800",
    "gather_vol_coherent_76800", "gather_small_76800", "gather_2m_session",
    "gather_2m_coherent")
JAX_OP_SCALARS = ("session_gather_ns_per_elem",
                  "session_gather_coherent_ns_per_elem", "device_eff_gbps")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(label: str, fn, reps: int = 200) -> float:
    """Per-launch ms of ``reps`` back-to-back calls between one CUDA-event
    pair (tools/timing.py), median of five runs."""
    from slambench_tpu_torch.tools.timing import per_launch_ms
    ms, paced = per_launch_ms(fn, reps)
    if paced:
        log(f"  ({label}: the host paced the launches; the time includes it)")
    return ms


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol) -> float:
    torch.cuda.synchronize()
    g = got.detach().cpu().numpy()
    w = want.detach().cpu().numpy()
    np.testing.assert_allclose(g, w, equal_nan=True, err_msg=name, **tol)
    err = float(np.nanmax(np.abs(g.astype(np.float64) - w))) if g.size else 0.0
    log(f"  {name}: shape {tuple(g.shape)} max_abs_err {err:.3e} (ok)")
    return err


def check_mm2meters(name: str, mm: torch.Tensor) -> None:
    """The port's mm2meters on the card against numpy's IEEE division."""
    from slambench_tpu_torch.ops.preprocess import mm2meters
    got = mm2meters(mm, 1).cpu().numpy()
    want = mm.cpu().numpy().astype(np.float32) / np.float32(1000)
    off = int((got.view(np.uint32) != want.view(np.uint32)).sum())
    if off:
        raise RuntimeError(f"mm2meters {name}: {off} of {want.size} values "
                           f"differ from IEEE division")
    log(f"  mm2meters {name}: all {want.size} values equal IEEE division")


def fused_work(result: torch.Tensor):
    """(bytes, f32 operations) that the fused kernel's inputs need at the
    least, from its result codes (see csrc/reduce.cu): every pixel reads
    its normal's x and writes its code; a pixel past -1 reads its vertex
    and is projected; past -2 it reads the reference normal's x; past -3
    the other five reference channels and the distance test; past -4 its
    normal's y, z and the normal test; a tracked pixel forms its row and
    adds it to the 32 sums. (The kernel reads all six level-map values of
    every pixel and all six reference channels of every pixel past -2:
    fewer rounds of loads, more bytes than this bound counts.)"""
    n = result.numel()
    c = {k: int((result == k).sum()) for k in (-1, -2, -3, -4, -5, 1)}
    projected = n - c[-1]
    gathered = projected - c[-2]
    full = gathered - c[-3]
    normal = full - c[-4]
    nbytes = 8 * n + 12 * projected + 4 * gathered + 20 * full \
        + 8 * normal + 32 * 4
    ops = n + 44 * projected + 3 * gathered + 10 * full + 21 * normal \
        + 71 * c[1]
    return nbytes, ops


def k1f_work(in_shape, ratio: int):
    """(bytes, f32 operations) of K1F on an int32 frame of ``in_shape``
    at stride ``ratio``: each output row reads the 32-byte sectors that
    its samples lie in (at stride 2 the whole input row) and two f32
    maps are written; each output does one division and 25 taps."""
    from slambench_tpu_torch.tools.mosaic_probe import K1_OPS_PER_TAP
    h, w = (-(-n // ratio) for n in in_shape)
    sectors = np.unique(np.arange(w) * ratio * 4 // 32).size
    return h * sectors * 32 + 2 * 4 * h * w, (K1_OPS_PER_TAP * 25 + 1) * h * w


def check_k1f(name: str, mm: torch.Tensor, ratio: int, lut) -> float:
    """K1F against its twin: metres bit for bit numpy's IEEE division,
    the filtered depth within K1_TOL, two calls bit for bit."""
    from slambench_tpu_torch.ops.hopper import bilateral
    from slambench_tpu_torch.tools.mosaic_probe import K1_TOL
    fd, sd = bilateral.mm2m_bilateral_cuda(mm, ratio, lut)
    fd2, sd2 = bilateral.mm2m_bilateral_cuda(mm, ratio, lut)
    _, want = bilateral.mm2m_bilateral_plain(mm, ratio, lut)
    ieee = mm.cpu().numpy()[::ratio, ::ratio].astype(np.float32) \
        / np.float32(1000)
    off = int((fd.cpu().numpy().view(np.uint32) != ieee.view(np.uint32))
              .sum())
    if fd.shape != want.shape or off:
        raise RuntimeError(f"K1F {name}: float_depth {tuple(fd.shape)}, "
                           f"{off} values differ from IEEE division")
    if not (torch.equal(fd, fd2)
            and torch.equal(sd.view(torch.int32), sd2.view(torch.int32))):
        raise RuntimeError(f"K1F {name}: two calls differ")
    return compare(f"K1F mm2m_bilateral {name}", sd, want, K1_TOL)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is False; this "
                         "smoke test needs a CUDA card")
    from slambench_tpu_torch.policy import apply_precision_policy
    smi = nvidia_smi_line()
    log(f"[1/17 device] {smi} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    apply_precision_policy()
    return smi


def phase_build() -> None:
    from slambench_tpu_torch.io import native
    from slambench_tpu_torch.ops.hopper import build
    t0 = time.monotonic()
    path = build.build()
    build.load()
    log(f"[2/17 build] {os.path.relpath(path)} in "
        f"{time.monotonic() - t0:.2f} s (nvcc {build.build_seconds:.2f} s)")
    t0 = time.monotonic()
    path = native.build()
    native.load()
    log(f"  native IO {os.path.relpath(path)} (g++) in "
        f"{time.monotonic() - t0:.2f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels(dev: torch.device) -> dict:
    from slambench_tpu_torch import geometry as G
    from slambench_tpu_torch.io.synthetic import (
        SyntheticScene, orbit_trajectory, render_depth_frame,
    )
    from slambench_tpu_torch.ops.hopper import bilateral, reduce
    from slambench_tpu_torch.ops.preprocess import (
        half_sample_robust, make_gaussian, mm2meters,
    )
    from slambench_tpu_torch.ops.track import track
    from slambench_tpu_torch.ops.vertex import depth2vertex, vertex2normal
    from slambench_tpu_torch.tools.mosaic_probe import (
        K1_OPS_PER_TAP, K1_TOL, K2_TOL,
    )
    from slambench_tpu_torch.tools.timing import bound_by, bound_ms

    log("[3/17 kernels] kernel vs plain torch on the card")
    dim = (4.8, 4.8, 4.8)
    poses = orbit_trajectory(12, [0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8])
    depth_mm = render_depth_frame(SyntheticScene(dim=dim), poses[11],
                                  (481.2, 480.0, 320.0, 240.0), (640, 480),
                                  dev)
    mm_dev = torch.from_numpy(depth_mm.astype(np.int32)).to(dev)
    check_mm2meters("every uint16 value", torch.arange(
        65536, dtype=torch.int32, device=dev).reshape(256, 256))
    check_mm2meters("640x480 frame", mm_dev)
    fd = mm2meters(mm_dev, 2).contiguous()
    lut = make_gaussian()

    got = bilateral.bilateral_filter_cuda(fd, lut)
    want = bilateral.plain(fd, lut)
    k1_err = compare("K1 bilateral 240x320", got, want, K1_TOL)
    k1_ms = time_ms("K1", lambda: bilateral.bilateral_filter_cuda(fd, lut))
    k1_plain = time_ms("K1 plain", lambda: bilateral.plain(fd, lut), reps=20)
    k1_bytes, k1_ops = 2 * 4 * fd.numel(), K1_OPS_PER_TAP * 25 * fd.numel()
    log(f"  K1 240x320: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms, "
        f"bound {bound_ms(k1_bytes, k1_ops):.5f} ms "
        f"({bound_by(k1_bytes, k1_ops)})")

    # K1F, mm2meters fused into K1: the frame path's kernel.
    rng = np.random.default_rng(1)
    ragged = rng.integers(300, 5000, (25, 33))
    ragged[rng.random(ragged.shape) < 0.1] = 0
    k1f_err = max(
        check_k1f("240x320 from the 640x480 frame", mm_dev, 2, lut),
        check_k1f("every uint16 value 256x256", torch.arange(
            65536, dtype=torch.int32, device=dev).reshape(256, 256), 1, lut),
        check_k1f("ragged 13x17 at ratio 2", torch.from_numpy(
            ragged.astype(np.int32)).to(dev), 2, lut))
    k1f_bytes, k1f_ops = k1f_work(tuple(mm_dev.shape), 2)
    k1f = {"max_abs_err": k1f_err,
           "ms": time_ms("K1F", lambda: bilateral.mm2m_bilateral_cuda(
               mm_dev, 2, lut)),
           "plain_ms": time_ms("K1F plain", lambda: bilateral.
                               mm2m_bilateral_plain(mm_dev, 2, lut), reps=20),
           "pair_ms": time_ms("mm2meters + K1", lambda: bilateral.
                              bilateral_filter_cuda(
                                  mm2meters(mm_dev, 2).contiguous(), lut)),
           "bound_ms": bound_ms(k1f_bytes, k1f_ops),
           "bound_by": bound_by(k1f_bytes, k1f_ops)}
    log(f"  K1F 240x320: {k1f}")

    # Real TrackData per pyramid level: the level maps against the
    # full-size level-0 maps under a small pose offset.
    k = torch.tensor([240.6, 240.0, 160.0, 120.0], device=dev)
    pyr = [want]
    for _ in range(2):
        pyr.append(half_sample_robust(pyr[-1], 0.3, 1))
    maps = []
    for i, d in enumerate(pyr):
        v = depth2vertex(d, G.get_inverse_camera_matrix(k / float(1 << i)))
        maps.append((v, vertex2normal(v)))
    pose = G.se3_exp(torch.tensor([0.01, -0.005, 0.008, 0.004, -0.003,
                                   0.002], device=dev))
    view = G.get_camera_matrix(k)
    cases = []
    for v, n in maps:
        cases.append((f"{v.shape[1]}x{v.shape[2]}",
                      track(v, n, maps[0][0], maps[0][1], pose, view)))
    rng = np.random.default_rng(0)
    for name, (h, w) in (("ragged 13x17", (13, 17)),
                         ("random codes 240x320", (240, 320))):
        cases.append((name, {
            "result": torch.from_numpy(rng.choice(
                [1, -1, -2, -3, -4, -5], size=(h, w)).astype(np.int32)).to(dev),
            "error": torch.from_numpy(rng.standard_normal(
                (h, w)).astype(np.float32)).to(dev),
            "J": torch.from_numpy(rng.standard_normal(
                (6, h, w)).astype(np.float32)).to(dev)}))
    k2_err = 0.0
    k2_times = {}
    for name, data in cases:
        got = reduce.reduce_track_cuda(data)
        want = reduce.plain(data)
        k2_err = max(k2_err, compare(f"K2 reduce {name}", got, want, K2_TOL))
        if name[0].isdigit():
            n = data["result"].numel()
            nbytes, ops = 32 * n + 32 * 4, 56 * float(want[28])
            # Nearest library call, not the same function: the Gram
            # product of the pre-masked [8, n] stack [e, J, 1].
            m = (data["result"] >= 1).reshape(-1).to(torch.float32)
            stack = torch.cat([data["error"].reshape(1, -1),
                               data["J"].reshape(6, -1),
                               torch.ones(1, n, device=dev)]) * m
            k2_times[name] = {
                "ms": time_ms(f"K2 {name}",
                              lambda: reduce.reduce_track_cuda(data)),
                "plain_ms": time_ms(f"K2 {name} plain",
                                    lambda: reduce.plain(data), reps=50),
                "mm_ms": time_ms(f"K2 {name} torch.mm",
                                 lambda: torch.mm(stack, stack.T)),
                "bound_ms": bound_ms(nbytes, ops),
                "bound_by": bound_by(nbytes, ops)}
            log(f"  K2 {name}: {k2_times[name]}")

    # K2F, track fused into K2, on the same level maps against the
    # level-0 reference maps, a ragged 13x17 level cut from level 0, a
    # level whose every pixel is -1 (no input), and level 0 with stripes
    # of no input (-1) and of no reference normal (-3).
    ref_v, ref_n = maps[0]
    fused_cases = [(f"{v.shape[1]}x{v.shape[2]}", v, n, ref_n)
                   for v, n in maps]
    holes_n, holes_ref_n = ref_n.clone(), ref_n.clone()
    holes_n[0, 40:60] = -2.0
    holes_ref_n[0, 120:140] = -2.0
    fused_cases += [
        ("ragged 13x17", ref_v[:, 100:113, 150:167].contiguous(),
         ref_n[:, 100:113, 150:167].contiguous(), ref_n),
        ("no input 60x80", maps[2][0], torch.full_like(maps[2][1], -2.0),
         ref_n),
        ("holes 240x320", ref_v, holes_n, holes_ref_n)]
    kf_err, kf_times = 0.0, {}
    for name, v, n, rn in fused_cases:
        args = (v, n, ref_v, rn, pose, view)
        got, res = reduce.track_reduce_cuda(*args)
        got2, res2 = reduce.track_reduce_cuda(*args)
        want, want_res = reduce.track_reduce_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(res, want_res):
            raise RuntimeError(f"K2F {name}: {int((res != want_res).sum())} "
                               f"result codes differ from the twin's")
        if not (torch.equal(got, got2) and torch.equal(res, res2)):
            raise RuntimeError(f"K2F {name}: two calls differ")
        kf_err = max(kf_err, compare(f"K2F track_reduce {name}", got, want,
                                     K2_TOL))
        codes = {k: int((res == k).sum()) for k in (1, -1, -2, -3, -4, -5)}
        log(f"    codes {codes}; equal to the twin's; two calls equal")
        if name[0].isdigit():
            nbytes, ops = fused_work(res)
            kf_times[name] = {
                "ms": time_ms(f"K2F {name}",
                              lambda: reduce.track_reduce_cuda(*args)),
                "plain_ms": time_ms(f"K2F {name} plain",
                                    lambda: reduce.track_reduce_plain(*args),
                                    reps=20),
                "bound_ms": bound_ms(nbytes, ops),
                "bound_by": bound_by(nbytes, ops),
                "bytes": nbytes, "ops": ops}
            log(f"  K2F {name}: {kf_times[name]}")
    k2_threads, k2f_threads = threads_sweep(
        cases, fused_cases, (ref_v, pose, view), k2_times, kf_times)
    return {"k1": {"max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
                   "bound_ms": bound_ms(k1_bytes, k1_ops),
                   "bound_by": bound_by(k1_bytes, k1_ops)},
            "k1f": k1f,
            "k2": {"max_abs_err": k2_err, "by_shape": k2_times,
                   "by_threads": k2_threads},
            "k2f": {"max_abs_err": kf_err, "by_shape": kf_times,
                    "by_threads": k2f_threads},
            # The mesh phase holds K1 and K2F at its shapes on this frame.
            "frame": (fd, lut, maps, pose, view)}


def threads_sweep(cases, fused_cases, ref, k2_times, kf_times):
    """K2 and K2F at 128, 512 and 1024 threads a block (the default 256
    is phase 3's own rows) on the pyramid's three shapes: K2F's result
    codes equal to the twin's, both reductions within K2_TOL, two calls
    bit for bit; each timed. ``ref`` is the reference vertex map, the
    pose and the view. Returns ``{threads: {"max_abs_err", shape: ms}}``
    for K2 and for K2F, 256 included (its error is phase 3's)."""
    from slambench_tpu_torch.ops.hopper import reduce
    from slambench_tpu_torch.tools.mosaic_probe import K2_TOL
    ref_v, pose, view = ref
    k2 = {"256": {k: v["ms"] for k, v in k2_times.items()}}
    k2f = {"256": {k: v["ms"] for k, v in kf_times.items()}}
    for threads in (128, 512, 1024):
        t2 = k2[str(threads)] = {"max_abs_err": 0.0}
        tf = k2f[str(threads)] = {"max_abs_err": 0.0}
        for name, data in cases:
            if name not in k2_times:
                continue
            got = reduce.reduce_track_cuda(data, threads=threads)
            again = reduce.reduce_track_cuda(data, threads=threads)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise RuntimeError(f"K2 {name} at {threads} threads: two "
                                   "calls differ")
            t2["max_abs_err"] = max(t2["max_abs_err"], compare(
                f"K2 reduce {name}, {threads} threads", got,
                reduce.plain(data), K2_TOL))
            t2[name] = time_ms(f"K2 {name} {threads}", lambda: reduce.
                               reduce_track_cuda(data, threads=threads))
        for name, v, n, rn in fused_cases:
            if name not in kf_times:
                continue
            args = (v, n, ref_v, rn, pose, view)
            got, res = reduce.track_reduce_cuda(*args, threads=threads)
            got2, res2 = reduce.track_reduce_cuda(*args, threads=threads)
            want, want_res = reduce.track_reduce_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(res, want_res):
                raise RuntimeError(f"K2F {name} at {threads} threads: "
                                   f"{int((res != want_res).sum())} result "
                                   "codes differ from the twin's")
            if not (torch.equal(got, got2) and torch.equal(res, res2)):
                raise RuntimeError(f"K2F {name} at {threads} threads: two "
                                   "calls differ")
            tf["max_abs_err"] = max(tf["max_abs_err"], compare(
                f"K2F track_reduce {name}, {threads} threads", got, want,
                K2_TOL))
            tf[name] = time_ms(f"K2F {name} {threads}", lambda: reduce.
                               track_reduce_cuda(*args, threads=threads))
    log("  K2 by threads a block (us at 240x320 / 120x160 / 60x80): "
        + "; ".join(f"{t}: " + " / ".join(f"{1e3 * v[k]:.3f}"
                                          for k in k2_times)
                    for t, v in sorted(k2.items(), key=lambda kv:
                                       int(kv[0]))))
    log("  K2F by threads a block (us at 240x320 / 120x160 / 60x80): "
        + "; ".join(f"{t}: " + " / ".join(f"{1e3 * v[k]:.3f}"
                                          for k in kf_times)
                    for t, v in sorted(k2f.items(), key=lambda kv:
                                       int(kv[0]))))
    return k2, k2f


def phase_gathers(dev: torch.device) -> dict:
    """G1-G4 against their plain twins, in every mode, at the gather
    probes' shapes; a gather copies, so the results must be equal (NaN
    where the twin has NaN)."""
    from slambench_tpu_torch.ops.hopper import gather as g
    from slambench_tpu_torch.tools.gather_probe import edge_cases, equal_nan

    log("  G1-G4 vs their plain twins (must be equal)")
    gen = torch.Generator(device=dev).manual_seed(0)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def same(name, got, want, quiet=False):
        torch.cuda.synchronize()
        if not equal_nan(got, want):
            raise RuntimeError(f"{name}: kernel differs from its plain twin")
        if not quiet:
            log(f"    {name}: {tuple(got.shape)} equal")

    t = torch.rand((256, 128), generator=gen, device=dev)
    for mode, hi in (("flat", 256 * 128), ("lane", 128), ("sublane", 256)):
        i = ri(0, hi, (256, 128))
        same(f"G2 {mode} 256x128", g.gather_axis_smem(t, i, mode),
             g.gather_axis_plain(t, i, mode))
        if mode == "flat":
            same("G1 f32 256x128", g.gather_flat(t, i),
                 g.gather_flat_plain(t, i))
    mm = torch.from_numpy(np.random.default_rng(0).integers(
        0, 5000, (240, 320)).astype(np.uint16)).to(dev)
    check_mm2meters("probe image 240x320", mm.to(torch.int32))
    depth = g.mm_to_meters(mm)
    idx = ri(0, 240 * 320, (1024, 2048))
    vi, ui = ri(0, 240, (1024, 2048)), ri(0, 320, (1024, 2048))
    g1 = g.gather_flat(depth, idx, mode="fill")
    same("G1 f32 image 2M", g1, g.gather_flat_plain(depth, idx, mode="fill"))
    same("G1 u16 image 2M", g.gather_flat(mm, idx),
         g.gather_flat_plain(mm, idx))
    g3 = g.gather_smem_u16(mm, idx)
    same("G3 u16 smem 2M", g3, g.gather_u16_plain(mm, idx))
    same("G3 == G1 on the f32 image (bit for bit)", g3, g1)
    same("G4 2-D 2M (staged route)", g.gather_2d(depth, vi, ui),
         g.gather_2d_plain(depth, vi, ui))
    big = torch.rand((720, 1280), generator=gen, device=dev)
    vi7, ui7 = ri(0, 720, (1024, 2048)), ri(0, 1280, (1024, 2048))
    same("G4 2-D 2M, 720x1280 (device memory)", g.gather_2d(big, vi7, ui7),
         g.gather_2d_plain(big, vi7, ui7))
    vol = ri(-32766, 32767, (256 ** 3,)).to(torch.int16)
    for n in (76_800, 256 ** 3):
        inside = ri(0, vol.numel(), (n,))
        outside = ri(-vol.numel() - 1000, vol.numel() + 1000, (n,))
        same(f"G1 int16 volume {n} in range", g.gather_flat(vol, inside),
             g.gather_flat_plain(vol, inside))
        same(f"G1 int16 volume {n} clip", g.gather_flat(vol, outside, True),
             g.gather_flat_plain(vol, outside, True))
    cases = edge_cases(dev)
    before = dict(g.launches)
    for name, kernel, twin in cases:
        same(name, kernel(), twin(), quiet=True)
    idle = [k for k in g.launches if g.launches[k] == before[k]]
    if idle:
        raise RuntimeError(f"edge cases launched no {idle}")
    flat_i = ri(0, t.numel(), (256, 128))
    want = g.gather_axis_plain(t, flat_i, "flat")
    outs = [g.gather_axis_smem(t, flat_i, "flat") for _ in range(50)]
    torch.cuda.synchronize()
    if not all(torch.equal(o, want) for o in outs):
        raise RuntimeError("G2 flat: 50 back-to-back launches differ")
    log(f"    {len(cases)} edge cases of G1-G4 equal (both G4 routes "
        f"launched); 50 G2 flat launches back to back equal")
    return {k: 0.0 for k in g.launches}


def reset_launches() -> None:
    from slambench_tpu_torch.ops.hopper import bilateral, reduce
    bilateral.launches = 0
    bilateral.fused_launches = 0
    reduce.launches = 0
    reduce.fused_launches = 0


def frame_launches() -> dict:
    from slambench_tpu_torch.ops.hopper import bilateral, reduce
    return {"K1": bilateral.launches, "K1F": bilateral.fused_launches,
            "K2": reduce.launches, "K2F": reduce.fused_launches}


def check_frame_launches(launches: dict, frames: int, what: str) -> None:
    """K1F once a frame, K2F once an ICP iteration (-r 1: every frame
    tracks), the metre-in K1 and the unfused K2 never."""
    want = {"K1": 0, "K1F": frames, "K2": 0, "K2F": sum(PYRAMID) * frames}
    if launches != want:
        raise RuntimeError(f"{what}: launches {launches}, expected {want}")


def run_cli(man: dict, dev: torch.device, log_path: str, extra=(),
            **kw) -> dict:
    from slambench_tpu_torch.config import parse_args
    from slambench_tpu_torch.frontend.benchmark import run
    config = parse_args(["-i", man["raw"], "-o", log_path, *CLI_ARGS,
                         *extra])
    summary = run(config, dev, quiet=True, **kw)
    torch.cuda.synchronize()
    return summary


def grey_levels_agree(name: str, got: torch.Tensor,
                      want: torch.Tensor) -> float:
    """Share of pixels of two uint8 images within one grey level; fails
    below 99.9%."""
    if got.dtype != torch.uint8 or got.shape != want.shape:
        raise RuntimeError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                           f"{want.dtype} {tuple(want.shape)}")
    d = (got.cpu().to(torch.int32) - want.cpu().to(torch.int32)).abs()
    share = float((d.amax(dim=-1) <= 1).float().mean())
    if share < 0.999:
        raise RuntimeError(f"{name}: only {share:.5f} of pixels within one "
                           "grey level of the CPU's")
    log(f"  {name} card vs CPU: {share:.6f} of {d.shape[0] * d.shape[1]} "
        f"pixels within 1 grey level (max {int(d.max())})")
    return share


def check_renders(kf, state) -> dict:
    """The final state's images on the card against a CPU copy's, and
    the min-mip render route against the oracle route on the card."""
    from slambench_tpu_torch import params
    from slambench_tpu_torch.geometry import (
        get_inverse_camera_matrix, mat4mul,
    )
    from slambench_tpu_torch.ops.render import (
        render_depth, render_normal, render_track, render_volume,
    )
    out = {}
    for name, fn, leaf in (("render_depth", render_depth, "float_depth"),
                           ("render_track", render_track, "track_result"),
                           ("render_normal", render_normal, "ref_normal")):
        x = getattr(state, leaf)
        out[name] = grey_levels_agree(name, fn(x), fn(x.cpu()))
    view = mat4mul(state.pose, get_inverse_camera_matrix(kf._k))
    args = (state.tsdf, kf.volume_dimensions, view, (kf.H, kf.W),
            params.NEAR_PLANE, params.FAR_PLANE * 2.0, kf.step, 0.75 * kf.mu)
    hits = {}
    for route, mip in (("oracle", None), ("mip", state.mip)):
        img = render_volume(*args, mip=mip)
        torch.cuda.synchronize()
        hits[route] = img[..., :3].amax(dim=-1) > 0
    n_oracle = int(hits["oracle"].sum())
    lost = int((hits["oracle"] & ~hits["mip"]).sum())
    added = int((hits["mip"] & ~hits["oracle"]).sum())
    if n_oracle == 0 or lost > MIP_LOST_SHARE * n_oracle:
        raise RuntimeError(f"render_volume: the mip route lost {lost} of "
                           f"the oracle route's {n_oracle} hits")
    log(f"  render_volume on the card: oracle {n_oracle} hits, mip route "
        f"lost {lost} and added {added}")
    out.update(volume_oracle_hits=n_oracle, volume_mip_lost=lost,
               volume_mip_added=added)
    return out


def reader_ms(path: str, dev: torch.device) -> dict:
    """ms a frame to read the clip and upload each frame as int32 (what
    ``KFusion.to_device`` does), through the native and the numpy
    reader, best of three passes each."""
    from slambench_tpu_torch.io.readers import (
        NativeBackedRawReader, RawDepthReader,
    )
    out = {}
    for name, cls in (("native", NativeBackedRawReader),
                      ("numpy", RawDepthReader)):
        best = float("inf")
        for _ in range(3):
            rd, n = cls(path), 0
            t0 = time.perf_counter()
            while (d := rd.read_next_depth_frame()) is not None:
                torch.from_numpy(np.ascontiguousarray(d, np.int32)).to(dev)
                n += 1
            torch.cuda.synchronize()
            best = min(best, 1e3 * (time.perf_counter() - t0) / n)
        out[name] = best
    return out


def phase_main_path(dev: torch.device, man: dict, work: str) -> dict:
    from slambench_tpu_torch.eval.check_pos import (
        compute_ate, load_gt_trajectory, parse_benchmark_log,
    )

    log(f"[4/17 main path] traj2-like clip, {N_FRAMES} frames 640x480, "
        f"CLI {' '.join(CLI_ARGS)}")
    from slambench_tpu_torch.ops import raycast_fast

    log_path = os.path.join(work, "benchmark.log")
    reset_launches()
    raycast_fast.reset_counters()
    t0 = time.monotonic()
    summary = run_cli(man, dev, log_path)
    wall = time.monotonic() - t0
    launches = frame_launches()
    march = dict(raycast_fast.march_counts,
                 calls=raycast_fast.march_calls,
                 substeps=raycast_fast.march_substeps)

    logd = parse_benchmark_log(log_path)
    ate = compute_ate(logd, load_gt_trajectory(man["gt"]))["ATE"]
    tracked = logd["tracked"].astype(int)
    n = summary["frames"]
    state = summary["state"]
    for name in ("ref_vertex", "ref_normal", "pose"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise RuntimeError(f"state.{name} holds non-finite values")
    if tuple(state.tsdf.shape) != (VOLUME,) * 3 \
            or state.tsdf.dtype != torch.int16:
        raise RuntimeError(f"tsdf {tuple(state.tsdf.shape)} {state.tsdf.dtype}")
    if n != N_FRAMES:
        raise RuntimeError(f"ran {n} frames, expected {N_FRAMES}")
    if not tracked[5:].all():
        raise RuntimeError(f"untracked frames >= 5: "
                           f"{np.nonzero(tracked[5:] == 0)[0] + 5}")
    if not ate.mean() < ATE_MEAN_BOUND:
        raise RuntimeError(f"ATE mean {ate.mean():.5f} m >= {ATE_MEAN_BOUND}")
    check_frame_launches(launches, n, "main path")
    rendering = logd["rendering"]
    if not (rendering > 0).all():
        raise RuntimeError(f"rendering column 0 at frames "
                           f"{np.nonzero(rendering <= 0)[0]}")
    if not (logd["total"] >= logd["computation"] + rendering).all():
        raise RuntimeError("total < computation + rendering on some frame")

    steady = slice(5, None)
    ms = {k: 1e3 * float(np.mean(np.asarray(summary[k])[steady]))
          for k in ("preprocessing", "tracking", "integration",
                    "raycasting", "rendering", "computation", "total")}
    comp = 1e3 * np.asarray(summary["computation"])[steady]
    volume = np.arange(n) % RENDERING_RATE == 0
    rend = 1e3 * np.asarray(summary["rendering"])
    ms.update(computation_median=float(np.median(comp)),
              computation_p90=float(np.percentile(comp, 90)),
              steady_frames=int(comp.size),
              computation_all_frames=1e3 * float(np.mean(
                  summary["computation"])),
              rendering_with_volume=float(rend[volume].mean()),
              rendering_without_volume=float(rend[~volume].mean()),
              rendering_frames_with_volume=int(volume.sum()))
    from slambench_tpu_torch.io.readers import make_reader
    reader = type(make_reader(man["raw"])).__name__
    if reader != "NativeBackedRawReader":
        raise RuntimeError(f"the CLI's .raw reader is {reader}")
    acq = 1e3 * logd["acquisition"]
    ms.update(acquisition_native_mean=float(acq[steady].mean()),
              acquisition_native_median=float(np.median(acq[steady])))
    readers = reader_ms(man["raw"], dev)
    log(f"  ATE mean {ate.mean():.5f} m, max {ate.max():.5f} m; tracked "
        f"{int(tracked.sum())}/{n}; launches {launches}; run {wall:.2f} s")
    log("  steady-state (frames 5..) ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items()))
    log(f"  reader {reader}; read + upload ms a frame: native "
        f"{readers['native']:.4f}, numpy {readers['numpy']:.4f}")
    log(f"  min-mip marches (raycasts and volume renders), two-phase: "
        f"{json.dumps(march)}")
    renders = check_renders(summary["kfusion"], state)
    return {"launches": launches, "march": march,
            "ate_mean": float(ate.mean()),
            "ate_max": float(ate.max()), "ms": ms, "renders": renders,
            "reader": reader, "reader_ms": readers,
            "positions": np.stack([logd["X"], logd["Y"], logd["Z"]], 1),
            "final_pose": state.pose.cpu().numpy(),
            "raycasting_s": np.asarray(summary["raycasting"]),
            "ate_by_frame": ate}


def scan_contract(what: str, pos, pos_ref, tracked, tracked_ref,
                  integrated, integrated_ref, tsdf, tsdf_ref) -> dict:
    """JAX's contract between a batched route and per-frame dispatch
    (tests/test_pipeline_e2e.py:88-137): positions within
    SCAN_POS_TOL, tracked and integrated equal, under 2% of voxels
    differ at all and under 1e-4 by more than 2 LSB."""
    d_pos = float(np.abs(np.asarray(pos) - np.asarray(pos_ref)).max())
    d = (tsdf.to(torch.int32) - tsdf_ref.to(torch.int32)).abs()
    differ = float((d > 0).float().mean())
    beyond = float((d > 2).float().mean())
    same_flags = (np.array_equal(tracked, tracked_ref)
                  and np.array_equal(integrated, integrated_ref))
    log(f"  {what}: positions at most {d_pos:.3e} m apart, tracked and "
        f"integrated {'equal' if same_flags else 'DIFFER'}, voxels "
        f"differing {differ:.3e} (beyond 2 LSB {beyond:.3e})")
    if d_pos > SCAN_POS_TOL or not same_flags or differ >= 0.02 \
            or beyond >= 1e-4:
        raise RuntimeError(f"{what}: outside JAX's scan contract")
    return {"max_position_diff": d_pos, "voxels_differing": differ,
            "voxels_beyond_2lsb": beyond}


def trace_idle_share(trace_dir: str) -> dict:
    """Busy time (the union of the device events' intervals) and idle
    share of the device lane between its first and last event, from the
    Chrome trace of the KERNEL_TIMINGS=xprof route."""
    from slambench_tpu_torch.eval import xprof2log
    spans = []
    for path in xprof2log.find_trace_files(trace_dir):
        trace = xprof2log.load_trace(path)
        pids = xprof2log.device_pids(trace)
        spans += [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
                  for ev in trace["traceEvents"]
                  if ev.get("ph") == "X" and ev.get("pid") in pids
                  and ev.get("dur", 0) > 0]
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = max(b for _, b in spans) - min(a for a, _ in spans)
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / span}


def scan_routes(dev: torch.device, man: dict) -> dict:
    """Phase 5 (a), (b), the replay half of (d), and (e), on one
    ``KFusion`` at phase 4's settings (freed on return)."""
    from slambench_tpu_torch.config import parse_args
    from slambench_tpu_torch.frontend.benchmark import make_kfusion
    from slambench_tpu_torch.io.readers import RawDepthReader, make_reader
    from slambench_tpu_torch.ops import raycast_fast
    from slambench_tpu_torch.pipeline import frame_gates
    from slambench_tpu_torch.tools.mosaic_probe import K2_TOL

    config = parse_args(["-i", man["raw"], *CLI_ARGS])
    kf = make_kfusion(config, make_reader(config), dev)
    rd = RawDepthReader(man["raw"])
    frames = kf.to_device(np.stack([rd.read_next_depth_frame()
                                    for _ in range(N_FRAMES)]))
    boot = kf.init_state()
    for f in range(5):          # -r 1 and -r 2 gates agree on frames 0-4
        boot = kf.compute_frame(boot, frames[f], **frame_gates(f, 1, 1))

    def per_frame(rate: int, last: int):
        """compute_frame on frames 5..last-1, each fenced and timed."""
        state, pos, tracked, integrated, ms = boot, [], [], [], []
        for f in range(5, last):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = kf.compute_frame(state, frames[f],
                                     **frame_gates(f, 1, rate))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            pos.append(state.pose[:3, 3].cpu().numpy())
            tracked.append(bool(state.tracked))
            integrated.append(bool(state.integrated))
        return state, pos, tracked, integrated, ms

    # (a) the steady-state route.
    raycast_fast.march_calls = raycast_fast.march_substeps = 0
    ref, pos_ref, tr_ref, in_ref, eager_ms = per_frame(1, N_FRAMES)
    substeps = raycast_fast.march_substeps / raycast_fast.march_calls
    raycast_fast.march_substeps = 0
    kf.raycasting(ref, early_exit=False)
    budget = raycast_fast.march_substeps
    state, outs, chunk_ms = boot, [], []
    for c in range(5, N_FRAMES, SCAN_CHUNK):
        before = dict(kf.graphs.launches)
        block = frames[c:min(c + SCAN_CHUNK, N_FRAMES)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, o = kf.compute_frames_scan(state, block)
        torch.cuda.synchronize()
        chunk_ms.append(1e3 * (time.perf_counter() - t0) / block.shape[0])
        n = block.shape[0]
        got = {k: v - before[k] for k, v in kf.graphs.launches.items()}
        if got != {"K1F": n, "K2F": sum(PYRAMID) * n}:
            raise RuntimeError(f"scan chunk of {n}: tally {got}")
        outs.append({k: v.cpu().numpy() for k, v in o.items()})
    cat = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    parity = scan_contract("(a) compute_frames_scan vs compute_frame",
                           cat["pos"], pos_ref, cat["tracked"], tr_ref,
                           cat["integrated"], in_ref, state.tsdf, ref.tsdf)
    exact = all(torch.equal(getattr(state, f), getattr(ref, f))
                for f in ("tsdf", "weight", "mip", "pose", "ref_vertex",
                          "ref_normal", "reduction", "track_result"))
    capture = kf.graphs.captures[0]
    log(f"  (a) every leaf of the final state bit for bit equal: {exact}; "
        f"eager min-mip march {substeps:.2f} substeps a raycast of its "
        f"{budget} budget; per frame: eager compute_frame "
        f"{np.mean(eager_ms):.3f} ms, graph chunks {chunk_ms} ms "
        f"(the first holds the capture {capture['capture_s']:.3f} s + "
        f"instantiate {capture['instantiate_s']:.3f} s)")

    # (b) the rated route at -r 2 (gate period 2), frames 5-20.
    last = 5 + 2 * SCAN_CHUNK
    ref2, pos2, tr2, in2, _ = per_frame(2, last)
    state, outs = boot, []
    for c in range(5, last, SCAN_CHUNK):
        block = frames[c:c + SCAN_CHUNK].reshape(-1, 2, *frames.shape[1:])
        state, o = kf.compute_frames_scan_rated(
            state, block, tracking_rate=1, integration_rate=2, phase=c % 2)
        outs.append({k: v.cpu().numpy() for k, v in o.items()})
    cat = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    if not np.array_equal(cat["integrated"], np.arange(5, last) % 2 == 0):
        raise RuntimeError(f"(b) integrated {cat['integrated']}")
    rated = scan_contract("(b) compute_frames_scan_rated -r 2 vs "
                          "compute_frame", cat["pos"], pos2, cat["tracked"],
                          tr2, cat["integrated"], in2, state.tsdf, ref2.tsdf)

    # (d, second half) one replay against the eager scan_step.
    eager = kf.scan_step(boot, frames[5])
    replayed, _ = kf.compute_frames_scan(boot, frames[5:6])
    same = {k: torch.equal(getattr(eager, k).view(torch.int32),
                           getattr(replayed, k).view(torch.int32))
            for k in ("reduction", "track_result")}
    if not same["track_result"]:
        raise RuntimeError("(d) the replay's result codes differ from the "
                           "eager scan_step's")
    if not same["reduction"]:
        compare("(d) replay vs eager scan_step reduction",
                replayed.reduction, eager.reduction, K2_TOL)
    log(f"  (d) one replay vs the eager scan_step from the same state: "
        f"reduction {'bit for bit' if same['reduction'] else 'within K2_TOL'}"
        f", track_result bit for bit")

    # (e) no host read in the step.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kf.scan_step(boot, frames[5])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("  (e) one eager scan_step under sync debug mode \"error\": no "
        "host read")
    return {"parity": parity, "exact": exact, "rated": rated,
            "march_substeps": substeps, "march_budget": budget,
            "eager_ms": float(np.mean(eager_ms)),
            "chunk_ms": chunk_ms, "capture": capture,
            "replay_vs_eager": same}


def phase_scan(dev: torch.device, man: dict, work: str, main: dict) -> dict:
    """--scan-chunk on the card: (a) compute_frames_scan in chunks of
    SCAN_CHUNK against per-frame compute_frame from one boot state; (b)
    the rated route at -r 2; (c) the CLI with --fused --scan-chunk 8;
    (d) K1F and K2F inside the replays, from a KERNEL_TIMINGS=xprof trace
    and from the route's tally, and one replay against the eager
    scan_step; (e) one eager scan_step under sync debug mode "error"."""
    from slambench_tpu_torch.eval.check_pos import (
        compute_ate, load_gt_trajectory, parse_benchmark_log,
    )

    log(f"[5/17 scan] traj2-like clip, {N_FRAMES} frames, chunks of "
        f"{SCAN_CHUNK}: CUDA graph replays against per-frame dispatch")
    result = scan_routes(dev, man)
    torch.cuda.empty_cache()

    # (c) the CLI.
    log_path = os.path.join(work, "scan.log")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    summary = run_cli(man, dev, log_path, fused=True, scan_chunk=SCAN_CHUNK)
    peak = torch.cuda.max_memory_allocated()
    counters = frame_launches()
    graphs = summary["kfusion"].graphs
    logd = parse_benchmark_log(log_path)
    ate = compute_ate(logd, load_gt_trajectory(man["gt"]))["ATE"]
    n = summary["frames"]
    batched = n - 4                     # frames 4.. run in chunks
    if n != N_FRAMES or not logd["tracked"][4:].all():
        raise RuntimeError(f"(c) {n} frames, tracked {logd['tracked']}")
    if not ate.mean() < ATE_MEAN_BOUND:
        raise RuntimeError(f"(c) ATE mean {ate.mean():.5f} m >= "
                           f"{ATE_MEAN_BOUND}")
    if graphs.launches != {"K1F": batched, "K2F": sum(PYRAMID) * batched}:
        raise RuntimeError(f"(c) replay tally {graphs.launches}")
    # Eager launches: the 4 per-frame boot frames and the one warm-up.
    check_frame_launches(counters, 5, "(c) eager launches")
    comp = 1e3 * np.asarray(summary["computation"])
    ms = {"computation_mean": float(comp[5:].mean()),
          "computation_median": float(np.median(comp[5:])),
          "computation_p90": float(np.percentile(comp[5:], 90)),
          "computation_mean_after_first_chunk":
              float(comp[4 + SCAN_CHUNK:].mean()),
          "rendering_mean": 1e3 * float(np.mean(summary["rendering"][5:])),
          "total_mean": 1e3 * float(np.mean(summary["total"][5:]))}
    cap = graphs.captures[0]
    log(f"  (c) --fused --scan-chunk {SCAN_CHUNK}: ATE mean "
        f"{ate.mean():.5f} m, max {ate.max():.5f} m; tracked "
        f"{int(logd['tracked'].sum())}/{n}; replay tally {graphs.launches}"
        f", eager launches (boot, warm-up) {counters}")
    log("  (c) ms a frame (frames 5..): " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items())
        + f"; phase 4 (phased, same call): computation mean "
        f"{main['ms']['computation']:.3f}, median "
        f"{main['ms']['computation_median']:.3f}, p90 "
        f"{main['ms']['computation_p90']:.3f}")
    log(f"  (c) capture {cap['capture_s']:.3f} s, instantiate "
        f"{cap['instantiate_s']:.3f} s; max_memory_allocated with the "
        f"graph {peak / 2 ** 30:.3f} GiB")

    # (d) K1F and K2F inside the replays of one traced chunk.
    err = io.StringIO()
    os.environ["KERNEL_TIMINGS"] = "xprof"
    tempfile.tempdir = work             # the trace's directory goes there
    try:
        with contextlib.redirect_stderr(err):
            xs = run_cli(man, dev, os.path.join(work, "xprof.log"),
                         fused=True, scan_chunk=SCAN_XPROF_CHUNK,
                         max_frames=4 + 2 * SCAN_XPROF_CHUNK)
    finally:
        del os.environ["KERNEL_TIMINGS"]
        tempfile.tempdir = None
    lines = [l.split() for l in err.getvalue().splitlines()]
    events = [(p[0], float(p[1])) for p in lines
              if len(p) == 2 and p[1].replace(".", "", 1).isdigit()]
    traced = {"K1F": sum("mm2m_bilateral_kernel" in e for e, _ in events),
              "K2F": sum("track_reduce_kernel" in e for e, _ in events)}
    want = {"K1F": SCAN_XPROF_CHUNK, "K2F": sum(PYRAMID) * SCAN_XPROF_CHUNK}
    summary_line = [l for l in err.getvalue().splitlines()
                    if l.startswith("xprof kernel attribution")]
    log(f"  (d) xprof trace of one {SCAN_XPROF_CHUNK}-frame chunk: "
        f"{len(events)} device events ({len(events) / SCAN_XPROF_CHUNK:.0f}"
        f" a frame); K1F/K2F in it {traced}, tally of the run "
        f"{xs['kfusion'].graphs.launches}; {summary_line}")
    if traced != want:
        raise RuntimeError(f"(d) traced K1F/K2F {traced}, expected {want}")
    k_ns = {k: float(np.mean([ns for e, ns in events if key in e]))
            for k, key in (("K1F", "mm2m_bilateral_kernel"),
                           ("K2F", "track_reduce_kernel"))}
    busy_ms = sum(ns for _, ns in events) / 1e6 / SCAN_XPROF_CHUNK
    idle = trace_idle_share(summary_line[0].rsplit("(", 1)[1].rstrip(")"))
    by_name: dict = {}
    for e, ns in events:
        by_name[e] = by_name.get(e, 0.0) + ns / 1e6 / SCAN_XPROF_CHUNK
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log("  (d) top device time a replayed frame (ms, under the profiler): "
        + "; ".join(f"{name[:70]} {ms:.3f}" for name, ms in top))
    log(f"  (d) traced kernel means: K1F {k_ns['K1F']:.0f} ns, K2F "
        f"{k_ns['K2F']:.0f} ns; device events sum {busy_ms:.3f} ms a "
        f"frame; device lane {idle['span_ms']:.3f} ms from first to last "
        f"event, busy {idle['busy_ms']:.3f} ms, idle share "
        f"{idle['idle_share']:.4f} (under the profiler)")
    return {**result,
            "cli": {"ate_mean": float(ate.mean()), "ate_max": float(ate.max()),
                    "ms": ms, "peak_gib": peak / 2 ** 30,
                    "capture_s": cap["capture_s"],
                    "instantiate_s": cap["instantiate_s"],
                    "tally": dict(graphs.launches), "counters": counters},
            "xprof": {"events": len(events), "traced": traced,
                      "kernel_ns": k_ns, "events_ms_a_frame": busy_ms,
                      "top_ms": dict(top), **idle}}


def phase_resume(dev: torch.device, man: dict, work: str,
                 main: dict) -> dict:
    """Frames 0-14 with --checkpoint, then --resume to frame 29; the
    logged positions (each frame's start pose) of frames 15-29 and the
    final pose must equal phase 4's within RESUME_TOL."""
    from slambench_tpu_torch.eval.check_pos import parse_benchmark_log

    log(f"[6/17 resume] frames 0-{RESUME_AT - 1} with --checkpoint, then "
        f"--resume to frame {N_FRAMES - 1}")
    ck = os.path.join(work, "state.npz")
    rest_log = os.path.join(work, "resumed.log")
    reset_launches()
    run_cli(man, dev, os.path.join(work, "first.log"),
            ["--checkpoint", ck], max_frames=RESUME_AT)
    summary = run_cli(man, dev, rest_log, ["--resume", ck])
    launches = frame_launches()
    check_frame_launches(launches, N_FRAMES, "resume path")
    logd = parse_benchmark_log(rest_log)
    if not np.array_equal(logd["frame"], np.arange(RESUME_AT, N_FRAMES)):
        raise RuntimeError(f"resumed log frames {logd['frame']}")
    pos = np.stack([logd["X"], logd["Y"], logd["Z"]], 1)
    d_pos = float(np.abs(pos - main["positions"][RESUME_AT:]).max())
    d_pose = float(np.abs(summary["state"].pose.cpu().numpy()
                          - main["final_pose"]).max())
    log(f"  largest difference from phase 4: positions {d_pos:.3e} m, "
        f"final pose {d_pose:.3e}; launches {launches}")
    if d_pos > RESUME_TOL or d_pose > RESUME_TOL:
        raise RuntimeError(f"resumed run differs from phase 4: positions "
                           f"{d_pos:.3e} m, final pose {d_pose:.3e}")
    return {"launches": launches, "max_position_diff": d_pos,
            "max_final_pose_diff": d_pose}


def route_iterations(err: str, npix: int) -> list:
    """Executed ICP iterations a frame of the KERNEL_TIMINGS route's
    stderr, coarsest level first: its ``reduce`` rows by size, a frame
    starting at each ``mm2meters`` line."""
    sizes = [npix >> (2 * lv) for lv in reversed(range(len(PYRAMID)))]
    frames = []
    for line in err.splitlines():
        parts = line.split()
        if len(parts) != 3:
            continue
        if parts[0] == "mm2meters":
            frames.append([0] * len(sizes))
        elif parts[0] == "reduce" and frames:
            frames[-1][sizes.index(int(parts[2]))] += 1
    return frames


def timed_route_run(dev: torch.device, man: dict, work: str, name: str,
                    extra: list, bound: float) -> dict:
    """One run of the phased CLI with KERNEL_TIMINGS=1, which takes the
    KERNEL_TIMINGS route (frontend/timed.py): tracked from frame 5, the
    ATE mean under ``bound``, K1 once a frame, K2 once a ``reduce`` row
    (as many as ``track`` and ``updatePose`` rows), K1F and K2F never;
    the log's rows are JAX's (and the render spans)."""
    from slambench_tpu_torch.eval.check_kernels import (
        FUSED_ROWS, JAX_ROWS, aggregate_kernel_log, print_statistics,
    )
    from slambench_tpu_torch.eval.check_pos import (
        compute_ate, load_gt_trajectory, parse_benchmark_log,
    )

    log(f"  ({name}) {' '.join(extra)}, KERNEL_TIMINGS=1")
    log_path = os.path.join(work, f"timed_{name}.log")
    err = io.StringIO()
    reset_launches()
    os.environ["KERNEL_TIMINGS"] = "1"
    try:
        with contextlib.redirect_stderr(err):
            summary = run_cli(man, dev, log_path, extra)
    finally:
        del os.environ["KERNEL_TIMINGS"]
    launches = frame_launches()
    err = err.getvalue()
    n = summary["frames"]
    logd = parse_benchmark_log(log_path)
    ate = compute_ate(logd, load_gt_trajectory(man["gt"]))["ATE"]
    tracked = logd["tracked"].astype(int)
    agg = aggregate_kernel_log(err.splitlines())
    counts = {k: int(v.size) for k, v in agg.items()}
    table = io.StringIO()
    print_statistics(agg, table)
    log("    KERNEL_TIMINGS (ns, host clock around each fenced dispatch, "
        "all frames):")
    for line in table.getvalue().splitlines():
        log("      " + line)
    failures = []
    if n != N_FRAMES or not tracked[5:].all():
        failures.append(f"{n} frames, untracked frames >= 5: "
                        f"{np.nonzero(tracked[5:] == 0)[0] + 5}")
    if not ate.mean() < bound:
        failures.append(f"ATE mean {ate.mean():.5f} m >= {bound}")
    want = {"K1": n, "K1F": 0, "K2": counts.get("reduce", -1), "K2F": 0}
    if launches != want or not (counts.get("reduce") == counts.get("track")
                                == counts.get("updatePose")):
        failures.append(f"launches {launches}, expected {want}; rows "
                        f"{counts}")
    render = {"renderDepth", "renderTrack", "renderVolume"}
    if set(agg) - render != set(JAX_ROWS) or set(FUSED_ROWS) & set(agg):
        failures.append(f"rows {sorted(agg)}, expected JAX's "
                        f"{list(JAX_ROWS)} and the render spans")
    fixed = {"mm2meters": n, "bilateralFilter": n, "checkPose": n,
             "raycast": n - 3}
    if {k: counts.get(k) for k in fixed} != fixed:
        failures.append(f"rows {counts}, expected {fixed}")
    kf = summary["kfusion"]
    npix = kf.H * kf.W
    iters = route_iterations(err, npix)
    if failures:
        raise RuntimeError(f"timed route ({name}): " + "; ".join(failures))
    steady = slice(5, None)
    ms = {k: 1e3 * float(np.mean(np.asarray(summary[k])[steady]))
          for k in ("rendering", "computation", "total")}
    comp = 1e3 * np.asarray(summary["computation"])[steady]
    ms.update(computation_median=float(np.median(comp)),
              computation_p90=float(np.percentile(comp, 90)))
    reduce_us = {}
    sizes = {npix >> (2 * lv): f"{kf.H >> lv}x{kf.W >> lv}"
             for lv in range(len(PYRAMID))}
    for line in err.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[0] == "reduce":
            reduce_us.setdefault(sizes[int(parts[2])], []).append(
                1e-3 * float(parts[1]))
    rows_us = {"bilateralFilter": 1e-3 * float(agg["bilateralFilter"].mean()),
               "reduce": {k: float(np.mean(v)) for k, v in reduce_us.items()},
               "track": 1e-3 * float(agg["track"].mean()),
               "updatePose": 1e-3 * float(agg["updatePose"].mean()),
               "raycast": 1e-3 * float(agg["raycast"].mean())}
    per_frame = [sum(f) for f in iters]
    log(f"    ATE mean {ate.mean():.5f} m, max {ate.max():.5f} m; tracked "
        f"{int(tracked.sum())}/{n}; launches {launches}")
    log("    steady-state (frames 5..) ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items()))
    log(f"    fenced row means (us): {json.dumps(rows_us)}")
    log(f"    executed ICP iterations a frame (of {sum(PYRAMID)}): mean "
        f"{np.mean(per_frame[4:]):.2f} over frames 4..; coarse/mid/fine "
        f"by frame: {iters}")
    return {"launches": launches, "ate_mean": float(ate.mean()),
            "ate_max": float(ate.max()), "ms": ms, "rows_us": rows_us,
            "iterations": iters,
            "iterations_mean_steady": float(np.mean(per_frame[4:])),
            "kernel_mean_ns": {k: float(v.mean()) for k, v in agg.items()},
            "kernel_count": counts}


def phase_timed_route(dev: torch.device, man: dict, work: str) -> dict:
    """The KERNEL_TIMINGS route at full size, (a) on ``fast`` (every
    raycast past frame 2 warm-started) and (b) on ``jnp`` with the cv
    warm start; K1 and K2 are its ``bilateralFilter`` and ``reduce``
    dispatches."""
    log("[7/17 KERNEL_TIMINGS route] frontend/timed.py through the phased "
        "CLI with KERNEL_TIMINGS=1 on the traj2-like clip")
    return {"fast": timed_route_run(dev, man, work, "fast",
                                    ["--backend", "fast"], ATE_MEAN_BOUND),
            "jnp_cv": timed_route_run(dev, man, work, "jnp_cv",
                                      ["--backend", "jnp", "--motion-model",
                                       "cv"], CV_ATE_MEAN_BOUND)}


def write_scene_dir(man: dict, scene_dir: str, n: int) -> list:
    """The clip's first ``n`` RAW frames as an ICL-NUIM scene directory:
    ASCII euclidean ray lengths in metres (the millimetres over the
    inverse planar factor of ``SCENE_K``), ``scene_00_%04d.depth``.
    Returns the RAW frames."""
    from slambench_tpu_torch.io.readers import (
        SCENE_K, SCENE_SIZE, RawDepthReader,
    )
    w, h = SCENE_SIZE
    fx, fy, cx, cy = SCENE_K
    u = np.arange(w, dtype=np.float64)[None, :]
    v = np.arange(h, dtype=np.float64)[:, None]
    planar = 1.0 / np.sqrt(((u - cx) / fx) ** 2 + ((v - cy) / fy) ** 2 + 1)
    rd = RawDepthReader(man["raw"])
    if rd.get_input_size() != (w, h):
        raise RuntimeError(f"clip is {rd.get_input_size()}, the scene "
                           f"format {w}x{h}")
    os.makedirs(scene_dir)
    frames = []
    for f in range(n):
        mm = np.array(rd.read_next_depth_frame())
        frames.append(mm)
        euclid = mm.astype(np.float64) / 1000.0 / planar
        np.savetxt(os.path.join(scene_dir, "scene_00_%04d.depth" % f),
                   euclid, fmt="%.6f")
    return frames


def stat_line(err: str, key: str) -> dict:
    """One series of a ``print_all_data`` block: mean, min, max, n."""
    for line in err.splitlines():
        parts = line.split()
        if parts and parts[0] == key and "mean:" in parts:
            return {"mean": float(parts[parts.index("mean:") + 1]),
                    "min": float(parts[parts.index("min:") + 1]),
                    "max": float(parts[parts.index("max:") + 1]),
                    "n": int(parts[parts.index("n:") + 1])}
    raise RuntimeError(f"--stats: no {key} series in the stats block")


def fused_spans_run(dev: torch.device, man: dict, work: str) -> dict:
    """The first SPANS_FRAMES frames with ``--fused --backend jnp
    --motion-model cv`` and KERNEL_TIMINGS=1: the production step (the
    oracle march, the cv warm start) under the spans of utils/timers.py;
    K1F once a frame and K2F once an ICP iteration, tracked from frame
    5, the ATE mean under CV_ATE_MEAN_BOUND."""
    from slambench_tpu_torch.eval.check_kernels import aggregate_kernel_log
    from slambench_tpu_torch.eval.check_pos import (
        compute_ate, load_gt_trajectory, parse_benchmark_log,
    )
    log_path = os.path.join(work, "fused_spans.log")
    err = io.StringIO()
    reset_launches()
    os.environ["KERNEL_TIMINGS"] = "1"
    try:
        with contextlib.redirect_stderr(err):
            run_cli(man, dev, log_path, ["--backend", "jnp",
                                         "--motion-model", "cv"],
                    fused=True, max_frames=SPANS_FRAMES)
    finally:
        del os.environ["KERNEL_TIMINGS"]
    launches = frame_launches()
    check_frame_launches(launches, SPANS_FRAMES, "--fused spans path")
    logd = parse_benchmark_log(log_path)
    ate = compute_ate(logd, load_gt_trajectory(man["gt"]))["ATE"]
    tracked = logd["tracked"].astype(int)
    if not tracked[5:].all() or not ate.mean() < CV_ATE_MEAN_BOUND:
        raise RuntimeError(f"--fused jnp + cv: tracked {tracked.tolist()}, "
                           f"ATE mean {ate.mean():.5f} m (bound "
                           f"{CV_ATE_MEAN_BOUND})")
    agg = aggregate_kernel_log(err.getvalue().splitlines())
    comp = 1e3 * logd["computation"][5:]
    log(f"  (c) --fused jnp + cv spans run, frames 0-{SPANS_FRAMES - 1}: "
        f"ATE mean {ate.mean():.5f} m, tracked {int(tracked.sum())}/"
        f"{SPANS_FRAMES}, launches {launches}, computation "
        f"{comp.mean():.3f} ms a frame (frames 5..)")
    return {"launches": launches, "ate_mean": float(ate.mean()),
            "computation_ms": float(comp.mean()),
            "kernel_mean_ns": {k: float(v.mean()) for k, v in agg.items()},
            "kernel_count": {k: int(v.size) for k, v in agg.items()}}


def phase_inputs(dev: torch.device, man: dict, work: str, main: dict,
                 route: dict, kernels: dict, smi: str) -> dict:
    """(a) the scene and .scf inputs through the CLI with --stats,
    --debug-nans, --report-device and --break-at-frame; (b) the warm
    start against phase 4; (c) the KERNEL_TIMINGS row sets of phase 7's
    route and of a --fused spans run, and both routes' kernel rows
    beside phase 3's kernel times."""
    from slambench_tpu_torch.eval.check_kernels import missing_rows
    from slambench_tpu_torch.eval.check_pos import (
        compute_ate, load_gt_trajectory, parse_benchmark_log,
    )
    from slambench_tpu_torch.frontend import benchmark
    from slambench_tpu_torch.io.readers import (
        RawDepthReader, SceneDepthReader,
    )
    from slambench_tpu_torch.tools import scene2raw

    log(f"[8/17 inputs and observation] (a) {SCENE_FRAMES} frames as an "
        f"ICL-NUIM scene + .scf, --stats --debug-nans --report-device "
        f"--break-at-frame {SCENE_BREAK_AT}")
    t0 = time.monotonic()
    scene_dir = os.path.join(work, "scene")
    raw_frames = write_scene_dir(man, scene_dir, SCENE_FRAMES)
    written = time.monotonic() - t0
    # scene2raw's native path (the default) within 1 LSB of the scene
    # reader (test_scene2raw.py's contract; these depths are whole
    # millimetres over the planar factor, so truncation after division
    # and after multiplication part on more pixels than there) and 1 mm
    # of the RAW frames; its numpy path (SLAMBENCH_NATIVE_IO=0) equal to
    # the reader.
    conv, conv_np = (os.path.join(work, f) for f in ("scene.raw",
                                                     "scene_np.raw"))
    t0 = time.monotonic()
    n_conv = scene2raw.convert(scene_dir, conv, verbose=False)
    native_s = time.monotonic() - t0
    os.environ["SLAMBENCH_NATIVE_IO"] = "0"
    try:
        t0 = time.monotonic()
        n_np = scene2raw.convert(scene_dir, conv_np, verbose=False)
        numpy_s = time.monotonic() - t0
    finally:
        del os.environ["SLAMBENCH_NATIVE_IO"]
    if n_conv != SCENE_FRAMES or n_np != SCENE_FRAMES:
        raise RuntimeError("scene2raw did not convert every frame")
    sr, cr, nr = (SceneDepthReader(scene_dir), RawDepthReader(conv),
                  RawDepthReader(conv_np))
    worst = lsb = 0
    same = []
    for f, want in enumerate(raw_frames):
        got = sr.read_next_depth_frame()
        conv_f = cr.read_next_depth_frame().astype(np.int64)
        worst = max(worst, int(np.abs(got.astype(np.int64) - want).max()),
                    int(np.abs(conv_f - want).max()))
        lsb = max(lsb, int(np.abs(conv_f - got).max()))
        same.append(float(np.mean(conv_f == got)))
        if not np.array_equal(got, nr.read_next_depth_frame()):
            raise RuntimeError(f"scene reader and scene2raw's numpy path "
                               f"differ at frame {f}")
    if worst > 1 or lsb > 1:
        raise RuntimeError(f"scene reader or scene2raw's native path is "
                           f"{worst} mm from the RAW frames; the native path "
                           f"{lsb} LSB from the reader")
    log(f"  scene written in {written:.2f} s; reader and scene2raw's native "
        f"path within {worst} mm of the RAW frames; reader equal to "
        f"scene2raw's numpy path; scene2raw "
        f"native path within {lsb} LSB (equal on >= {min(same):.6f} of "
        f"pixels); convert {native_s:.3f} s native, {numpy_s:.3f} s numpy "
        f"for {SCENE_FRAMES} frames")

    scf = os.path.join(work, "scene.scf")
    with open(scf, "w") as f:
        f.write(f"input_file = scene\ncamera = {SCENE_CAMERA}\n")
    k = CLI_ARGS.index("-k")
    args = CLI_ARGS[:k] + CLI_ARGS[k + 2:]     # the .scf sets the camera
    scene_log = os.path.join(work, "scene.log")
    err = io.StringIO()
    reset_launches()
    with contextlib.redirect_stderr(err):
        rc = benchmark.main(["--stats", "--debug-nans", "--report-device",
                             "--break-at-frame", str(SCENE_BREAK_AT),
                             "-i", scf, "-o", scene_log, *args])
    torch.cuda.synchronize()
    err = err.getvalue()
    launches = frame_launches()
    if rc != 0:
        raise RuntimeError(f"scene CLI exited {rc}: {err[-2000:]}")
    logd = parse_benchmark_log(scene_log)
    n = SCENE_BREAK_AT + 1
    if not np.array_equal(logd["frame"], np.arange(n)):
        raise RuntimeError(f"scene log rows {logd['frame']}, expected 0-"
                           f"{SCENE_BREAK_AT}")
    check_frame_launches(launches, n, "scene path")
    tracked = logd["tracked"].astype(int)
    if not tracked[4:].all():
        raise RuntimeError(f"scene path: untracked frames >= 4: "
                           f"{np.nonzero(tracked[4:] == 0)[0] + 4}")
    name = torch.cuda.get_device_name(0)
    if f"BREAK: at frame {SCENE_BREAK_AT}" not in err \
            or name not in err or "FloatingPointError" in err:
        raise RuntimeError(f"scene CLI stderr lacks the break, the device "
                           f"report or is a NaN fault: {err[-2000:]}")
    power = stat_line(err, "Power_gpu0")
    energy = stat_line(err, "Energy_gpu0")
    if not (power["n"] == energy["n"] == n and power["min"] > 0
            and energy["mean"] > 0):
        raise RuntimeError(f"NVML rail: power {power}, energy {energy}")
    for line in err.splitlines():
        if line.startswith(("platform:", "  device", "Power_", "Energy_",
                            "computation ")):
            log("    " + line)
    acq = 1e3 * logd["acquisition"]
    scene = {"launches": launches, "frames": n,
             "tracked": int(tracked.sum()),
             "acquisition_ms_mean": float(acq.mean()),
             "acquisition_ms_median": float(np.median(acq)),
             "computation_ms_mean": 1e3 * float(logd["computation"].mean()),
             "power_w_per_frame": power["mean"],
             "energy_j_per_frame": energy["mean"],
             "energy_j_total": energy["mean"] * energy["n"],
             "reader_max_mm": worst, "scene2raw_native_max_lsb": lsb,
             "scene2raw_native_equal_share": min(same),
             "scene2raw_s": {"native": native_s, "numpy": numpy_s},
             "card": smi}
    log(f"  {n} rows, tracked {int(tracked.sum())}/{n}, launches "
        f"{launches}; acquisition {scene['acquisition_ms_mean']:.3f} ms a "
        f"frame (scene reader); power {power['mean']:.3f} W a frame, "
        f"energy {energy['mean']:.4f} J a frame (NVML, {smi})")

    log(f"  (b) frames 0-{WARM_FRAMES - 1} with SLAMBENCH_WARM_START=1")
    reset_launches()
    os.environ["SLAMBENCH_WARM_START"] = "1"
    try:
        summary = run_cli(man, dev, os.path.join(work, "warm.log"),
                          max_frames=WARM_FRAMES)
    finally:
        del os.environ["SLAMBENCH_WARM_START"]
    if not summary["kfusion"].warm_start:
        raise RuntimeError("SLAMBENCH_WARM_START=1 left the warm start off")
    check_frame_launches(frame_launches(), WARM_FRAMES, "warm-start path")
    wlog = parse_benchmark_log(os.path.join(work, "warm.log"))
    pos = np.stack([wlog["X"], wlog["Y"], wlog["Z"]], 1)
    d_frame = np.abs(pos - main["positions"][:WARM_FRAMES]).max(axis=1)
    d_pos = float(d_frame.max())
    gt = load_gt_trajectory(man["gt"])
    ate = compute_ate(wlog, gt)["ATE"]
    ate_main = main["ate_by_frame"][:WARM_FRAMES]
    w_tracked = wlog["tracked"].astype(int)
    # Checked after (c), so that a failure here still reports (c).
    failures = []
    if not w_tracked[5:].all() or not ate.mean() < ATE_MEAN_BOUND:
        failures.append(f"warm start: tracked {w_tracked.tolist()}, ATE "
                        f"mean {ate.mean():.5f} m (bound {ATE_MEAN_BOUND})")
    rc_frames = slice(3, WARM_FRAMES)          # raycast runs on frame > 2
    warm_ms = 1e3 * float(np.mean(np.asarray(summary["raycasting"])
                                  [rc_frames]))
    cold_ms = 1e3 * float(np.mean(main["raycasting_s"][rc_frames]))
    warm = {"max_position_diff": d_pos,
            "position_diff_by_frame": d_frame.tolist(),
            "ate_mean": float(ate.mean()), "ate_max": float(ate.max()),
            "ate_mean_phase4": float(ate_main.mean()),
            "tracked": int(w_tracked.sum()),
            "raycasting_ms_warm": warm_ms, "raycasting_ms_phase4": cold_ms}
    log(f"  tracked {int(w_tracked.sum())}/{WARM_FRAMES}; ATE mean "
        f"{ate.mean():.5f} m (phase 4, same frames: {ate_main.mean():.5f}); "
        f"positions at most {d_pos:.3e} m from phase 4's; raycasting "
        f"frames 3-{WARM_FRAMES - 1}: warm {warm_ms:.3f} ms, phase 4 "
        f"{cold_ms:.3f} ms a frame")

    spans_run = fused_spans_run(dev, man, work)
    missing = {name: missing_rows(r["kernel_mean_ns"]) for name, r in
               (("route fast", route["fast"]),
                ("route jnp + cv", route["jnp_cv"]),
                ("--fused spans", spans_run))}
    if any(missing.values()):
        failures.append(f"KERNEL_TIMINGS logs lack JAX rows: {missing}")
    spans = {"K1F": spans_run["kernel_mean_ns"]["mm2meters+bilateralFilter"]
             * 1e-3,
             "K2F": spans_run["kernel_mean_ns"]["track+reduce"] * 1e-3}
    fenced = {f"K1 ({name})": route[key]["rows_us"]["bilateralFilter"]
              for key, name in (("fast", "fast"), ("jnp_cv", "jnp + cv"))}
    fenced.update({f"K2 240x320 ({name})":
                   route[key]["rows_us"]["reduce"]["240x320"]
                   for key, name in (("fast", "fast"),
                                     ("jnp_cv", "jnp + cv"))})
    own = {"K1F": kernels["k1f"]["ms"] * 1e3,
           "K2F": kernels["k2f"]["by_shape"]["240x320"]["ms"] * 1e3,
           "K1": kernels["k1"]["ms"] * 1e3,
           "K2 240x320": kernels["k2"]["by_shape"]["240x320"]["ms"] * 1e3}
    log(f"      JAX rows missing: {missing}; --fused span means K1F "
        f"{spans['K1F']:.2f} us, K2F {spans['K2F']:.2f} us (all levels); "
        f"the route's fenced rows (host clock, launch + synchronize): "
        + ", ".join(f"{k} {v:.2f} us" for k, v in fenced.items())
        + "; beside the kernels' own (phase 3): "
        + ", ".join(f"{k} {v:.3f} us" for k, v in own.items()))
    if failures:
        raise RuntimeError("; ".join(failures))
    return {"scene": scene, "warm_start": warm, "fused_spans": spans_run,
            "span_mean_us": spans, "route_fenced_us": fenced,
            "kernel_us": own}


class KeyframeTally:
    """Counts, for one phase, the ``PoseGraphKFusion.align`` calls and
    the K2F launches made inside them (the alignment's, apart from the
    frame path's): host counters only, no fence and no timing. The
    layer's times come from its KERNEL_TIMINGS spans in a separate run
    (``timed_keyframes``)."""

    def __init__(self):
        self.calls = 0
        self.align_launches = 0

    def __enter__(self):
        from slambench_tpu_torch.models.keyframes import PoseGraphKFusion
        from slambench_tpu_torch.ops.hopper import reduce
        self.saved = PoseGraphKFusion.align

        def counted(*args, **kwargs):
            before = reduce.fused_launches
            out = self.saved(*args, **kwargs)
            self.calls += 1
            self.align_launches += reduce.fused_launches - before
            return out
        PoseGraphKFusion.align = counted
        return self

    def __exit__(self, *exc):
        from slambench_tpu_torch.models.keyframes import PoseGraphKFusion
        PoseGraphKFusion.align = self.saved


def tail_ate(positions: np.ndarray, gt: np.ndarray) -> float:
    """Mean position error over the orbit's second lap."""
    return float(np.linalg.norm(positions - gt, axis=1)[KF_TAIL].mean())


def check_keyframe_launches(launches: dict, tally: KeyframeTally,
                            alignments: int, frames: int, what: str) -> dict:
    """K1F once a frame; K2F 19 times a tracked frame (every frame at
    -r 1) on the frame path plus ALIGN_ITERS times a verified candidate in
    the alignment, split exactly; K1 and K2 never."""
    split = {"frame_path": launches["K2F"] - tally.align_launches,
             "alignment": tally.align_launches}
    want = {"frame_path": sum(PYRAMID) * frames,
            "alignment": ALIGN_ITERS * alignments}
    if split != want or tally.calls != alignments \
            or (launches["K1"], launches["K1F"], launches["K2"]) \
            != (0, frames, 0):
        raise RuntimeError(f"{what}: launches {launches}, K2F split {split}, "
                           f"align calls {tally.calls}; expected "
                           f"K2F {want}, K1F {frames}, K1 = K2 = 0")
    return split


def check_snapshot_k2f(pgkf) -> dict:
    """K2F at the snapshot shape (the alignment's: a keyframe's
    downsampled maps against a candidate's) against its plain twin at
    phase 3's tolerance, two calls bit for bit, then timed."""
    from slambench_tpu_torch.geometry import mat4mul, rigid_inverse
    from slambench_tpu_torch.ops.hopper import reduce
    from slambench_tpu_torch.tools.mosaic_probe import K2_TOL
    from slambench_tpu_torch.tools.timing import bound_by, bound_ms
    kf = pgkf.store.keyframes[-1]
    cands = pgkf.store.loop_candidates(kf) or pgkf.store.keyframes[:1]
    cand = cands[0]
    view = mat4mul(pgkf._K, rigid_inverse(torch.as_tensor(
        cand.pose, device=kf.vertex.device)))
    eye = torch.eye(4, dtype=torch.float32, device=kf.vertex.device)
    args = (kf.vertex, kf.normal, cand.vertex, cand.normal, eye, view)
    got, res = reduce.track_reduce_cuda(*args)
    got2, res2 = reduce.track_reduce_cuda(*args)
    want, want_res = reduce.track_reduce_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(res, want_res):
        raise RuntimeError(f"K2F snapshot: {int((res != want_res).sum())} "
                           "result codes differ from the twin's")
    if not (torch.equal(got, got2) and torch.equal(res, res2)):
        raise RuntimeError("K2F snapshot: two calls differ")
    _, h, w = kf.vertex.shape
    _, H, W = cand.vertex.shape
    shape = f"{h}x{w} against {H}x{W}"
    err = compare(f"K2F track_reduce snapshot {shape} (keyframe {kf.index} "
                  f"onto {cand.index})", got, want, K2_TOL)
    nbytes, ops = fused_work(res)
    out = {"shape": shape, "max_abs_err": err,
           "ms": time_ms("K2F snapshot",
                         lambda: reduce.track_reduce_cuda(*args)),
           "plain_ms": time_ms("K2F snapshot plain",
                               lambda: reduce.track_reduce_plain(*args),
                               reps=20),
           "bound_ms": bound_ms(nbytes, ops),
           "bound_by": bound_by(nbytes, ops),
           "tracked_share": float((res == 1).float().mean())}
    log(f"  K2F snapshot: {out}")
    return out


class Replay:
    """Stands in for KFusion in an offline replay: ``process_frame``
    returns the state recorded for the frame."""

    def __init__(self, camera, device: torch.device, states: list):
        self.camera, self.device = camera, device
        self.states = states

    def process_frame(self, state, depth, frame, tracking_rate=1,
                      integration_rate=2):
        return self.states[frame]


def offline_replay(kfusion, states: list, gt: np.ndarray,
                   store: dict) -> dict:
    """test_ba_backend_beats_posegraph_on_revisit's procedure: one
    odometry pass (the recorded states) into a PoseGraphKFusion that never
    optimizes online, then the pose graph and BA each run offline from
    the same unoptimized graph; their corrected tail ATEs."""
    from slambench_tpu_torch.models.keyframes import (
        KeyframeStore, PoseGraphKFusion,
    )
    slam = PoseGraphKFusion(Replay(kfusion.camera, kfusion.device, states),
                            KeyframeStore(**store),
                            optimize_every=10 ** 9)
    for frame in range(len(states)):
        slam.process_frame(None, None, frame)
    base = [p.copy() for p in slam.graph.poses]
    slam.graph.optimize(n_iters=8)
    pg = tail_ate(slam.corrected_trajectory()[:, :3, 3], gt)
    slam.graph.poses = base
    slam.backend = "ba"
    slam._optimize_ba()
    torch.cuda.synchronize()
    return {"posegraph": pg,
            "ba": tail_ate(slam.corrected_trajectory()[:, :3, 3], gt),
            "keyframes": len(slam.store.keyframes),
            "edges": len(slam.graph.edges)}


def replay_states(pgkf) -> list:
    """The per-frame states a PoseGraphKFusion saw, rebuilt on the host
    from what it keeps: each frame's odometry pose, and at each
    keyframe's frame maps whose strided slice is that keyframe's
    snapshot. The maps of the other frames are never read."""
    s = pgkf.store.downsample

    def full(x: torch.Tensor) -> torch.Tensor:
        c, h, w = x.shape
        out = torch.zeros((c, h * s, w * s), dtype=torch.float32)
        out[:, ::s, ::s] = x.cpu()
        return out

    maps = {kf.frame: (full(kf.vertex), full(kf.normal))
            for kf in pgkf.store.keyframes}
    states = []
    for frame, pose in enumerate(pgkf._trajectory):
        vertex, normal = maps.get(frame, (None, None))
        states.append(types.SimpleNamespace(
            pose=torch.from_numpy(pose), ref_vertex=vertex,
            ref_normal=normal))
    return states


def cpu_witness(pgkf, gt: np.ndarray, what: str) -> dict:
    """A card route's keyframe layer held against the plain route on the
    CPU (K2F's plain twin, the CPU's ``index_add_`` and solves) replayed
    from the card's own odometry and snapshots: the same keyframes, the
    same accepted edges in the same order, and every edge measurement
    and every corrected pose within KF_WITNESS_TOL."""
    from slambench_tpu_torch.models.keyframes import (
        KeyframeStore, PoseGraphKFusion,
    )
    cpu = torch.device("cpu")
    t0 = time.monotonic()
    states = replay_states(pgkf)
    store = pgkf.store
    slam = PoseGraphKFusion(
        Replay(pgkf.kf.camera, cpu, states),
        KeyframeStore(store.trans_threshold, store.rot_threshold,
                      store.downsample),
        optimize_every=pgkf.optimize_every, icp_iters=pgkf.icp_iters,
        backend=pgkf.backend)
    for frame in range(len(states)):
        slam.process_frame(None, None, frame)
    card_kf = [kf.frame for kf in pgkf.store.keyframes]
    cpu_kf = [kf.frame for kf in slam.store.keyframes]
    card_e = [(i, j) for i, j, _T, _w in pgkf.graph.edges]
    cpu_e = [(i, j) for i, j, _T, _w in slam.graph.edges]
    if card_kf != cpu_kf or card_e != cpu_e:
        raise RuntimeError(
            f"{what}: the CPU replay kept keyframes {cpu_kf} and edges "
            f"only on the CPU {sorted(set(cpu_e) - set(card_e))}; the card "
            f"{card_kf} and edges only on the card "
            f"{sorted(set(card_e) - set(cpu_e))}")
    edge_err = max(float(np.abs(a[2] - b[2]).max())
                   for a, b in zip(pgkf.graph.edges, slam.graph.edges))
    weight_err = max(abs(a[3] - b[3])
                     for a, b in zip(pgkf.graph.edges, slam.graph.edges))
    card, plain = pgkf.corrected_trajectory(), slam.corrected_trajectory()
    pos_err = float(np.linalg.norm(card[:, :3, 3] - plain[:, :3, 3],
                                   axis=1).max())
    rot_err = float(np.abs(card[:, :3, :3] - plain[:, :3, :3]).max())
    out = {"edge_T_max_abs_diff": edge_err, "edge_weight_max_diff":
           weight_err, "position_max_diff_m": pos_err,
           "rotation_max_abs_diff": rot_err,
           "tail_ate_corrected_cpu": tail_ate(plain[:, :3, 3], gt),
           "run_s": time.monotonic() - t0}
    log(f"  {what} against its CPU replay (same {len(card_kf)} keyframes, "
        f"same {len(card_e)} edges): {out}")
    if max(edge_err, pos_err, rot_err) > KF_WITNESS_TOL:
        raise RuntimeError(f"{what}: the card's layer is more than "
                           f"{KF_WITNESS_TOL} from its CPU replay: {out}")
    return out


def timed_keyframes(man: dict, dev: torch.device, work: str) -> dict:
    """A separate ``--keyframes --ba`` run with KERNEL_TIMINGS=1, whose
    spans time each candidate's alignment, each pose-graph optimization
    and each bundle adjustment (CUDA events, no fence added); its frame
    times are not reported."""
    from slambench_tpu_torch.eval.check_kernels import aggregate_kernel_log
    err = io.StringIO()
    os.environ["KERNEL_TIMINGS"] = "1"
    try:
        with contextlib.redirect_stderr(err):
            summary = run_cli(man, dev, os.path.join(work, "kf_timed.log"),
                              keyframes=True, ba=True)
    finally:
        del os.environ["KERNEL_TIMINGS"]
    pgkf = summary["posegraph"]
    agg = aggregate_kernel_log(err.getvalue().splitlines())
    spans = {k: 1e-6 * agg.get(k, np.zeros(0))
             for k in ("loopClosureAlign", "poseGraph", "bundleAdjust")}
    calls = {k: int(v.size) for k, v in spans.items()}
    if calls["loopClosureAlign"] != pgkf.alignments or calls["poseGraph"] \
            != calls["bundleAdjust"] or calls["bundleAdjust"] < 1:
        raise RuntimeError(f"timed keyframes run: spans {calls} for "
                           f"{pgkf.alignments} alignments")
    out = {"calls": calls,
           "ms_per_call": {k: float(v.mean()) for k, v in spans.items()},
           "ms_each": {k: [float(x) for x in v]
                       for k, v in spans.items() if k != "loopClosureAlign"}}
    log(f"  timed --keyframes --ba run (KERNEL_TIMINGS spans): {out}")
    return out


def phase_keyframes(dev: torch.device, work: str, main: dict) -> dict:
    """(a) the revisiting orbit at full width through the CLI's run()
    with --keyframes and with --keyframes --ba; (b) the JAX tests' coarse
    setting through PoseGraphKFusion directly."""
    from slambench_tpu_torch.eval.trajectory import read_tum
    from slambench_tpu_torch.io.readers import make_reader
    from slambench_tpu_torch.io.synthetic import generate_dataset
    from slambench_tpu_torch.models.keyframes import (
        KeyframeStore, PoseGraphKFusion,
    )
    from slambench_tpu_torch.pipeline import KFusion

    log(f"[9/17 keyframes] (a) revisiting orbit, {KF_FRAMES} frames 640x480, "
        f"amp {KF_AMP}, period {KF_PERIOD}, CLI {' '.join(CLI_ARGS)} "
        "--keyframes [--ba]")
    man = generate_dataset(os.path.join(work, "orbit"), dev,
                           n_frames=KF_FRAMES, image_size=(640, 480),
                           dim=(4.8, 4.8, 4.8),
                           init_pos_factor=(0.34, 0.5, 0.24), amp=KF_AMP,
                           period=KF_PERIOD)
    gt = np.asarray(man["poses"])[:, :3, 3]
    routes, snapshot = {}, None
    for route, kw in (("posegraph", {"keyframes": True}),
                      ("ba", {"keyframes": True, "ba": True})):
        log_path = os.path.join(work, f"kf_{route}.log")
        err = io.StringIO()
        reset_launches()
        t0 = time.monotonic()
        with KeyframeTally() as tally, contextlib.redirect_stderr(err):
            summary = run_cli(man, dev, log_path, **kw)
        wall = time.monotonic() - t0
        launches = frame_launches()
        pgkf = summary["posegraph"]
        n = summary["frames"]
        split = check_keyframe_launches(launches, tally, pgkf.alignments, n,
                                        f"keyframes {route}")
        raw = read_tum(log_path + ".kf_raw.tum")
        corr = read_tum(log_path + ".kf_corrected.tum")
        if n != KF_FRAMES or raw.shape != (n, 3) or corr.shape != (n, 3):
            raise RuntimeError(f"keyframes {route}: {n} frames, TUM rows "
                               f"{raw.shape} / {corr.shape}")
        loops = sum(1 for (i, j, _T, _w) in pgkf.graph.edges if abs(i - j) > 1)
        if pgkf.backend != route or "keyframes: " not in err.getvalue():
            raise RuntimeError(f"keyframes {route}: backend {pgkf.backend}, "
                               f"stderr {err.getvalue()[-500:]}")
        traj = pgkf.corrected_trajectory()
        rot = traj[:, :3, :3]
        orth = float(np.abs(rot @ rot.transpose(0, 2, 1) - np.eye(3)).max())
        mean_err = float(np.linalg.norm(traj[:, :3, 3] - gt[:n], axis=1)
                         .mean())
        if mean_err >= KF_MEAN_ERR or orth > 1e-4:
            raise RuntimeError(f"keyframes {route}: corrected mean error "
                               f"{mean_err:.5f} m (bound {KF_MEAN_ERR}), "
                               f"rotations {orth:.2e} from orthonormal")
        comp = 1e3 * np.asarray(summary["computation"])
        r = {"frames": n, "keyframes": len(pgkf.store.keyframes),
             "edges": len(pgkf.graph.edges), "loop_closures": loops,
             "alignments": pgkf.alignments, "k2f_split": split,
             "launches": launches,
             "tail_ate_raw": tail_ate(raw, gt[:n]),
             "tail_ate_corrected": tail_ate(corr, gt[:n]),
             "mean_err_corrected": mean_err,
             "computation_ms_mean": float(comp[5:].mean()),
             "computation_ms_median": float(np.median(comp[5:])),
             "computation_ms_max": float(comp.max()),
             "host_reads_per_frame": 1 + pgkf.alignments / n,
             "run_s": wall}
        routes[route] = r
        log(f"  {route}: keyframes {r['keyframes']}, edges {r['edges']} "
            f"({loops} loop closures, {pgkf.alignments} candidates aligned); "
            f"tail ATE (frames {KF_TAIL.start}-{KF_FRAMES - 1}) raw "
            f"{r['tail_ate_raw']:.5f} m, corrected "
            f"{r['tail_ate_corrected']:.5f} m; K2F {split} (frame path = "
            f"{sum(PYRAMID)} x {n} tracked frames, alignment = "
            f"{ALIGN_ITERS} x {pgkf.alignments} candidates); computation "
            f"mean {r['computation_ms_mean']:.3f} ms (frames 5..; phase 4: "
            f"{main['ms']['computation']:.3f}); run {wall:.2f} s")
        r["witness"] = cpu_witness(pgkf, gt[:n], route)
        if route == "posegraph":
            snapshot = check_snapshot_k2f(pgkf)
    timed = timed_keyframes(man, dev, work)
    failures = [f"{k}: no loop closure" for k, r in routes.items()
                if r["loop_closures"] < 1]
    # At this width the odometry drifts less than BA's 7.5 cm landmark
    # cells resolve, and JAX's PoseGraphKFusion on the same states also
    # puts BA behind the graph (tests/compare_keyframes_jax.py;
    # PERF.md), so BA <= graph is held where its contract is defined,
    # in (b); each full-width route is held to its CPU replay instead.
    gap = (routes["ba"]["tail_ate_corrected"]
           - routes["posegraph"]["tail_ate_corrected"])
    log(f"  BA - graph, corrected tail: {gap:+.5f} m (reported; the "
        "contract is held in (b))")

    log("  (b) the JAX tests' coarse setting: 160x120, 48^3, "
        "KeyframeStore(0.08, 0.08), optimize_every=3")
    cman = generate_dataset(os.path.join(work, "orbit_coarse"), dev,
                            n_frames=KF_FRAMES, image_size=(160, 120),
                            dim=(4.8, 4.8, 4.8), amp=KF_AMP,
                            period=KF_PERIOD)
    init = [f * d for f, d in zip(cman["init_pos_factor"], cman["dim"])]
    kf = KFusion((160, 120), (48,) * 3, cman["dim"], init, PYRAMID,
                 cman["camera"], device=dev)
    slam = PoseGraphKFusion(
        kf, KeyframeStore(trans_threshold=0.08, rot_threshold=0.08),
        optimize_every=3)
    reader = make_reader(cman["raw"])
    state = kf.init_state()
    states = []
    reset_launches()
    t0 = time.monotonic()
    with KeyframeTally() as tally:
        for frame in range(KF_FRAMES):
            state = slam.process_frame(state, reader.read_next_depth_frame(),
                                       frame)
            states.append(state)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    split = check_keyframe_launches(frame_launches(), tally, slam.alignments,
                                    KF_FRAMES, "keyframes coarse")
    cgt = np.asarray(cman["poses"])[:, :3, 3]
    coarse = {"reader": type(reader).__name__,
              "keyframes": len(slam.store.keyframes),
              "edges": len(slam.graph.edges),
              "loop_closures": sum(1 for (i, j, _T, _w) in slam.graph.edges
                                   if abs(i - j) > 1),
              "alignments": slam.alignments, "k2f_split": split,
              "tail_ate_raw": tail_ate(np.stack(slam._trajectory)[:, :3, 3],
                                       cgt),
              "tail_ate_corrected": tail_ate(
                  slam.corrected_trajectory()[:, :3, 3], cgt),
              "run_s": wall}
    log(f"  coarse: keyframes {coarse['keyframes']}, edges {coarse['edges']} "
        f"({coarse['loop_closures']} loop closures, {slam.alignments} "
        f"aligned); tail ATE raw {coarse['tail_ate_raw']:.5f} m -> corrected "
        f"{coarse['tail_ate_corrected']:.5f} m (JAX package, CPU: "
        f"{JAX_COARSE_TAIL[0]} -> {JAX_COARSE_TAIL[1]}); K2F {split}; "
        f"run {wall:.2f} s")
    if not coarse["tail_ate_corrected"] < coarse["tail_ate_raw"]:
        failures.append(f"coarse: corrected tail ATE "
                        f"{coarse['tail_ate_corrected']:.5f} m not below raw "
                        f"{coarse['tail_ate_raw']:.5f} m")
    t0 = time.monotonic()
    replay = offline_replay(kf, states, cgt, {"trans_threshold": 0.08,
                                              "rot_threshold": 0.08})
    replay["run_s"] = time.monotonic() - t0
    coarse["offline_replay"] = replay
    log(f"  coarse offline replay (one odometry pass, both optimizers "
        f"offline): tail ATE graph {replay['posegraph']:.5f} m, BA "
        f"{replay['ba']:.5f} m (JAX package, CPU: {JAX_COARSE_REPLAY[0]}, "
        f"{JAX_COARSE_REPLAY[1]}); {replay['run_s']:.2f} s")
    if not replay["ba"] <= replay["posegraph"] + KF_BA_SLACK:
        failures.append(f"coarse replay: BA tail ATE {replay['ba']:.5f} m > "
                        f"graph {replay['posegraph']:.5f} m + {KF_BA_SLACK}")
    if failures:
        raise RuntimeError("; ".join(failures))
    return {"routes": routes, "timed": timed, "coarse": coarse,
            "k2f_snapshot": snapshot}


def phase_census(dev: torch.device, man: dict, work: str,
                 route: dict) -> dict:
    """tools/icp_census.py on the card over the clip: executed ICP
    iterations a level and frame, and the frozen share of the 19 K2F +
    updatePose launches a frame; beside them the iterations that phase
    7's route ran (its host-side break)."""
    from slambench_tpu_torch.tools import icp_census

    log(f"[10/17 census] tools/icp_census.py --device cuda on the "
        f"traj2-like clip, {N_FRAMES} frames 640x480 -> 320x240, "
        f"{VOLUME}^3, pyramid {','.join(map(str, PYRAMID))}")
    path = os.path.join(work, "census.json")
    reset_launches()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = icp_census.main(["--device", dev.type, "--raw", man["raw"],
                              "--frames", str(N_FRAMES), "--volume",
                              str(VOLUME), "--json", path])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = frame_launches()
    if rc != 0:
        raise RuntimeError(f"icp_census exited {rc}")
    with open(path) as f:
        res = json.load(f)
    check_frame_launches(launches, N_FRAMES, "census")
    budgets = list(reversed(PYRAMID))
    for frame, counts in res["per_frame"].items():
        if not all(1 <= c <= b for c, b in zip(counts, budgets)):
            raise RuntimeError(f"census frame {frame}: counts {counts} "
                               f"outside 1..{budgets}")
    if res["frames"] != N_FRAMES - 4:
        raise RuntimeError(f"census reports {res['frames']} frames")
    log("  executed iterations a frame (coarse, mid, fine): " + "; ".join(
        f"{k}: {v}" for k, v in res["per_frame"].items()))
    log(f"  per level: {json.dumps(res['per_level'])}")
    log(f"  {res['total_iters_mean']} of {res['total_iters_budget']} "
        f"iterations run a frame; frozen K2F launches a frame "
        f"{res['frozen_k2f_per_frame_mean']} (share "
        f"{res['frozen_share']}); launches {launches}; {wall:.2f} s")
    res["route_iterations_mean"] = {
        k: route[k]["iterations_mean_steady"] for k in ("fast", "jnp_cv")}
    log(f"  beside phase 7's route (K2 launches a frame = iterations run, "
        f"frames 4..): fast (warm-started raycast) "
        f"{res['route_iterations_mean']['fast']:.2f}, jnp + cv "
        f"{res['route_iterations_mean']['jnp_cv']:.2f}; the census "
        f"(production, frames 4..) {res['total_iters_mean']}")
    res["launches"] = launches
    return res


def http_get(url: str, timeout: float = 60.0) -> bytes:
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def phase_dashboard(dev: torch.device, work: str) -> dict:
    """frontend/dashboard.py served on port 0 against a short clip on the
    card (stats, tile, mesh), then frontend/viewer.py's PNG files."""
    import struct
    import threading
    from slambench_tpu_torch.frontend import dashboard, viewer
    from slambench_tpu_torch.io.synthetic import generate_dataset

    log(f"[11/17 dashboard] frontend/dashboard.py and frontend/viewer.py "
        f"on a {DASH_FRAMES}-frame clip on the card")
    man = generate_dataset(os.path.join(work, "short"), dev,
                           n_frames=DASH_FRAMES, image_size=(640, 480),
                           dim=(4.8, 4.8, 4.8),
                           init_pos_factor=(0.34, 0.5, 0.24), amp=0.25,
                           period=60)
    dashboard.RC_PATH = os.path.join(work, "dashboard_rc")
    args = ["--device", dev.type, "--port", "0", "--every", "1", "--paused",
            "-i", man["raw"], *CLI_ARGS]
    served, out = threading.Event(), {}

    def on_serve(dash, httpd):
        out["dash"], out["httpd"] = dash, httpd
        served.set()

    def target():
        try:
            out["rc"] = dashboard.run_dashboard(list(args), on_serve=on_serve)
        except BaseException as exc:          # reported by the caller
            out["error"] = exc
            served.set()

    th = threading.Thread(target=target, daemon=True)
    th.start()
    if not served.wait(300) or "error" in out:
        raise RuntimeError(f"the dashboard did not start: {out.get('error')}")
    dash = out["dash"]
    base = f"http://127.0.0.1:{out['httpd'].server_address[1]}"
    try:
        dash.control("break_frame", str(DASH_FRAMES - 2))
        dash.control("resume")
        t0 = time.monotonic()
        while time.monotonic() - t0 < 300:
            snap = dash.snapshot()
            if snap["mode"] == dashboard.PAUSED \
                    and snap["frame"] >= DASH_FRAMES - 2:
                break
            time.sleep(0.05)
        stats = json.loads(http_get(base + "/stats.json"))
        png = http_get(base + "/tile.png")
        ply = http_get(base + "/mesh.ply", timeout=120)
    finally:
        dash.control("quit")
        th.join(120)
    if th.is_alive() or out.get("rc") != 0:
        raise RuntimeError(f"the dashboard did not quit cleanly: "
                           f"{out.get('rc')} {out.get('error')}")
    w, h = struct.unpack(">II", png[16:24])
    head = ply[:200].decode("ascii", "replace")
    n_vert = int(head.split("element vertex ")[1].split()[0]) \
        if "element vertex " in head else 0
    if png[:8] != b"\x89PNG\r\n\x1a\n" or (h, w) != (480, 640):
        raise RuntimeError(f"/tile.png: signature {png[:8]!r}, {w}x{h}; "
                           "expected a 640x480 PNG (2W x 2H)")
    if stats["frame"] < DASH_FRAMES - 2 or not n_vert:
        raise RuntimeError(f"/stats.json frame {stats['frame']}, /mesh.ply "
                           f"{n_vert} vertices")
    log(f"  /stats.json frame {stats['frame']} mode {stats['mode']} tracked "
        f"{stats['tracked']}; /tile.png {w}x{h} ({len(png)} bytes); "
        f"/mesh.ply {n_vert} vertices ({len(ply)} bytes)")
    view_dir = os.path.join(work, "view")
    rc = viewer.run_viewer(["--device", dev.type, "--out-dir", view_dir,
                            "--every", "2", "-i", man["raw"], *CLI_ARGS])
    pngs = sorted(f for f in os.listdir(view_dir) if f.startswith("frame_"))
    want = [f"frame_{i:06d}.png" for i in range(0, DASH_FRAMES, 2)]
    if rc != 0 or pngs != want:
        raise RuntimeError(f"viewer rc {rc}, files {pngs}, expected {want}")
    for name in pngs:
        with open(os.path.join(view_dir, name), "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise RuntimeError(f"viewer {name} is not a PNG")
    log(f"  viewer wrote {len(pngs)} PNG tiles and latest.png")
    return {"tile": [w, h], "mesh_vertices": n_vert,
            "stats_frame": stats["frame"], "viewer_pngs": len(pngs)}


def mesh_run(dev: torch.device, man: dict, work: str, name: str,
             **kw) -> dict:
    """The CLI with --mesh z:1 in this process; the log's ATE, tracked
    flags, positions and steady-state computation ms, and the launches."""
    from slambench_tpu_torch.eval.check_pos import (
        compute_ate, load_gt_trajectory, parse_benchmark_log,
    )
    log_path = os.path.join(work, f"{name}.log")
    reset_launches()
    summary = run_cli(man, dev, log_path, extra=["--mesh", "z:1"], **kw)
    launches = frame_launches()
    logd = parse_benchmark_log(log_path)
    return {"launches": launches, "summary": summary,
            "ate": compute_ate(logd, load_gt_trajectory(man["gt"]))["ATE"],
            "tracked": logd["tracked"].astype(int),
            "positions": np.stack([logd["X"], logd["Y"], logd["Z"]], 1),
            "ms": 1e3 * float(np.mean(logd["computation"][5:]))}


def check_mesh_run(name: str, r: dict) -> None:
    if not r["tracked"][5:].all():
        raise RuntimeError(f"{name}: untracked frames >= 5: "
                           f"{np.nonzero(r['tracked'][5:] == 0)[0] + 5}")
    if not r["ate"].mean() < ATE_MEAN_BOUND:
        raise RuntimeError(f"{name}: ATE mean {r['ate'].mean():.5f} m >= "
                           f"{ATE_MEAN_BOUND}")


def sphere_case(path: str) -> None:
    """tests/test_sharded.py's sphere (64^3, 2 m, r 0.3 m at z 1.4)."""
    from slambench_tpu_torch.tools.distributed_probe import save_raycast_case
    res, dimv = 64, 2.0
    c = np.linspace(0.5 * dimv / res, dimv - 0.5 * dimv / res, res)
    Z, Y, X = np.meshgrid(c, c, c, indexing="ij")
    d = np.sqrt((X - 1.0) ** 2 + (Y - 1.0) ** 2 + (Z - 1.4) ** 2) - 0.3
    tsdf = np.trunc(np.clip(d / 0.2, -1, 1).astype(np.float32)
                    * 32766).astype(np.int16)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (1.0, 1.0, 0.2)
    save_raycast_case(path, tsdf, (2.0,) * 3, (60.0, 60.0, 16.0, 12.0), pose,
                      (32, 24), 0.2)


def mesh_kernels(dev: torch.device, kr: dict) -> dict:
    """K1 on the 2-rank band (rows 0-119 and the 2-row aprons, 124x320)
    and K2F on the 2-rank row blocks of the 240x320 pyramid, against
    their plain twins on phase 3's frame, timed."""
    from slambench_tpu_torch import params
    from slambench_tpu_torch.ops.hopper import bilateral, reduce
    from slambench_tpu_torch.tools.mosaic_probe import (
        K1_OPS_PER_TAP, K1_TOL, K2_TOL,
    )
    from slambench_tpu_torch.tools.timing import bound_by, bound_ms

    fd, lut, maps, pose, view = kr["frame"]
    H = fd.shape[0]
    hb, r = H // 2, params.RADIUS
    rows = np.arange(-r, hb + r)
    rows = np.where(rows < 0, H - 1, np.minimum(rows, H - 1))
    band = fd[torch.from_numpy(rows).to(dev)].contiguous()
    got = bilateral.bilateral_filter_cuda(band, lut)
    want = bilateral.plain(band, lut)
    n = band.numel()
    nbytes, ops = 2 * 4 * n, K1_OPS_PER_TAP * 25 * n
    k1 = {"shape": list(band.shape),
          "max_abs_err": compare(f"K1 band {tuple(band.shape)}", got, want,
                                 K1_TOL),
          "ms": time_ms("K1 band", lambda: bilateral.bilateral_filter_cuda(
              band, lut)),
          "plain_ms": time_ms("K1 band plain", lambda: bilateral.plain(
              band, lut), reps=20),
          "bound_ms": bound_ms(nbytes, ops), "bound_by": bound_by(nbytes, ops)}
    log(f"  K1 mesh band: {k1}")
    ref_v, ref_n = maps[0]
    k2f, err = {}, 0.0
    for v, nm in maps:
        h = v.shape[1]
        vb = v[:, :h // 2].contiguous()
        nb = nm[:, :h // 2].contiguous()
        args = (vb, nb, ref_v, ref_n, pose, view)
        red, res = reduce.track_reduce_cuda(*args)
        want_red, want_res = reduce.track_reduce_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(res, want_res):
            raise RuntimeError(f"K2F row block {tuple(vb.shape)}: result "
                               f"codes differ from the twin's")
        name = f"{vb.shape[1]}x{vb.shape[2]}"
        err = max(err, compare(f"K2F row block {name}", red, want_red,
                               K2_TOL))
        nbytes, ops = fused_work(res)
        k2f[name] = {
            "ms": time_ms(f"K2F block {name}",
                          lambda: reduce.track_reduce_cuda(*args)),
            "plain_ms": time_ms(f"K2F block {name} plain",
                                lambda: reduce.track_reduce_plain(*args),
                                reps=20),
            "bound_ms": bound_ms(nbytes, ops),
            "bound_by": bound_by(nbytes, ops)}
        log(f"  K2F mesh row block {name}: {k2f[name]}")
    return {"k1_band": k1, "k2f_blocks": k2f, "k2f_max_abs_err": err}


def phase_mesh(dev: torch.device, man: dict, work: str, main: dict,
               kr: dict) -> dict:
    """--mesh at full width: (a) one rank through the CLI (NCCL), also
    with --scan-chunk 8 (CUDA graph replays with the collectives inside);
    (b) two ranks on the card under torchrun; (c) the slab raycast at 2
    ranks against the single-device march; (d) the distributed probe."""
    log(f"[12/17 mesh] traj2-like clip, {N_FRAMES} frames, --mesh z:1 "
        f"(in process) and z:2 (torchrun, two ranks on one card)")
    # (a) one rank, NCCL.
    a = mesh_run(dev, man, work, "mesh1")
    check_mesh_run("(a) --mesh z:1", a)
    want = {"K1": 0, "K1F": N_FRAMES, "K2": 0, "K2F": sum(PYRAMID) * N_FRAMES}
    if a["launches"] != want:
        raise RuntimeError(f"(a) launches {a['launches']}, expected {want}")
    ms = a["summary"]["mesh"]
    want_backend = "nccl" if dev.type == "cuda" else "gloo"
    if ms["backend"] != want_backend:
        raise RuntimeError(f"(a) backend {ms['backend']}, expected "
                           f"{want_backend}")
    final = a["summary"]["state"]
    log(f"  (a) z:1 ({ms['backend']}): ATE mean {a['ate'].mean():.5f} m, "
        f"max {a['ate'].max():.5f}; launches {a['launches']}; computation "
        f"mean (frames 5..) {a['ms']:.3f} ms a frame")
    # (a2) one rank, --fused --scan-chunk 8: the graph route with NCCL.
    a2 = mesh_run(dev, man, work, "mesh1_scan", fused=True,
                  scan_chunk=SCAN_CHUNK)
    check_mesh_run("(a2) --mesh z:1 --scan-chunk", a2)
    d_scan = float(np.abs(a2["positions"] - a["positions"]).max())
    if d_scan > SCAN_POS_TOL:
        raise RuntimeError(f"(a2) positions {d_scan:.3e} m from (a)'s")
    graphs = a2["summary"]["kfusion"].graphs
    if dev.type == "cuda" and not graphs.captures:
        raise RuntimeError("(a2) no CUDA graph was captured")
    log(f"  (a2) z:1 --scan-chunk {SCAN_CHUNK}: {len(graphs.captures)} "
        f"capture(s), replay tally {graphs.launches}; positions within "
        f"{d_scan:.3e} m of (a); computation mean (frames 5..) "
        f"{a2['ms']:.3f} ms a frame")
    del a["summary"], a2["summary"]

    # (b) two ranks on the one card, under torchrun.
    from slambench_tpu_torch.eval.check_pos import (
        compute_ate, load_gt_trajectory, parse_benchmark_log,
    )
    log_b = os.path.join(work, "mesh2.log")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m",
           "slambench_tpu_torch.frontend.benchmark", "-i", man["raw"],
           "-o", log_b, *CLI_ARGS, "--mesh", "z:2", "--device", dev.type]
    t0 = time.monotonic()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    wall = time.monotonic() - t0
    if out.returncode != 0:
        raise RuntimeError(f"(b) torchrun exited {out.returncode}:\n"
                           f"{out.stderr[-4000:]}")
    lines = [ln for ln in out.stderr.splitlines()
             if ln.startswith("mesh summary: ")]
    header = [ln for ln in out.stderr.splitlines() if ln.startswith("mesh z:")]
    if len(lines) != 1:
        raise RuntimeError(f"(b) {len(lines)} mesh summary lines:\n"
                           f"{out.stderr[-4000:]}")
    sb = json.loads(lines[0][len("mesh summary: "):])
    logd = parse_benchmark_log(log_b)
    b = {"ate": compute_ate(logd, load_gt_trajectory(man["gt"]))["ATE"],
         "tracked": logd["tracked"].astype(int),
         "positions": np.stack([logd["X"], logd["Y"], logd["Z"]], 1),
         "ms": 1e3 * float(np.mean(logd["computation"][5:]))}
    check_mesh_run("(b) --mesh z:2", b)
    want_b = {"K1": [N_FRAMES] * 2, "K1F": [0, 0],
              "K2F": [sum(PYRAMID) * N_FRAMES] * 2}
    if sb["launches"] != want_b:
        raise RuntimeError(f"(b) launches {sb['launches']}, expected "
                           f"{want_b}")
    if sb["replication_checks"] != N_FRAMES:
        raise RuntimeError(f"(b) {sb['replication_checks']} pose checks, "
                           f"expected one a frame ({N_FRAMES})")
    if sb["analytic_mismatch"]:
        raise RuntimeError(f"(b) the tally of frame {sb['tally_frame']} "
                           f"differs from analytic_traffic: "
                           f"{sb['analytic_mismatch']}")
    d_ab = float(np.abs(b["positions"] - a["positions"]).max())
    log(f"  (b) {header[0] if header else ''}")
    log(f"  (b) z:2: ATE mean {b['ate'].mean():.5f} m, max "
        f"{b['ate'].max():.5f}; poses equal bit for bit across the ranks "
        f"after all {sb['replication_checks']} frames; launches (per rank) "
        f"{sb['launches']}; tally of frame {sb['tally_frame']} equals "
        f"analytic_traffic at {sum(PYRAMID)} ICP iterations: "
        f"{json.dumps(sb['tally'])}; computation mean (frames 5..) "
        f"{b['ms']:.3f} ms a frame; run {wall:.2f} s")
    coll = 1e3 * sum(v.get("seconds", 0.0) for v in sb["tally"].values())
    log(f"  (b) host ms in the collectives of frame {sb['tally_frame']}: "
        f"{coll:.3f} (" + ", ".join(
            f"{k} {1e3 * v.get('seconds', 0.0):.3f}"
            for k, v in sb["tally"].items()) + ")")
    log(f"  ms a frame (frames 5..): (a) z:1 {a['ms']:.3f}, (b) z:2 "
        f"{b['ms']:.3f}, phase 4 phased fast route "
        f"{main['ms']['computation']:.3f}; largest position difference "
        f"(a) vs (b) {d_ab:.3e} m")

    # (c) the slab raycast at 2 ranks, (d) the distributed probe.
    from slambench_tpu_torch.tools.distributed_probe import save_raycast_case
    sphere = os.path.join(work, "sphere.npz")
    sphere_case(sphere)
    vol = os.path.join(work, "final.npz")
    save_raycast_case(vol, final.tsdf.cpu().numpy(), (4.8,) * 3,
                      (240.6, 240.0, 160.0, 120.0), final.pose.cpu().numpy(),
                      (320, 240), 0.1)
    del final
    cmd = [sys.executable, "-m", "slambench_tpu_torch.tools.distributed_probe",
           "--launch", "2", "--device", dev.type, "--full-step",
           "--raycast", sphere, "--raycast", vol]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    recs = [json.loads(ln) for ln in out.stdout.strip().splitlines()]
    if out.returncode != 0 or len(recs) != 2:
        raise RuntimeError(f"(c)/(d) probe exited {out.returncode}:\n"
                           f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    for rec in recs:
        if not (rec["psum"] == rec["psum_want"] == 1.0 and rec["ring_ok"]
                and rec["full_step_pose_finite"]):
            raise RuntimeError(f"(d) probe rank {rec['rank']}: {rec}")
    rays = recs[0]["raycast"]
    # The sphere is held to JAX's exact branch. On a real scene's volume
    # the slab raycast (JAX's as the port's: tests/test_torch_sharded.py
    # holds the two equal on the clip's 64^3 volume at 2 and 4 ranks)
    # brackets some thin and grazing surfaces at another phase than the
    # single device (ROADMAP.md §3): it is held to the hit-mismatch
    # bound and to the normal share of the readings, and |dv| prints.
    sph, fin = rays
    if not (sph["hit_mismatch"] < 0.01 and sph["max_abs_dv"] < 1e-5
            and sph["normal_dot_gt_0.99"] > 0.99):
        raise RuntimeError(f"(c) sphere outside JAX's exact bounds: {sph}")
    if not (fin["hit_mismatch"] < 0.01
            and fin["normal_dot_gt_0.99"] > SLAB_NORMAL_SHARE):
        raise RuntimeError(f"(c) final volume: hit mismatches or normal "
                           f"share outside their bounds: {fin}")
    log(f"  (c) slab raycast at 2 ranks vs raycast_fast_maps: "
        f"{json.dumps(rays)}")
    log(f"  (d) probe at 2 ranks ({recs[0]['backend']}, halo by "
        f"{'all_gather' if recs[0]['halo_by_gather'] else 'isend/irecv'}): "
        f"psum {recs[0]['psum']}, ring {recs[0]['ring']} and "
        f"{recs[1]['ring']}, full step finite")
    kern = mesh_kernels(dev, kr)
    return {"a": {"ate_mean": float(a["ate"].mean()), "ms": a["ms"],
                  "launches": a["launches"], "backend": ms["backend"]},
            "a_scan": {"ate_mean": float(a2["ate"].mean()), "ms": a2["ms"],
                       "replay_tally": graphs.launches,
                       "pos_vs_a": d_scan},
            "b": {"ate_mean": float(b["ate"].mean()), "ms": b["ms"],
                  "summary": sb, "wall_s": wall, "pos_vs_a": d_ab},
            "raycast": rays, "probe_backend": recs[0]["backend"],
            "kernels": kern}


def phase_probes(dev: torch.device) -> dict:
    from slambench_tpu_torch.ops.hopper import bilateral, gather, reduce
    from slambench_tpu_torch.tools import gather_probe, k1_split, mosaic_probe

    log("[13/17 probe path] tools/mosaic_probe.py and tools/gather_probe.py "
        "at full shapes")
    bilateral.launches = 0
    bilateral.fused_launches = 0
    reduce.launches = 0
    reduce.fused_launches = 0
    for name in gather.launches:
        gather.launches[name] = 0
    t0 = time.monotonic()
    result = {"mosaic": mosaic_probe.run(dev), "gather": gather_probe.run(dev)}
    torch.cuda.synchronize()
    launches = dict(gather.launches, K1=bilateral.launches, K2=reduce.launches)
    bad = [f"{tool}.{k}" for tool, r in result.items()
           for k, v in r.items() if isinstance(v, dict) and not v["ok"]]
    if bad:
        raise RuntimeError(f"probe entries disagree with their twins: {bad}")
    unused = [k for k, v in launches.items() if v == 0]
    if unused:
        raise RuntimeError(f"kernels not launched on the probe path: {unused}")
    log(f"  every entry agrees; launches {launches}; "
        f"{time.monotonic() - t0:.2f} s")
    result["launches"] = launches
    # The floor under every row: an empty kernel on a 240x320 grid.
    result["empty_kernel"] = k1_split.empty_kernel_ms(dev)
    log(f"  empty kernel (tools/k1_split.py mode 0, 240x320 grid): "
        f"{result['empty_kernel']['ms'] * 1e3:.3f} us a launch")
    return result


# One run of the CLI's main in a process of its own (the knobs are read
# at import); the last stdout line holds the march, block and launch
# counters.
TUNING_RUN = r"""
import json, sys
from slambench_tpu_torch.frontend.benchmark import main
from slambench_tpu_torch.ops import integrate, raycast_fast
from slambench_tpu_torch.ops.hopper import bilateral, reduce
rc = main(sys.argv[1:])
print("tuning counters: " + json.dumps({
    "knobs": raycast_fast.read_knobs(),
    "march": dict(raycast_fast.march_counts, calls=raycast_fast.march_calls,
                  substeps=raycast_fast.march_substeps),
    "blocks": integrate.block_counts,
    "launches": {"K1": bilateral.launches, "K1F": bilateral.fused_launches,
                 "K2": reduce.launches, "K2F": reduce.fused_launches}}))
sys.exit(rc)
"""


def tuning_run(dev: torch.device, man: dict, work: str, name: str,
               env: dict) -> dict:
    """Phase 4's CLI run in a subprocess under ``env``: the log's
    positions and steady-state phase ms, and the run's counters."""
    from slambench_tpu_torch.eval.check_pos import parse_benchmark_log
    log_path = os.path.join(work, f"{name}.log")
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-c", TUNING_RUN, "-i", man["raw"], "-o", log_path,
         *CLI_ARGS, "--device", dev.type], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, **env))
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("tuning counters: ")]
    if out.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"{name}: exited {out.returncode}:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    logd = parse_benchmark_log(log_path)
    counters = json.loads(lines[0][len("tuning counters: "):])
    check_frame_launches(counters["launches"], len(logd["frame"]), name)
    return {"positions": np.stack([logd["X"], logd["Y"], logd["Z"]], 1),
            "ms": {k: 1e3 * float(np.mean(logd[k][5:]))
                   for k in ("integration", "raycasting", "computation")},
            "counters": counters, "wall_s": time.monotonic() - t0}


def phase_tuning(dev: torch.device, man: dict, work: str,
                 main: dict) -> dict:
    """(a) the single-phase march and (b) the 8x8x2 block integrate
    through the CLI, each against phase 4 bit for bit; (c) the tuning
    tools at a few values each."""
    from slambench_tpu_torch.eval.check_kernels import aggregate_kernel_log
    from slambench_tpu_torch.tools import autotune

    log("[14/17 tuning] the clip through the CLI with SLAMBENCH_MARCH_"
        "COMPACT=0 and with SLAMBENCH_INTEGRATE_BLOCKS=8x8x2; autotune, "
        "march_census, probe_integrate")
    out = {}
    for key, env, phase in (("a", {"SLAMBENCH_MARCH_COMPACT": "0"},
                             "raycasting"),
                            ("b", {"SLAMBENCH_INTEGRATE_BLOCKS": "8x8x2"},
                             "integration")):
        r = tuning_run(dev, man, work, f"tuning_{key}", env)
        same = np.array_equal(r["positions"], main["positions"])
        d = float(np.abs(r["positions"] - main["positions"]).max())
        log(f"  ({key}) {env}: logged positions "
            f"{'equal phase 4 bit for bit' if same else 'DIFFER'} (largest "
            f"difference {d:.3e} m); {phase} ms a frame (frames 5..) "
            f"{r['ms'][phase]:.3f}, phase 4 {main['ms'][phase]:.3f}; "
            f"computation {r['ms']['computation']:.3f}, phase 4 "
            f"{main['ms']['computation']:.3f}; run {r['wall_s']:.1f} s")
        if not same:
            raise RuntimeError(f"({key}) positions differ from phase 4's")
        out[key] = {k: v for k, v in r.items() if k != "positions"}
    marches = out["a"]["counters"]["march"]
    if marches["phase2_substeps"] or marches["compact"] or marches["full"]:
        raise RuntimeError(f"(a) a single-phase run took a phase 2: "
                           f"{marches}")
    log(f"  (a) single-phase marches {json.dumps(marches)}; phase 4 "
        f"(two-phase) {json.dumps(main['march'])}")
    blocks = out["b"]["counters"]["blocks"]
    if not blocks["calls"]:
        raise RuntimeError("(b) the block integrate never ran")
    share = blocks["visible"] / blocks["blocks"]
    out["b"]["visible_share"] = share
    log(f"  (b) integrate_blocks 8x8x2: {blocks['calls']} calls, visible "
        f"block share {share:.4f}")

    # (c) the tools.
    sweeps = {"reduce": ([128, 256, 512, 1024], 76800, 16),
              "mip": ([4, 8, 16], VOLUME, 3),
              "refine": (["8:4", "4:2", "2:2"], VOLUME, 3),
              "blocks": (["1x1x1", "8x8x1", "8x8x2", "16x16x2"], VOLUME, 3)}
    lines, tuned = [], {}
    for kernel, (values, size, iters) in sweeps.items():
        buf = io.StringIO()
        rows = getattr(autotune, f"sweep_{kernel}")(values, size, iters, dev,
                                                    out=buf)
        lines += buf.getvalue().splitlines()
        tuned[kernel] = [[str(r[0]), r[1], r[2]] for r in rows]
    for line in lines:
        log(f"    {line}")
    agg = aggregate_kernel_log(lines)
    if len(agg) != sum(len(v[0]) for v in sweeps.values()):
        raise RuntimeError(f"autotune: {len(agg)} check_kernels rows for "
                           f"{lines}")
    out["autotune"] = tuned
    census_json = os.path.join(work, "census.json")
    probe_json = os.path.join(work, "probe_integrate.json")
    common = ["--device", dev.type, "--volume", str(VOLUME)]
    for tool, args, path in (
            ("march_census", ["--raw", man["raw"], "--frames", "8",
                              "--json", census_json], census_json),
            ("probe_integrate", ["--json", probe_json], probe_json)):
        t0 = time.monotonic()
        r = subprocess.run([sys.executable, "-m",
                            f"slambench_tpu_torch.tools.{tool}", *args,
                            *common], capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"{tool} exited {r.returncode}:\n"
                               f"{r.stderr[-3000:]}")
        with open(path) as f:
            out[tool] = json.load(f)
        log(f"  {tool} ({time.monotonic() - t0:.1f} s): "
            f"{json.dumps(out[tool])}")
    census = out["march_census"]
    if census["counters_per_frame"]["substeps"] \
            > census["counters_graph"]["substeps"]:
        raise RuntimeError(f"march_census: the early-exit march ran more "
                           f"substeps than the full budget: {census}")
    return out


def phase_capability(dev: torch.device) -> dict:
    """JAX's 1024^3 capability run (tests/test_sharded.py:206) on two
    gloo ranks on the card with 8x8x2 blocks, through
    tools/distributed_probe.py: each rank's ms, peak memory, and the
    monolithic integrate's fit."""
    log("[15/17 capability] ShardedKFusion 1024^3 / 4.8 m at 64x48 on "
        "--mesh z:2 (two gloo ranks on the card), "
        "SLAMBENCH_INTEGRATE_BLOCKS=8x8x2")
    cmd = [sys.executable, "-m", "slambench_tpu_torch.tools.distributed_probe",
           "--launch", "2", "--device", dev.type, "--capability",
           str(CAPABILITY_VOLUME)]
    t0 = time.monotonic()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ,
                                  SLAMBENCH_INTEGRATE_BLOCKS="8x8x2"))
    recs = [json.loads(ln) for ln in out.stdout.strip().splitlines()
            if ln.startswith("{")]
    if out.returncode != 0 or len(recs) != 2:
        raise RuntimeError(f"capability run exited {out.returncode}:\n"
                           f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    caps = [r["capability"] for r in recs]
    for c in caps:
        if not (c["integrated"] and c["wall_hits"] > 0 and c["zero_crossing"]
                and c["integrate_block_grid"] == [8, 8, 2]):
            raise RuntimeError(f"capability: {c}")
        peak = c["peak_bytes"]
        log(f"  rank: slab {c['slab_z']} planes; ms {json.dumps(c['ms'])}; "
            f"wall hits {c['wall_hits']} of {64 * 48}; subsampled tsdf "
            f"{c['tsdf_min']}..{c['tsdf_max']}; peak "
            f"{'n/a' if peak is None else f'{peak / 2 ** 30:.3f} GiB'}; "
            f"monolithic integrate {json.dumps(c['monolithic'])}")
    log(f"  {time.monotonic() - t0:.1f} s")
    return {"ranks": caps, "wall_s": time.monotonic() - t0}


def phase_ops(dev: torch.device) -> dict:
    """JAX's per-op rows on the clip's state, the two probes, and the
    CLI's device selection from the environment."""
    from slambench_tpu_torch.eval.check_pos import parse_benchmark_log
    from slambench_tpu_torch.ops.hopper import bilateral, reduce
    from slambench_tpu_torch.tools import probe_r3, profile_frame, slice_probe

    log(f"[16/17 ops and probes] tools/profile_frame.py:op_rows on the "
        f"traj2-like clip after {OPS_WARMUP} frames ({VOLUME}^3, 320x240, "
        f"{json.dumps(OPS_REPS)}), tools/slice_probe.py, tools/probe_r3.py, "
        f"the CLI with SLAMBENCH_DEVICE")
    t0 = time.monotonic()
    out = {}
    with tempfile.TemporaryDirectory(prefix="slb_ops_") as work:
        kf, state, depths, man = profile_frame.clip_state(
            dev, VOLUME, (640, 480), 2, OPS_WARMUP, 0, work)
        bilateral.launches = bilateral.captured = 0
        bilateral.fused_launches = bilateral.fused_captured = 0
        reduce.fused_launches = reduce.fused_captured = 0
        rows = profile_frame.op_rows(kf, state, depths[OPS_WARMUP - 1],
                                     **OPS_REPS)
        torch.cuda.synchronize()
        counts = {"K1": [bilateral.launches, bilateral.captured],
                  "K1F": [bilateral.fused_launches, bilateral.fused_captured],
                  "K2F": [reduce.fused_launches, reduce.fused_captured]}
        del kf, state, depths
        bad = [n for n in JAX_OP_ROWS
               if not (n in rows and rows[n]["ms"] and rows[n]["ms"] > 0
                       and rows[n]["eager_ms"] and rows[n]["eager_ms"] > 0)]
        bad += [n for n in JAX_OP_SCALARS if not (rows.get(n) or 0) > 0]
        if bad:
            raise RuntimeError(f"op rows without a positive time: {bad}")
        unused = [k for k, (n, c) in counts.items() if not (n and c)]
        if unused:
            raise RuntimeError(f"op rows: kernels not launched and captured: "
                               f"{unused} ({counts})")
        for name, r in rows.items():
            if isinstance(r, dict) and "eager_ms" in r:
                paced = " (host-paced)" if r["host_bound"] else ""
                log(f"  {name:28s} graph {r['ms']:9.4f} ms, eager "
                    f"{r['eager_ms']:9.4f} ms{paced}, {r['mb']} MB, "
                    f"{r['gbps']:.2f} GB/s")
        log(f"  session gather {rows['session_gather_ns_per_elem']:.4f} "
            f"ns/elem (coherent "
            f"{rows['session_gather_coherent_ns_per_elem']:.4f}); stream "
            f"probe {rows['device_eff_gbps']:.1f} GB/s of "
            f"{rows['hbm_peak_gbps']:.0f}; launches, captures {counts}; "
            f"{time.monotonic() - t0:.1f} s")
        out.update(rows=rows, counts=counts)
        t1 = time.monotonic()
        out["slice_probe"] = slice_probe.run(dev, VOLUME, runs=2)
        out["probe_r3"] = probe_r3.run(dev, VOLUME, 8, reps=2, runs=2)
        variants = out["slice_probe"]["variants"]
        log("  slice_probe (every sum equals its scalar twin's): " + "; ".join(
            f"{k} {v['ms']:.4f} ms {v['ns_per_index']:.4f} ns/idx"
            for k, v in variants.items()))
        r3 = out["probe_r3"]
        log("  probe_r3 (slabs, ref fetch and lane gather equal): "
            + "; ".join(f"{k} {v:.4f}" for k, v in r3.items()
                        if isinstance(v, float))
            + f"; visible blocks {json.dumps(r3['visible_blocks'])}; "
            f"{time.monotonic() - t1:.1f} s")

        # The CLI's device from the environment: a run on card 0, and a
        # refused ordinal (one past the last card) beside it.
        env = {k: v for k, v in os.environ.items()
               if k not in ("SLAMBENCH_PLATFORM", "SLAMBENCH_DEVICE")}
        def cli(name: str) -> list:
            return [sys.executable, "-m",
                    "slambench_tpu_torch.frontend.benchmark", "-i",
                    man["raw"], "-o", os.path.join(work, name), *CLI_ARGS,
                    "--break-at-frame", str(OPS_CLI_BREAK)]

        bad_ordinal = str(torch.cuda.device_count())
        refused = subprocess.Popen(
            cli("refused.log"), env=dict(env, SLAMBENCH_DEVICE=bad_ordinal),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        log_path = os.path.join(work, "env.log")
        ran = subprocess.run(cli("env.log"),
                             env=dict(env, SLAMBENCH_DEVICE="0"),
                             capture_output=True, text=True, timeout=600)
        err = refused.communicate(timeout=600)[1]
        if ran.returncode != 0:
            raise RuntimeError(f"CLI with SLAMBENCH_DEVICE=0 exited "
                               f"{ran.returncode}:\n{ran.stderr[-3000:]}")
        frames = len(parse_benchmark_log(log_path)["frame"])
        if frames != OPS_CLI_BREAK + 1:
            raise RuntimeError(f"CLI with SLAMBENCH_DEVICE=0 logged {frames} "
                               f"frames, expected {OPS_CLI_BREAK + 1}")
        hint = [ln for ln in err.splitlines() if ln.startswith("hint:")]
        if refused.returncode == 0 or not hint \
                or "SLAMBENCH_DEVICE" not in err:
            raise RuntimeError(f"CLI with SLAMBENCH_DEVICE={bad_ordinal} "
                               f"exited {refused.returncode}, stderr:\n"
                               f"{err[-3000:]}")
        log(f"  CLI: SLAMBENCH_DEVICE=0 logged {frames} frames; "
            f"SLAMBENCH_DEVICE={bad_ordinal} exited {refused.returncode} "
            f"with \"{hint[0]}\"")
    out["seconds"] = time.monotonic() - t0
    log(f"  phase seconds {out['seconds']:.1f}")
    return out


# The gather kernels' rows: the probe entry each is timed by, and the
# Pallas call of slambench_tpu/tools/mosaic_probe.py it stands in for.
G_ROWS = (
    ("G1 gather_flat", "gather_flat", "mosaic", "wide_gather_device",
     "slambench_tpu/tools/mosaic_probe.py:214"),
    ("G2 gather_axis_smem", "gather_axis_smem", "mosaic", "mosaic_take_flat",
     "slambench_tpu/tools/mosaic_probe.py:55"),
    ("G3 gather_smem_u16", "gather_smem_u16", "mosaic",
     "wide_gather_smem_u16", "slambench_tpu/tools/mosaic_probe.py:214"),
    ("G4 gather_2d, staged route (240x320)", "gather_2d_staged",
     "mosaic", "adv2d_gather", "slambench_tpu/tools/mosaic_probe.py:243"),
    ("G4 gather_2d, device-memory route (720x1280)", "gather_2d_device",
     "gather", "op2d_f32_720p", "slambench_tpu/tools/mosaic_probe.py:243"),
)


def main() -> int:
    from slambench_tpu_torch.io.synthetic import generate_dataset
    from slambench_tpu_torch.tools.timing import bound_by, bound_ms

    t_start = time.monotonic()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kr = phase_kernels(dev)
    g_err = phase_gathers(dev)
    elapsed = {}

    def done(name: str) -> None:
        elapsed[name] = time.monotonic() - t_start
        log(f"  ({name} done {elapsed[name]:.1f} s after the start)")

    done("kernels")
    with tempfile.TemporaryDirectory(prefix="slb_smoke_") as work:
        t0 = time.monotonic()
        man = generate_dataset(work, dev, n_frames=N_FRAMES,
                               image_size=(640, 480), dim=(4.8, 4.8, 4.8),
                               init_pos_factor=(0.34, 0.5, 0.24), amp=0.25,
                               period=60)
        log(f"  clip synthesised on the card in "
            f"{time.monotonic() - t0:.2f} s")
        mp = phase_main_path(dev, man, work)
        done("main path")
        sc = phase_scan(dev, man, work, mp)
        done("scan")
        rs = phase_resume(dev, man, work, mp)
        done("resume")
        tr = phase_timed_route(dev, man, work)
        done("KERNEL_TIMINGS route")
        io_ = phase_inputs(dev, man, work, mp, tr, kr, smi)
        done("inputs")
        kfp = phase_keyframes(dev, work, mp)
        done("keyframes")
        cen = phase_census(dev, man, work, tr)
        done("census")
        dsh = phase_dashboard(dev, work)
        done("dashboard")
        msh = phase_mesh(dev, man, work, mp, kr)
        done("mesh")
        pr = phase_probes(dev)
        done("probe path")
        tun = phase_tuning(dev, man, work, mp)
        done("tuning")
    cap = phase_capability(dev)
    done("capability")
    ops = phase_ops(dev)
    done("ops and probes")
    k1, k1f, k2, k2f = kr["k1"], kr["k1f"], kr["k2"], kr["k2f"]
    k2_0 = k2["by_shape"]["240x320"]
    k2f_0 = k2f["by_shape"]["240x320"]
    # K1 and K2 on the KERNEL_TIMINGS route (phase 7, both runs), each
    # run's counts reset before it and read after it; also on the probe
    # path (phase 13).
    by_route = {
        k: {"timed fast": tr["fast"]["launches"][k],
            "timed jnp + cv": tr["jnp_cv"]["launches"][k],
            "probe path": pr["launches"][k]} for k in ("K1", "K2")}
    rows = [
        # The production frame path runs K1F (K1's launches there are 0,
        # asserted in phase 4); the metre-in K1 runs on the route.
        {"name": "K1 bilateral_filter", "route": "cuda",
         "source": "slambench_tpu_torch/ops/hopper/csrc/bilateral.cu",
         "replaces": "slambench_tpu/ops/pallas/bilateral.py:64",
         "launches": by_route["K1"]["timed fast"]
         + by_route["K1"]["timed jnp + cv"],
         "launches_by_route": by_route["K1"],
         "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None,
         "route_fenced_ms": {k: v["rows_us"]["bilateralFilter"] * 1e-3
                             for k, v in tr.items()}},
        {"name": "K1F mm2m_bilateral (mm2meters fused into K1)",
         "route": "cuda",
         "source": "slambench_tpu_torch/ops/hopper/csrc/bilateral.cu",
         "replaces": "slambench_tpu/ops/pallas/bilateral.py:64",
         "launches": mp["launches"]["K1F"],
         "scan_launches": sc["cli"]["tally"]["K1F"],
         "max_abs_err": k1f["max_abs_err"],
         "ms": k1f["ms"], "plain_ms": k1f["plain_ms"],
         "bound_ms": k1f["bound_ms"], "bound_by": k1f["bound_by"],
         "library_ms": None},
        # The production frame path runs K2F (K2's launches there are 0,
        # asserted in phase 4); the unfused K2 runs on the route.
        {"name": "K2 reduce_track", "route": "cuda",
         "source": "slambench_tpu_torch/ops/hopper/csrc/reduce.cu",
         "replaces": "slambench_tpu/ops/pallas/reduce.py:87",
         "launches": by_route["K2"]["timed fast"]
         + by_route["K2"]["timed jnp + cv"],
         "launches_by_route": by_route["K2"],
         "max_abs_err": k2["max_abs_err"],
         "ms": k2_0["ms"], "plain_ms": k2_0["plain_ms"],
         "bound_ms": k2_0["bound_ms"], "bound_by": k2_0["bound_by"],
         "library_ms": None, "by_threads": k2["by_threads"],
         "route_fenced_ms": {k: {s: us * 1e-3 for s, us in
                                 v["rows_us"]["reduce"].items()}
                             for k, v in tr.items()}},
        {"name": "K2F track_reduce (track fused into K2)", "route": "cuda",
         "source": "slambench_tpu_torch/ops/hopper/csrc/reduce.cu",
         "replaces": "slambench_tpu/ops/pallas/reduce.py:87",
         "launches": mp["launches"]["K2F"],
         "scan_launches": sc["cli"]["tally"]["K2F"],
         "max_abs_err": k2f["max_abs_err"],
         "ms": k2f_0["ms"], "plain_ms": k2f_0["plain_ms"],
         "bound_ms": k2f_0["bound_ms"], "bound_by": k2f_0["bound_by"],
         "library_ms": None, "by_threads": k2f["by_threads"]},
        # K2F at the alignment's shape: the keyframe phase's
        # loop-closure ICP (the --keyframes route's launches there).
        {"name": "K2F track_reduce, loop-closure alignment "
                 f"({kfp['k2f_snapshot']['shape']} snapshots)",
         "route": "cuda",
         "source": "slambench_tpu_torch/ops/hopper/csrc/reduce.cu",
         "replaces": "slambench_tpu/ops/pallas/reduce.py:87",
         "launches": kfp["routes"]["posegraph"]["k2f_split"]["alignment"],
         "max_abs_err": kfp["k2f_snapshot"]["max_abs_err"],
         "ms": kfp["k2f_snapshot"]["ms"],
         "plain_ms": kfp["k2f_snapshot"]["plain_ms"],
         "bound_ms": kfp["k2f_snapshot"]["bound_ms"],
         "bound_by": kfp["k2f_snapshot"]["bound_by"], "library_ms": None},
    ]
    # The mesh route's shapes (phase 12): K1 on a rank's band with its
    # aprons, K2F on a rank's row blocks; launches summed over the ranks
    # of the two-rank run.
    mk, mb = msh["kernels"], msh["b"]["summary"]["launches"]
    rows.append({
        "name": f"K1 bilateral_filter, mesh band "
                f"({mk['k1_band']['shape'][0]}x{mk['k1_band']['shape'][1]})",
        "route": "cuda",
        "source": "slambench_tpu_torch/ops/hopper/csrc/bilateral.cu",
        "replaces": "slambench_tpu/ops/pallas/bilateral.py:64",
        "launches": sum(mb["K1"]),
        "max_abs_err": mk["k1_band"]["max_abs_err"],
        "ms": mk["k1_band"]["ms"], "plain_ms": mk["k1_band"]["plain_ms"],
        "bound_ms": mk["k1_band"]["bound_ms"],
        "bound_by": mk["k1_band"]["bound_by"], "library_ms": None})
    b0 = mk["k2f_blocks"]["120x320"]
    rows.append({
        "name": "K2F track_reduce, mesh row block (120x320 of 240x320; "
                "by_shape has 60x160 and 30x80)",
        "route": "cuda",
        "source": "slambench_tpu_torch/ops/hopper/csrc/reduce.cu",
        "replaces": "slambench_tpu/ops/pallas/reduce.py:87",
        "launches": sum(mb["K2F"]),
        "max_abs_err": mk["k2f_max_abs_err"],
        "ms": b0["ms"], "plain_ms": b0["plain_ms"],
        "bound_ms": b0["bound_ms"], "bound_by": b0["bound_by"],
        "library_ms": None, "by_shape": mk["k2f_blocks"]})
    for name, key, tool, entry, replaces in G_ROWS:
        e = pr[tool][entry]
        per_ms = e["count"] * 1e-6
        rows.append({
            "name": name, "route": "cuda",
            "source": "slambench_tpu_torch/ops/hopper/csrc/gather.cu",
            "replaces": replaces, "launches": pr["launches"][key],
            "max_abs_err": max(g_err[key], e["max_abs_err"]),
            "ms": e["ns_per_elem"] * per_ms,
            "plain_ms": e["plain_ns_per_elem"] * per_ms,
            "bound_ms": bound_ms(e["bytes"], e["ops"]),
            "bound_by": bound_by(e["bytes"], e["ops"]),
            "library_ms": e["library_ns_per_elem"] * per_ms})
        if e.get("l2_sector_bytes"):
            rows[-1].update(l2_sector_bytes=e["l2_sector_bytes"],
                            l2_sector_tb_per_s=e["l2_sector_tb_per_s"])
    probes = {f"{tool}.{k}": [v["count"], v["ns_per_elem"],
                              v["library_ns_per_elem"],
                              v["bound_ns_per_elem"], v["host_bound"]]
              for tool in ("mosaic", "gather")
              for k, v in pr[tool].items() if isinstance(v, dict)}
    log("[17/17 report]")
    mp_report = {k: v for k, v in mp.items()
                 if k not in ("positions", "final_pose", "raycasting_s",
                              "ate_by_frame")}
    log(json.dumps({"main_path": mp_report, "scan": sc, "resume": rs,
                    "timed_route": tr,
                    "inputs": io_, "keyframes": kfp, "census": cen,
                    "dashboard": dsh,
                    "mesh": {k: v for k, v in msh.items() if k != "kernels"},
                    "tuning": tun, "capability": cap, "ops": ops,
                    "k1f": k1f, "k2_by_shape": k2["by_shape"],
                    "k2f_by_shape": k2f["by_shape"]}))
    log("probe entries [count, ns/elem, library ns/elem, bound ns/elem, "
        "host-paced]: " + json.dumps(probes))
    log(f"empty kernel: {json.dumps(pr['empty_kernel'])}")
    log(f"seconds after the start, by phase: {json.dumps(elapsed)}")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
