"""Headless benchmark front-end of the port: the counterpart of
``python -m slambench_tpu.frontend.benchmark``.

Reads depth frames, runs the four phases, renders the diagnostic
images, and writes the reference's 14-column TSV log that
``eval/check_pos.py`` reads (reference: kfusion/src/benchmark.cpp:47-190).
Three timing modes:

  * phased (default): ``torch.cuda.synchronize()`` before every
    timestamp, the reference's ``synchroniseDevices()`` per phase;
  * fused (``--fused``): one fence for the frame's computation;
    per-phase columns are 0 and ``computation`` holds the frame;
  * timed (phased with KERNEL_TIMINGS set, and not ``xprof``; no
    ``--fused``, ``--keyframes`` or ``--mesh``): ``frontend/timed.py:
    TimedRunner`` runs the frame kernel by kernel, each dispatch fenced
    and printed to stderr as a ``name ns size`` line under the
    reference's names, with K1 and K2 as the ``bilateralFilter`` and
    ``reduce`` dispatches and the ICP breaking on the host (JAX's
    route); per-phase columns are 0 and ``computation`` holds the frame.

In all three, the rendering phase (the depth and track images every
frame, the shaded volume every ``rendering_rate`` frames) is fenced on
its own and written to the ``rendering`` column; ``total`` includes it.
``--checkpoint FILE`` saves the state after the loop and ``--resume
FILE`` continues from one (the JAX package's ``.npz``; either package's
file loads in the other). With KERNEL_TIMINGS set on the other routes,
each frame's kernel spans (``utils/timers.py``: CUDA events around the
production dispatches) go to stderr as ``name ns size`` lines; the
render spans print after a frame's lines on every route, the timed one
included (``eval/check_kernels.py`` reads them all).

Observation flags, as in the JAX CLI:

  * ``--stats`` samples ``frame``, ``computation`` and ``total`` into
    ``utils/perfstats.Stats`` and the power rails into a
    ``utils/power.PowerMonitor`` once a frame, after the frame's timed
    window, and prints both tables to stderr at the end. On ``cuda`` the
    rail is the card's, through NVML, and a missing NVML is an error;
  * ``--break-on-untracked`` stops after the first untracked frame past
    the bootstrap, ``--break-at-frame N`` after frame N; the breaking
    frame's row is written, and the checkpoint and volume dump follow;
  * ``--debug-nans`` checks every float tensor each phase wrote for NaN
    (not inf, as ``jax_debug_nans``) and raises ``FloatingPointError``
    naming the phase and the tensor; the check reads the host, so it
    runs only under the flag;
  * ``--report-device`` prints the platform and device table to stderr.

``--scan-chunk N`` (with ``--fused``) batches dispatches as the JAX
CLI does: steady-state frames (past frame 3) are read ahead up to N at a
time, in whole gate periods (``lcm(-t, -r)``), and run through
``KFusion.compute_frames_scan`` (``-r 1``) or
``compute_frames_scan_rated``: on the card, one replay of a CUDA graph a
period (``graphs.py``). The chunk's frames are uploaded before its timed
window; its rows have phase columns 0, ``computation`` the chunk's fenced
time over its frames, and ``rendering`` the three images, rendered once
at the chunk's end, shared out the same way. A flag that needs each
frame observed turns it off with one line on stderr (the gate period
above N, no ``--fused``, KERNEL_TIMINGS spans, ``--keyframes``,
``--stats``, the break flags, ``--debug-nans``); the tail of fewer
frames than a period runs per frame.

With ``KERNEL_TIMINGS=xprof`` no span is timed; instead one dispatch
(a frame past 3, or a chunk) whose signature already ran is traced with
``torch.profiler`` into a new directory under ``$TMPDIR``, and its
device events go to stderr as ``name ns`` lines
(``eval/xprof2log.py``), then ``xprof kernel attribution: N events over
F frames (dir)``; a trace with no device lane (the CPU) prints a notice
instead. The first replay of a signature includes its capture.

``--keyframes`` runs the keyframe layer (``models/keyframes.py``): each
frame goes through ``PoseGraphKFusion.process_frame`` (keyframe
promotion, loop-closure ICP on K2F, graph optimization between frames),
timed as one window like ``--fused``, which it takes precedence over. At
the end the raw and the corrected trajectories are written as
``<log>.kf_raw.tum`` and ``<log>.kf_corrected.tum``. ``--ba`` (implies
``--keyframes``) optimizes by sparse Schur bundle adjustment over the
keyframe snapshots instead of the pose graph alone. A resumed run starts
with an empty graph; a checkpoint does not hold it.

``--mesh z:n`` runs the sharded step (``parallel/step.py:
ShardedKFusion``) on an n-rank ``torch.distributed`` mesh, every frame
as one fused window (as the JAX CLI runs its ``shard_map`` step). With n
> 1 the CLI runs under ``torchrun --nproc-per-node n`` and refuses a
world size other than n; rank 0 writes the log, the checkpoint and the
summary. A line on stderr names the mesh (ranks, backend, device, halo
route) and the ``--scan-chunk`` route: CUDA graph replays where the
group's collectives can be captured (NCCL), else eager chunks. After
every frame (and chunk) the ranks' poses are checked equal bit for bit;
at the end rank 0 prints ``mesh summary: {json}`` (the collective tally
of the last per-frame window against ``parallel/comm.py``'s account,
the number of checks, each rank's hand-kernel launches). ``--keyframes``
with ``--mesh`` is refused, as in JAX.

The device is ``--device`` when given, else the environment's
(``utils/backend.py``, the reference's ``OPENCL_PLATFORM`` /
``OPENCL_DEVICE``): ``SLAMBENCH_PLATFORM`` (``cpu``, or ``gpu`` /
``cuda``) and ``SLAMBENCH_DEVICE=N`` (``cuda:N``), else ``cuda``; a
missing card is an error, never a quiet fallback to the CPU, and a
malformed variable raises naming it. ``SLAMBENCH_JIT_CACHE=DIR`` builds
the kernels under ``DIR`` instead of the ignored ``_build/``
directories (``ops/hopper/build.py:build_dir``). On a failure whose signature ``backend.explain_error``
knows (out of device memory, no card, no or a failed nvcc, a NaN, a bad
variable) the CLI prints ``hint: ...`` to stderr and re-raises, so the
exit code stays non-zero.

The input (``-i``) is a ``.raw`` file, an ICL-NUIM scene directory, or
a ``.scf`` scene-config file (``io/readers.py``).

Usage:  python -m slambench_tpu_torch.frontend.benchmark -i scene.raw
        -o out.log [reference flags] [--fused] [--scan-chunk N]
        [--device cuda|cpu] [--stats] [--break-on-untracked]
        [--break-at-frame N] [--debug-nans] [--report-device]
        [--keyframes] [--ba] [--mesh z:n]
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from slambench_tpu_torch.config import Configuration, parse_args
from slambench_tpu_torch.ops.hopper import bilateral, reduce
from slambench_tpu_torch.eval import xprof2log
from slambench_tpu_torch.eval.trajectory import write_tum
from slambench_tpu_torch.frontend.timed import TimedRunner
from slambench_tpu_torch.io.readers import make_reader
from slambench_tpu_torch.models.keyframes import (
    KeyframeStore, PoseGraphKFusion,
)
from slambench_tpu_torch.parallel import comm, distributed
from slambench_tpu_torch.parallel.mesh import Mesh, parse_mesh_spec
from slambench_tpu_torch.parallel.step import ShardedKFusion
from slambench_tpu_torch.pipeline import KFusion, KFusionState, frame_gates
from slambench_tpu_torch.policy import (
    apply_precision_policy, device_report, resolve_device, synchronize,
)
from slambench_tpu_torch.utils import backend
from slambench_tpu_torch.utils import power as power_mod
from slambench_tpu_torch.utils.checkpoint import load_state, save_state
from slambench_tpu_torch.utils.perfstats import Stats, StatType
from slambench_tpu_torch.utils.timers import spans_enabled, xprof_enabled

HEADER = ("frame\tacquisition\tpreprocessing\ttracking\tintegration"
          "\traycasting\trendering\tcomputation\ttotal    \tX          "
          "\tY          \tZ         \ttracked   \tintegrated")

# Front-end flags of the JAX CLI that this port does not implement yet.
NOT_PORTED_FLAGS = ()

ROW = ("%d\t%.10f\t%.10f\t%.10f\t%.10f\t%.10f\t%.10f\t%.10f\t%.10f"
       "\t%.10f\t%.10f\t%.10f\t%d        \t%d")


def make_power_monitor(device: torch.device) -> power_mod.PowerMonitor:
    """The ``--stats`` monitor: the card's rail through NVML on ``cuda``
    (exits 1 if NVML does not load), the host's sensors on the CPU."""
    if device.type != "cuda":
        return power_mod.PowerMonitor()
    try:
        return power_mod.PowerMonitor(nvml_library=power_mod.NVML_LIBRARY,
                                      nvml_index=device.index or 0)
    except RuntimeError as exc:
        print(f"ERROR: --stats on {device} needs the card's power rail: "
              f"{exc}", file=sys.stderr)
        raise SystemExit(1) from exc


def make_kfusion(config: Configuration, reader, device: torch.device,
                 mesh: Optional[Mesh] = None) -> KFusion:
    """The pipeline for a configuration and its opened reader: the
    compute size and the camera scaled by the compute-size ratio; with a
    mesh, this rank's ``ShardedKFusion`` (on the rank's device)."""
    in_w, in_h = reader.get_input_size()
    ratio = config.compute_size_ratio
    camera = tuple(c / ratio for c in (
        config.camera if config.camera_overrided else reader.get_k()))
    args = ((in_w // ratio, in_h // ratio), config.volume_resolution,
            config.volume_size, config.init_pose, config.pyramid, camera)
    kwargs = dict(mu=config.mu, icp_threshold=config.icp_threshold,
                  backend=config.backend, motion_model=config.motion_model)
    if mesh is not None:
        return ShardedKFusion(*args, mesh=mesh, **kwargs)
    return KFusion(*args, device=device, **kwargs)


def check_nans(phase: str, frame: int, before: KFusionState,
               after: KFusionState) -> None:
    """--debug-nans: raise if a float tensor that ``phase`` wrote holds a
    NaN (inf passes, as with ``jax_debug_nans``)."""
    for field in dataclasses.fields(after):
        new = getattr(after, field.name)
        if new is getattr(before, field.name) or not new.is_floating_point():
            continue
        if bool(torch.isnan(new).any()):
            raise FloatingPointError(
                f"--debug-nans: {phase} wrote a NaN into {field.name} at "
                f"frame {frame}")


def run(config: Configuration, device: torch.device, fused: bool = False,
        max_frames: Optional[int] = None, quiet: bool = False,
        stats: bool = False, break_on_untracked: bool = False,
        break_at_frame: Optional[int] = None,
        debug_nans: bool = False, keyframes: bool = False,
        ba: bool = False, scan_chunk: int = 0) -> dict:
    """Run the benchmark on ``device``; returns summary statistics with
    per-frame phase times in seconds. ``max_frames`` is the frame index
    to stop at (a resumed run starts at the checkpoint's frame). With
    ``keyframes`` (or ``ba``, which implies it) the summary's
    ``posegraph`` holds the ``PoseGraphKFusion``. ``scan_chunk`` > 1
    batches steady-state frames (``--scan-chunk``)."""
    mesh = None
    if config.mesh:
        if keyframes or ba:
            raise SystemExit("--keyframes is not supported with --mesh "
                             "(the sharded tier runs pure odometry)")
        mesh = distributed.initialize(parse_mesh_spec(config.mesh), device)
        device = mesh.device
        fused = True               # one window a frame, as JAX's mesh CLI
    try:
        return _run(config, device, mesh, fused, max_frames, quiet, stats,
                    break_on_untracked, break_at_frame, debug_nans,
                    keyframes, ba, scan_chunk)
    finally:
        if mesh is not None:
            mesh.close()


def _run(config: Configuration, device: torch.device, mesh: Optional[Mesh],
         fused: bool, max_frames: Optional[int], quiet: bool, stats: bool,
         break_on_untracked: bool, break_at_frame: Optional[int],
         debug_nans: bool, keyframes: bool, ba: bool,
         scan_chunk: int) -> dict:
    primary = distributed.is_primary()
    power = make_power_monitor(device) if stats else None
    apply_precision_policy()
    reader = make_reader(config)
    if reader is None or not reader.camera_open:
        print("No input found.", file=sys.stderr)
        config.print_arguments()
        raise SystemExit(1)

    kf = make_kfusion(config, reader, device, mesh)
    pgkf = None
    if keyframes or ba:
        pgkf = PoseGraphKFusion(kf, KeyframeStore(),
                                backend="ba" if ba else "posegraph")
    frame = 0
    if config.resume_file:
        state, frame = load_state(config.resume_file, device)
        if mesh is not None:
            state = kf.local_state(state)
        if primary:
            print(f"resumed from {config.resume_file} at frame {frame}",
                  file=sys.stderr)
        for _ in range(frame):            # advance the reader cursor
            reader.get_next_frame()
    else:
        state = kf.init_state()
    if power is not None:
        power.start()

    def fence() -> float:
        synchronize(device)
        return time.monotonic()

    gate_period = math.lcm(config.tracking_rate, config.integration_rate)
    scan_ok = scan_chunk_ok(scan_chunk, gate_period, fused=fused,
                            spans=spans_enabled(), keyframes=pgkf is not None,
                            stats=stats,
                            breaks=(break_on_untracked
                                    or break_at_frame is not None),
                            debug_nans=debug_nans)
    xprof = XprofTrace(device) if xprof_enabled() else None
    # KERNEL_TIMINGS on the phased single-device route: every kernel its
    # own fenced dispatch (the JAX CLI's gate, frontend/benchmark.py:
    # 143-147).
    timed = (TimedRunner(kf) if spans_enabled() and mesh is None
             and not fused and pgkf is None else None)
    if mesh is not None and primary:
        route = ("CUDA graph replays" if kf._graph_route() else
                 "eager chunks (the group's collectives are host calls)")
        print(f"{mesh.describe()}; --scan-chunk route: {route}",
              file=sys.stderr)
    mesh_frame = None                 # (frame, tally) of the last window

    # Rank 0 alone writes the log (the other ranks' rows are the same).
    if not primary:
        logfile = open(os.devnull, "w")
    else:
        logfile = open(config.log_file, "w") if config.log_file else None
    logstream = logfile or sys.stdout
    phases = ("preprocessing", "tracking", "integration", "raycasting",
              "rendering")
    summary = {"frames": 0, "computation": [], "total": [],
               **{p: [] for p in phases}}
    pending: list = []                # frames read ahead but not run

    def next_frame():
        return pending.pop(0) if pending else reader.read_next_depth_frame()

    def run_chunk(state, depths: list, t0: float):
        """One batched dispatch of whole gate periods and its rows (the
        JAX CLI's chunk, frontend/benchmark.py:224-313)."""
        n = len(depths)
        pos_before = kf.get_position(state)
        stacked = kf.to_device(np.stack(depths))
        t1 = fence()
        phase = frame % gate_period
        tracing = xprof is not None and xprof.wants(
            ("scan", n, gate_period, phase))
        if tracing:
            xprof.start(n)
        if gate_period == 1:
            state, outs = kf.compute_frames_scan(state, stacked)
        else:
            state, outs = kf.compute_frames_scan_rated(
                state, stacked.reshape(-1, gate_period, *stacked.shape[1:]),
                tracking_rate=config.tracking_rate,
                integration_rate=config.integration_rate, phase=phase)
        t5 = fence()
        if tracing:
            xprof.stop()
        outs = {k: v.cpu().numpy() for k, v in outs.items()}
        # The images once, at the chunk's end, their time shared out.
        kf.render_depth_image(state)
        kf.render_track_image(state)
        if any((frame + i) % config.rendering_rate == 0 for i in range(n)):
            kf.render_volume_image(state)
        t6 = fence()
        per, per_r = (t5 - t1) / n, (t6 - t5) / n
        init = np.asarray(config.init_pose, np.float32)
        for i in range(n):
            acq = t1 - t0 if i == 0 else 0.0
            pos = pos_before if i == 0 else outs["pos"][i - 1] - init
            print(ROW % (frame + i, acq, 0.0, 0.0, 0.0, 0.0, per_r, per,
                         acq + per + per_r, pos[0], pos[1], pos[2],
                         int(outs["tracked"][i]), int(outs["integrated"][i])),
                  file=logstream)
            for name in phases[:-1]:
                summary[name].append(0.0)
            summary["rendering"].append(per_r)
            summary["computation"].append(per)
            summary["total"].append(acq + per + per_r)
            summary["frames"] += 1
        return state

    try:
        print(HEADER, file=logstream)
        t0 = time.monotonic()
        while max_frames is None or frame < max_frames:
            depth_np = next_frame()
            if depth_np is None:
                break
            if scan_ok and frame > 3:
                # Read ahead up to scan_chunk frames; run whole gate
                # periods, put the rest back for the next round.
                depths = [depth_np]
                while len(depths) < scan_chunk and (
                        max_frames is None
                        or frame + len(depths) < max_frames):
                    more = next_frame()
                    if more is None:
                        break
                    depths.append(more)
                n_use = len(depths) // gate_period * gate_period
                pending[:0] = depths[n_use:]
                if n_use:
                    state = run_chunk(state, depths[:n_use], t0)
                    frame += n_use
                    t0 = time.monotonic()
                    continue
                # Fewer frames than a gate period left: per-frame tail.
                scan_ok = False
                depth_np = pending.pop(0)
            depth = kf.to_device(depth_np)
            # Pose logged at frame start = the previous frame's result
            # (reference: benchmark.cpp:127-131).
            xt, yt, zt = kf.get_position(state)
            gates = frame_gates(frame, config.tracking_rate,
                                config.integration_rate)
            # (phase, state before, state after) for --debug-nans.
            written = []
            t1 = fence()
            path = ("keyframes" if pgkf is not None else
                    "timed" if timed is not None else
                    "fused" if fused else "phased")
            # Never a bootstrap frame (forced integrate, no raycast before
            # frame 3): an unrepresentative window.
            tracing = (xprof is not None and xprof.wants(
                ("frame", path, tuple(sorted(gates.items())))) and frame > 3)
            if tracing:
                xprof.start(1)
            if pgkf is not None:
                before = state
                state = pgkf.process_frame(state, depth, frame,
                                           config.tracking_rate,
                                           config.integration_rate)
                t5 = fence()
                t2 = t3 = t4 = t1
                written.append(("the frame", before, state))
            elif timed is not None:
                before = state
                state = timed.process_frame(state, depth, frame,
                                            config.tracking_rate,
                                            config.integration_rate)
                t5 = fence()
                t2 = t3 = t4 = t1
                written.append(("the frame", before, state))
            elif fused:
                before = state
                if mesh is not None:
                    mesh.reset_tally()
                state = kf.compute_frame(state, depth, **gates)
                t5 = fence()
                if mesh is not None:
                    mesh_frame = (frame, {k: dict(v)
                                          for k, v in mesh.tally.items()})
                t2 = t3 = t4 = t1
                written.append(("the frame", before, state))
            else:
                before = state
                state = kf.preprocessing(state, depth)
                t2 = fence()
                written.append(("preprocessing", before, state))
                before = state
                # A frame the tracking rate skips leaves the state alone,
                # as JAX's phased CLI does: its row repeats ``tracked``.
                if gates["tracking_on"]:
                    state = kf.tracking(state)
                t3 = fence()
                written.append(("tracking", before, state))
                before = state
                state = kf.integration(
                    state, integrate_frame=gates["integrate_frame"],
                    force_integrate=gates["force_integrate"])
                t4 = fence()
                written.append(("integration", before, state))
                before = state
                if gates["raycast_on"]:
                    state = kf.raycasting(state)
                t5 = fence()
                written.append(("raycasting", before, state))
            if tracing:
                xprof.stop()
            # Rendering (reference: benchmark.cpp:153-156).
            kf.render_depth_image(state)
            kf.render_track_image(state)
            if frame % config.rendering_rate == 0:
                kf.render_volume_image(state)
            t6 = fence()
            kf.timings.flush()
            if debug_nans:
                for phase, before, after in written:
                    check_nans(phase, frame, before, after)
            tracked = int(bool(state.tracked))
            integrated = int(bool(state.integrated))
            print(ROW
                  % (frame, t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4,
                     t6 - t5, t5 - t1, t6 - t0, xt, yt, zt, tracked,
                     integrated),
                  file=logstream)
            for name, dt in zip(phases, (t2 - t1, t3 - t2, t4 - t3,
                                         t5 - t4, t6 - t5)):
                summary[name].append(dt)
            summary["computation"].append(t5 - t1)
            summary["total"].append(t6 - t0)
            summary["frames"] += 1
            if power is not None:
                Stats.sample("frame", frame, StatType.FRAME)
                Stats.sample("computation", t5 - t1, StatType.TIME)
                Stats.sample("total", t6 - t0, StatType.TIME)
                power.sample()
            # Conditional breakpoints: the headless counterpart of the Qt
            # GUI's stat breakpoints (reference: qt/SlamBenchQt.cpp:430,
            # ApplicationWindow.cpp:1024-1060).
            if break_on_untracked and frame > 3 and not tracked:
                print(f"BREAK: untracked at frame {frame}", file=sys.stderr)
                frame += 1
                break
            if break_at_frame is not None and frame >= break_at_frame:
                print(f"BREAK: at frame {frame}", file=sys.stderr)
                frame += 1
                break
            frame += 1
            t0 = time.monotonic()
    finally:
        if logfile:
            logfile.close()
    if xprof is not None and primary:
        xprof.report()

    if config.checkpoint_file:
        whole = kf.full_state(state) if mesh is not None else state
        if primary:
            save_state(config.checkpoint_file, whole, frame)
            print(f"checkpoint written to {config.checkpoint_file}",
                  file=sys.stderr)

    if config.dump_volume_file:
        kf.dump_volume(state, config.dump_volume_file)
    if pgkf is not None:
        write_trajectories(pgkf, config.log_file or "benchmark")
        summary["posegraph"] = pgkf
    if power is not None and primary:
        Stats.print_all_data(sys.stderr)
        power.power_stats.print_all_data(sys.stderr)
    if mesh is not None:
        summary["mesh"] = mesh_summary(kf, mesh, mesh_frame)
        if primary:
            print("mesh summary: " + json.dumps(summary["mesh"]),
                  file=sys.stderr)
    if not quiet and primary and summary["frames"]:
        comp = float(np.mean(summary["computation"]))
        print(f"{summary['frames']} frames on {device}, computation mean "
              f"{comp:.6f} s/frame ({1.0 / comp:.2f} FPS)", file=sys.stderr)
    summary["state"] = state
    summary["kfusion"] = kf
    return summary


def mesh_summary(kf: ShardedKFusion, mesh: Mesh, mesh_frame) -> dict:
    """The mesh's record of a run: the collective tally of the last
    per-frame window and, past one rank, the lines where it differs from
    ``comm.analytic_traffic`` (at the whole ICP budget; empty when they
    agree), the replication checks made, and every rank's launches of
    the hand kernels (K1 on the bands, K1F, K2F; gathered, so every
    rank must call this)."""
    mine = torch.tensor([bilateral.launches, bilateral.fused_launches,
                         reduce.fused_launches], dtype=torch.float32,
                        device=mesh.device)
    per_rank = mesh.all_gather_rows(mine[None], "launch_count_all_gather")
    out = {"ranks": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device),
           "replication_checks": mesh.check_tally.get(
               "replication_check", {"count": 0})["count"],
           "launches": {k: [int(v) for v in per_rank[:, i].tolist()]
                        for i, k in enumerate(("K1", "K1F", "K2F"))}}
    if mesh_frame is not None:
        frame, tally = mesh_frame
        out.update(tally_frame=frame, tally=tally)
        if mesh.size > 1:          # one rank exchanges no halo
            out["analytic_mismatch"] = comm.tally_matches(
                tally, comm.analytic_traffic(kf))
    return out


def scan_chunk_ok(scan_chunk: int, gate_period: int, *, fused: bool,
                  spans: bool, keyframes: bool, stats: bool, breaks: bool,
                  debug_nans: bool) -> bool:
    """Whether ``--scan-chunk`` batches this run (the JAX CLI's
    ``scan_ok``, frontend/benchmark.py:187-210). A chunk has no
    per-frame host view, so every flag that needs one turns it off, and
    says so on stderr: a quiet downgrade would misattribute the numbers.
    The port adds KERNEL_TIMINGS spans (a graph replay cannot re-time
    them) and --debug-nans (it reads each phase's output)."""
    if scan_chunk <= 1:
        return False
    reasons = []
    if gate_period > scan_chunk:
        reasons.append(f"gate period {gate_period} > chunk")
    if not fused:
        reasons.append("requires --fused or --mesh")
    if spans:
        reasons.append("KERNEL_TIMINGS spans")
    if keyframes:
        reasons.append("--keyframes")
    if stats:
        reasons.append("--stats")
    if breaks:
        reasons.append("breakpoint flags")
    if debug_nans:
        reasons.append("--debug-nans")
    if reasons:
        print(f"--scan-chunk {scan_chunk} disabled ({', '.join(reasons)});"
              " running per-frame dispatch", file=sys.stderr)
    return not reasons


class XprofTrace:
    """``KERNEL_TIMINGS=xprof``: a ``torch.profiler`` trace of one
    dispatch whose signature already ran (the JAX CLI's route,
    frontend/benchmark.py:137-166, 421-450), written as
    ``kernels.trace.json`` into a new directory under ``$TMPDIR``; at the
    end its device events go to stderr as ``name ns`` lines."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seen: set = set()
        self.dir: Optional[str] = None
        self.frames = 0
        self._prof = None

    def wants(self, signature: tuple) -> bool:
        """Trace this dispatch? Only the first repeat of a signature: a
        first dispatch includes the CUDA graph's capture."""
        want = self.dir is None and signature in self.seen
        self.seen.add(signature)
        return want

    def start(self, frames: int) -> None:
        from torch.profiler import ProfilerActivity, profile
        # Without it CUPTI stays subscribed after the trace, and every
        # later eager frame on the H100 ran 35-40% slower (PERF.md §7).
        os.environ.setdefault("TEARDOWN_CUPTI", "1")
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.dir = tempfile.mkdtemp(prefix="slambench_xprof_")
        self.frames = frames
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> None:
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(
            os.path.join(self.dir, "kernels.trace.json"))
        self._prof = None

    def report(self, out=None) -> None:
        """Print the trace's device events, or why there are none."""
        out = sys.stderr if out is None else out
        if self.dir is None:
            print("xprof kernel attribution: no dispatch was traced — a "
                  "trace only wraps a repeat of a dispatch signature that "
                  "already ran (a first one includes the CUDA graph's "
                  "capture); run more frames past the bootstrap/first "
                  "chunk", file=out)
            return
        n = 0
        for path in xprof2log.find_trace_files(self.dir):
            for name, ns in xprof2log.kernel_events(
                    xprof2log.load_trace(path), device_only=True):
                print(f"{name} {ns:.0f}", file=out)
                n += 1
        if n:
            print(f"xprof kernel attribution: {n} events over "
                  f"{self.frames} frames ({self.dir})", file=out)
        else:
            print("xprof kernel attribution: no device lanes in trace "
                  "(KERNEL_TIMINGS=xprof attributes device dispatches; on "
                  "the CPU use KERNEL_TIMINGS=1)", file=out)


def write_trajectories(pgkf: PoseGraphKFusion, base: str) -> None:
    """The raw odometry and the graph-corrected trajectory in TUM format
    next to the log, and the graph's line on stderr."""
    raw = np.stack(pgkf._trajectory) if pgkf._trajectory \
        else np.zeros((0, 4, 4), np.float32)
    write_tum(base + ".kf_raw.tum", raw)
    write_tum(base + ".kf_corrected.tum", pgkf.corrected_trajectory())
    n_loops = sum(1 for (i, j, _T, _w) in pgkf.graph.edges if abs(i - j) > 1)
    print(f"keyframes: {len(pgkf.store.keyframes)}, graph edges: "
          f"{len(pgkf.graph.edges)} ({n_loops} loop closures); "
          f"trajectories: {base}.kf_raw.tum / {base}.kf_corrected.tum",
          file=sys.stderr)


def main(argv=None) -> int:
    """The CLI; a known failure prints its remedy (``hint: ...``) to
    stderr and re-raises."""
    try:
        return _main(argv)
    except Exception as exc:                   # noqa: BLE001
        hint = backend.explain_error(exc)
        if hint:
            print(f"hint: {hint}", file=sys.stderr)
        raise


def _main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag in NOT_PORTED_FLAGS:
        if any(a == flag or a.startswith(flag + "=") for a in argv):
            print(f"ERROR: {flag} is not ported to slambench_tpu_torch yet "
                  "(see ROADMAP.md)", file=sys.stderr)
            return 2

    def flag(name: str) -> bool:
        if name in argv:
            argv.remove(name)
            return True
        return False

    def value(name: str, default: Optional[str] = None) -> Optional[str]:
        if name not in argv:
            return default
        i = argv.index(name)
        text = argv[i + 1]
        del argv[i:i + 2]
        return text

    fused = flag("--fused")
    report = flag("--report-device")
    stats = flag("--stats")
    break_untracked = flag("--break-on-untracked")
    debug_nans = flag("--debug-nans")
    keyframes = flag("--keyframes")
    ba = flag("--ba")            # implies --keyframes
    break_at = value("--break-at-frame")
    scan_chunk = int(value("--scan-chunk", "0"))
    device_name = value("--device") or backend.device_name()
    try:
        device = resolve_device(device_name)
    except RuntimeError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        hint = backend.explain_error(exc)
        if hint:
            print(f"hint: {hint}", file=sys.stderr)
        return 1
    if report:
        device_report(device, sys.stderr)
    config = parse_args(argv)
    if not config.input_file:
        print("No input found.", file=sys.stderr)
        config.print_arguments()
        return 1
    try:
        run(config, device, fused=fused, stats=stats,
            break_on_untracked=break_untracked,
            break_at_frame=None if break_at is None else int(break_at),
            debug_nans=debug_nans, keyframes=keyframes, ba=ba,
            scan_chunk=scan_chunk)
    except NotImplementedError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 2
    except RuntimeError as exc:
        if not config.mesh or "--mesh" not in str(exc):
            raise
        print(f"ERROR: {exc}", file=sys.stderr)   # a world-size refusal
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
