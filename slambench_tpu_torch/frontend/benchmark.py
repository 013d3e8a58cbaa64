"""Headless benchmark front-end of the port: the counterpart of
``python -m slambench_tpu.frontend.benchmark``.

Reads depth frames, runs the four phases, and writes the reference's
14-column TSV log that ``eval/check_pos.py`` reads
(reference: kfusion/src/benchmark.cpp:47-190). Two timing modes:

  * phased (default): ``torch.cuda.synchronize()`` before every
    timestamp, the reference's ``synchroniseDevices()`` per phase;
  * fused (``--fused``): one fence per frame; per-phase columns are 0
    and ``computation`` holds the frame.

Rendering is not ported yet: the ``rendering`` column is always 0.
The device is ``cuda`` unless ``--device cpu`` is given; a missing card
is an error, never a quiet fallback to the CPU.

Usage:  python -m slambench_tpu_torch.frontend.benchmark -i scene.raw
        -o out.log [reference flags] [--fused] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from slambench_tpu_torch.config import Configuration, parse_args
from slambench_tpu_torch.io.readers import make_reader
from slambench_tpu_torch.pipeline import KFusion, frame_gates
from slambench_tpu_torch.policy import (
    apply_precision_policy, resolve_device, synchronize,
)

HEADER = ("frame\tacquisition\tpreprocessing\ttracking\tintegration"
          "\traycasting\trendering\tcomputation\ttotal    \tX          "
          "\tY          \tZ         \ttracked   \tintegrated")

# Front-end flags of the JAX CLI that this port does not implement yet
# (the config options --mesh, --checkpoint and --resume are refused by
# ``run``).
NOT_PORTED_FLAGS = ("--scan-chunk", "--keyframes", "--ba", "--stats",
                    "--break-on-untracked", "--break-at-frame",
                    "--debug-nans", "--report-device")


def run(config: Configuration, device: torch.device, fused: bool = False,
        max_frames: Optional[int] = None, quiet: bool = False) -> dict:
    """Run the benchmark on ``device``; returns summary statistics with
    per-frame phase times in seconds."""
    if config.mesh or config.checkpoint_file or config.resume_file:
        raise NotImplementedError(
            "--mesh, --checkpoint and --resume are not ported yet "
            "(ROADMAP.md, queue 1)")
    if os.environ.get("KERNEL_TIMINGS"):
        raise NotImplementedError(
            "KERNEL_TIMINGS per-kernel timing is not ported yet "
            "(ROADMAP.md, queue 1, item 9)")
    apply_precision_policy()
    reader = make_reader(config)
    if reader is None or not reader.camera_open:
        print("No input found.", file=sys.stderr)
        config.print_arguments()
        raise SystemExit(1)

    in_w, in_h = reader.get_input_size()
    ratio = config.compute_size_ratio
    W, H = in_w // ratio, in_h // ratio
    camera = tuple(c / ratio for c in (
        config.camera if config.camera_overrided else reader.get_k()))
    kf = KFusion((W, H), config.volume_resolution, config.volume_size,
                 config.init_pose, config.pyramid, camera, mu=config.mu,
                 icp_threshold=config.icp_threshold, backend=config.backend,
                 motion_model=config.motion_model, device=device)
    state = kf.init_state()

    def fence() -> float:
        synchronize(device)
        return time.monotonic()

    logfile = open(config.log_file, "w") if config.log_file else None
    logstream = logfile or sys.stdout
    phases = ("preprocessing", "tracking", "integration", "raycasting")
    summary = {"frames": 0, "computation": [], "total": [],
               **{p: [] for p in phases}}
    try:
        print(HEADER, file=logstream)
        frame = 0
        t0 = time.monotonic()
        while max_frames is None or frame < max_frames:
            depth_np = reader.read_next_depth_frame()
            if depth_np is None:
                break
            depth = kf.to_device(depth_np)
            # Pose logged at frame start = the previous frame's result
            # (reference: benchmark.cpp:127-131).
            xt, yt, zt = kf.get_position(state)
            gates = frame_gates(frame, config.tracking_rate,
                                config.integration_rate)
            t1 = fence()
            if fused:
                state = kf.compute_frame(state, depth, **gates)
                t5 = fence()
                t2 = t3 = t4 = t1
            else:
                state = kf.preprocessing(state, depth)
                t2 = fence()
                if gates["tracking_on"]:
                    state = kf.tracking(state)
                else:
                    state = kf.skip_tracking(state)
                t3 = fence()
                state = kf.integration(
                    state, integrate_frame=gates["integrate_frame"],
                    force_integrate=gates["force_integrate"])
                t4 = fence()
                if gates["raycast_on"]:
                    state = kf.raycasting(state)
                t5 = fence()
            t6 = time.monotonic()
            tracked = int(bool(state.tracked))
            integrated = int(bool(state.integrated))
            print("%d\t%.10f\t%.10f\t%.10f\t%.10f\t%.10f\t%.10f\t%.10f\t%.10f"
                  "\t%.10f\t%.10f\t%.10f\t%d        \t%d"
                  % (frame, t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4,
                     0.0, t5 - t1, t6 - t0, xt, yt, zt, tracked, integrated),
                  file=logstream)
            for name, dt in zip(phases, (t2 - t1, t3 - t2, t4 - t3,
                                         t5 - t4)):
                summary[name].append(dt)
            summary["computation"].append(t5 - t1)
            summary["total"].append(t6 - t0)
            summary["frames"] += 1
            frame += 1
            t0 = time.monotonic()
    finally:
        if logfile:
            logfile.close()

    if config.dump_volume_file:
        kf.dump_volume(state, config.dump_volume_file)
    if not quiet and summary["frames"]:
        comp = float(np.mean(summary["computation"]))
        print(f"{summary['frames']} frames on {device}, computation mean "
              f"{comp:.6f} s/frame ({1.0 / comp:.2f} FPS)", file=sys.stderr)
    summary["state"] = state
    summary["kfusion"] = kf
    return summary


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag in NOT_PORTED_FLAGS:
        if any(a == flag or a.startswith(flag + "=") for a in argv):
            print(f"ERROR: {flag} is not ported to slambench_tpu_torch yet "
                  "(see ROADMAP.md)", file=sys.stderr)
            return 2
    fused = "--fused" in argv
    if fused:
        argv.remove("--fused")
    device_name = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device_name = argv[i + 1]
        del argv[i:i + 2]
    try:
        device = resolve_device(device_name)
    except RuntimeError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    config = parse_args(argv)
    if not config.input_file:
        print("No input found.", file=sys.stderr)
        config.print_arguments()
        return 1
    try:
        run(config, device, fused=fused)
    except NotImplementedError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
