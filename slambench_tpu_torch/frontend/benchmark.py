"""Headless benchmark front-end of the port: the counterpart of
``python -m slambench_tpu.frontend.benchmark``.

Reads depth frames, runs the four phases, renders the diagnostic
images, and writes the reference's 14-column TSV log that
``eval/check_pos.py`` reads (reference: kfusion/src/benchmark.cpp:47-190).
Two timing modes:

  * phased (default): ``torch.cuda.synchronize()`` before every
    timestamp, the reference's ``synchroniseDevices()`` per phase;
  * fused (``--fused``): one fence for the frame's computation;
    per-phase columns are 0 and ``computation`` holds the frame.

In both, the rendering phase (the depth and track images every frame,
the shaded volume every ``rendering_rate`` frames) is fenced on its own
and written to the ``rendering`` column; ``total`` includes it.
``--checkpoint FILE`` saves the state after the loop and ``--resume
FILE`` continues from one (the JAX package's ``.npz``; either package's
file loads in the other). With KERNEL_TIMINGS set, each frame's kernel
spans go to stderr as ``name ns size`` lines
(``eval/check_kernels.py`` reads them).

The device is ``cuda`` unless ``--device cpu`` is given; a missing card
is an error, never a quiet fallback to the CPU.

Usage:  python -m slambench_tpu_torch.frontend.benchmark -i scene.raw
        -o out.log [reference flags] [--fused] [--device cuda|cpu]
"""

from __future__ import annotations

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
from slambench_tpu_torch.utils.checkpoint import load_state, save_state

HEADER = ("frame\tacquisition\tpreprocessing\ttracking\tintegration"
          "\traycasting\trendering\tcomputation\ttotal    \tX          "
          "\tY          \tZ         \ttracked   \tintegrated")

# Front-end flags of the JAX CLI that this port does not implement yet
# (the config option --mesh is refused by ``run``).
NOT_PORTED_FLAGS = ("--scan-chunk", "--keyframes", "--ba", "--stats",
                    "--break-on-untracked", "--break-at-frame",
                    "--debug-nans", "--report-device")


def run(config: Configuration, device: torch.device, fused: bool = False,
        max_frames: Optional[int] = None, quiet: bool = False) -> dict:
    """Run the benchmark on ``device``; returns summary statistics with
    per-frame phase times in seconds. ``max_frames`` is the frame index
    to stop at (a resumed run starts at the checkpoint's frame)."""
    if config.mesh:
        raise NotImplementedError(
            "--mesh is not ported yet (ROADMAP.md, queue 1, item 14)")
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
    frame = 0
    if config.resume_file:
        state, frame = load_state(config.resume_file, device)
        print(f"resumed from {config.resume_file} at frame {frame}",
              file=sys.stderr)
        for _ in range(frame):            # advance the reader cursor
            reader.get_next_frame()
    else:
        state = kf.init_state()

    def fence() -> float:
        synchronize(device)
        return time.monotonic()

    logfile = open(config.log_file, "w") if config.log_file else None
    logstream = logfile or sys.stdout
    phases = ("preprocessing", "tracking", "integration", "raycasting",
              "rendering")
    summary = {"frames": 0, "computation": [], "total": [],
               **{p: [] for p in phases}}
    try:
        print(HEADER, file=logstream)
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
            # Rendering (reference: benchmark.cpp:153-156).
            kf.render_depth_image(state)
            kf.render_track_image(state)
            if frame % config.rendering_rate == 0:
                kf.render_volume_image(state)
            t6 = fence()
            kf.timings.flush()
            tracked = int(bool(state.tracked))
            integrated = int(bool(state.integrated))
            print("%d\t%.10f\t%.10f\t%.10f\t%.10f\t%.10f\t%.10f\t%.10f\t%.10f"
                  "\t%.10f\t%.10f\t%.10f\t%d        \t%d"
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
            frame += 1
            t0 = time.monotonic()
    finally:
        if logfile:
            logfile.close()

    if config.checkpoint_file:
        save_state(config.checkpoint_file, state, frame)
        print(f"checkpoint written to {config.checkpoint_file}",
              file=sys.stderr)

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
