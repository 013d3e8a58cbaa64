"""Where the frame's time goes: phase wall times, device busy share and
kernel time by name, from ``torch.profiler`` over a steady-state window.

Synthesises the traj2-like clip on the device, runs ``--warmup`` frames
(bootstrap included) through the phased step, then fences and times each
phase of ``--frames`` more frames under the profiler. Prints one JSON
object (and writes it to ``--out`` when given):

* ``phase_ms``: mean fenced host wall time per phase and per frame;
* ``device_busy_ms`` / ``device_idle_share``: union of CUDA kernel
  intervals in the window over the window's wall time;
* ``kernel_launches_per_frame`` (every device event: kernels, copies,
  fills), ``htod_copies_per_frame`` (host-to-device copies, each of
  which the host waits for unless it is from pinned memory), the hand
  kernels' device time (``hand_kernels_ms``) and the top kernels by
  device time;
* JAX's integrate rows, after the window, on the last frame's pose and
  depth, each chained over ``--reps`` calls and timed by CUDA events:
  ``integrate_plus_mip`` (the monolithic integrate and the min-mip
  rebuild) and, when ``SLAMBENCH_INTEGRATE_BLOCKS`` gives the pipeline a
  block grid, ``integrate_blocks_<grid>_plus_mip`` with
  ``integrate_population`` (visible blocks and voxels at that pose;
  ``tools/scaling_report.py`` prefers this row, as JAX's does).

On the CPU (``--device cpu``) there is no device trace: the device
fields and the rows' times are null ("not measured").

Usage: [SLAMBENCH_INTEGRATE_BLOCKS=8x8x2] python -m
       slambench_tpu_torch.tools.profile_frame [--device cuda]
       [--volume 256] [--image 640x480] [--ratio 2] [--warmup 6]
       [--frames 3] [--reps 5] [--out profile.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from slambench_tpu_torch import params
from slambench_tpu_torch.geometry import get_camera_matrix, rigid_inverse
from slambench_tpu_torch.io.readers import RawDepthReader
from slambench_tpu_torch.io.synthetic import generate_dataset
from slambench_tpu_torch.ops.integrate import (
    block_visibility, integrate, integrate_blocks,
)
from slambench_tpu_torch.ops.raycast_fast import make_min_mip
from slambench_tpu_torch.pipeline import KFusion
from slambench_tpu_torch.policy import (
    apply_precision_policy, resolve_device, synchronize,
)
from slambench_tpu_torch.tools.timing import per_launch_ms

# Device-kernel name fragments of the hand kernels (ops/hopper/csrc).
HAND_KERNELS = {"K1 bilateral": "metre_bilateral_kernel",
                "K1F mm2m_bilateral": "mm2m_bilateral_kernel",
                "K2 reduce": "reduce_track_kernel",
                "K2F track_reduce": "track_reduce_kernel"}


def _device_events(prof):
    """(name, start_us, end_us) of every CUDA kernel event."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _union_us(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def integrate_rows(kf: KFusion, state, reps: int) -> dict:
    """JAX's integrate rows (``slambench_tpu/tools/profile_frame.py:
    282-335``) on ``state``'s pose and depth: ``{name: {"ms": ms a call
    or None on the CPU}}``, plus ``integrate_population`` with a block
    grid."""
    args = (state.float_depth, rigid_inverse(state.pose),
            get_camera_matrix(kf._k), kf.mu, params.MAX_WEIGHT,
            kf.volume_dimensions)
    nz, ny, nx = kf.integrate_block_grid
    fns = {"integrate_plus_mip": lambda t, w: integrate(t, w, *args)}
    if (nz, ny, nx) != (1, 1, 1):
        fns[f"integrate_blocks_{nz}x{ny}x{nx}_plus_mip"] = \
            lambda t, w: integrate_blocks(t, w, *args, n_z=nz, n_y=ny,
                                          n_x=nx)
    rows = {}
    for name, fn in fns.items():
        chain = {"tw": (state.tsdf, state.weight)}

        def call(fn=fn):
            t, w = fn(*chain["tw"])
            make_min_mip(t)
            chain["tw"] = (t, w)

        call()
        rows[name] = {"ms": per_launch_ms(call, reps, runs=3)[0]
                      if kf.device.type == "cuda" else None}
    if (nz, ny, nx) != (1, 1, 1):
        vis = block_visibility(nz, ny, kf.volume_dimensions, args[1],
                               args[2], state.float_depth, kf.mu, n_x=nx)
        block_voxels = state.tsdf.numel() // vis.numel()
        rows["integrate_population"] = {
            "live_blocks": int(vis.sum()), "total_blocks": vis.numel(),
            "live_voxels": int(vis.sum()) * block_voxels,
            "total_voxels": state.tsdf.numel()}
    return rows


def profile_frames(device: torch.device, volume: int, image, ratio: int,
                   warmup: int, frames: int, workdir: str,
                   reps: int = 5) -> dict:
    apply_precision_policy()
    W, H = image
    man = generate_dataset(workdir, device, n_frames=warmup + frames,
                           image_size=(W, H), dim=(4.8, 4.8, 4.8),
                           init_pos_factor=(0.34, 0.5, 0.24), amp=0.25,
                           period=60)
    camera = tuple(c / ratio for c in man["camera"])
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    kf = KFusion((W // ratio, H // ratio), (volume,) * 3, man["dim"], init,
                 (10, 5, 4), camera, device=device)
    reader = RawDepthReader(man["raw"])
    state = kf.init_state()
    for f in range(warmup):
        state = kf.process_frame(state, reader.read_next_depth_frame(), f,
                                 integration_rate=1)
    depths = [kf.to_device(reader.read_next_depth_frame())
              for _ in range(frames)]
    synchronize(device)

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    phase_s = defaultdict(float)
    with profile(activities=acts) as prof:
        t_start = time.monotonic()
        for depth in depths:
            steps = (
                ("preprocessing", lambda s: kf.preprocessing(s, depth)),
                ("tracking", kf.tracking),
                ("integration", lambda s: kf.integration(
                    s, integrate_frame=True, force_integrate=False)),
                ("raycasting", kf.raycasting))
            t = time.monotonic()
            for name, fn in steps:
                t2 = time.monotonic()
                state = fn(state)
                synchronize(device)
                phase_s[name] += time.monotonic() - t2
            phase_s["frame"] += time.monotonic() - t
        synchronize(device)
        wall_us = (time.monotonic() - t_start) * 1e6
    result = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "volume": volume, "compute_size": [W // ratio, H // ratio],
        "frames": frames, "tracked": bool(state.tracked),
        "phase_ms": {k: 1e3 * v / frames for k, v in phase_s.items()},
        "device_busy_ms": None, "device_idle_share": None,
        "kernel_launches_per_frame": None, "htod_copies_per_frame": None,
        "hand_kernels_ms": None,
        "top_kernels_ms": None,
    }
    if device.type == "cuda":
        ev = _device_events(prof)
        busy = _union_us([(s, e) for _, s, e in ev])
        by_name = defaultdict(float)
        for name, s, e in ev:
            by_name[name] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
        hand = {label: sum(us for n, us in by_name.items() if key in n)
                / 1e3 / frames for label, key in HAND_KERNELS.items()}
        result.update(
            device_busy_ms=busy / 1e3 / frames,
            device_idle_share=1.0 - busy / wall_us,
            kernel_launches_per_frame=len(ev) / frames,
            htod_copies_per_frame=sum(
                n.startswith("Memcpy HtoD") for n, _, _ in ev) / frames,
            hand_kernels_ms=hand,
            top_kernels_ms={n[:90]: us / 1e3 / frames for n, us in top})
    result["integrate_block_grid"] = list(kf.integrate_block_grid)
    result.update(integrate_rows(kf, state, reps))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--volume", type=int, default=256)
    ap.add_argument("--image", default="640x480")
    ap.add_argument("--ratio", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=6)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5,
                    help="chained calls a timing of the integrate rows")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    W, H = (int(v) for v in args.image.split("x"))
    with tempfile.TemporaryDirectory(prefix="slb_profile_") as work:
        result = profile_frames(device, args.volume, (W, H), args.ratio,
                                args.warmup, args.frames, work, args.reps)
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
