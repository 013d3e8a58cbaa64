"""ICP iteration census: the iterations each pyramid level needs, and
how many of the budget's K2F + ``updatePose`` launches run frozen (port
of ``slambench_tpu/tools/icp_census.py``).

The tracking phase budgets 10/5/4 iterations (coarse -> fine, reference:
kfusion/src/cpp/kernels.cpp:950-966, default_parameters.h:31) and stops
a level at ``|x| < icp_threshold`` (cpp:770-771 ``break``). JAX's
``while_loop`` stops there too; the port runs every level's whole budget
with no host read and freezes the state once a level converged
(``pipeline.py:KFusion._icp``), so every frame launches K2F and the pose
solve 19 times. This tool runs the bench scene through
``KFusion.tracking(census=True)`` (the pipeline's own loop, which counts
the iterations up to and including the first that converged) and
reports:

* per-frame executed-iteration counts, coarsest level first;
* per level the mean / median / max count and the share of frames that
  exhausted the budget (no convergence);
* the K2F launches a frame and how many of them were frozen work;
* the gathered reference-map elements a frame the census implies (6
  channels a pixel an iteration, ``ops/track.py``) and the tracking
  floor at ``--gather-ns`` ns an element.

``--gather-ns`` defaults to G1's measured rate on the H100 (see
``G1_NS_PER_LOOKUP``); JAX's default, 33 ns, is a TPU rate.

Iteration counts depend on convergence numerics, which move only at the
+-1-iteration margin between platforms (JAX's docstring names the same
FMA margin); the distribution is the evidence.

Usage: python -m slambench_tpu_torch.tools.icp_census [--device cuda]
           [--volume 256] [--frames 24] [--raw clip.raw]
           [--gather-ns 0.00833] [--motion-model none|cv] [--json f]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from slambench_tpu_torch.io.readers import RawDepthReader
from slambench_tpu_torch.io.synthetic import generate_dataset
from slambench_tpu_torch.pipeline import KFusion
from slambench_tpu_torch.policy import (
    apply_precision_policy, resolve_device, synchronize,
)

# G1 (ops/hopper/csrc/gather.cu, gather_flat) on the P2 probe: 2,097,152
# lookups from a 640x480 f32 image in 17.473 us on an NVIDIA H100 80GB
# HBM3 at a 700 W power limit (tools/mosaic_probe.py, PERF.md section 6).
G1_NS_PER_LOOKUP = 17.473e3 / 2_097_152


def read_frames(raw: str, need: int) -> list:
    rd = RawDepthReader(raw)
    out = []
    for _ in range(need):
        d = rd.read_next_depth_frame()
        if d is None:
            break
        out.append(np.ascontiguousarray(d))
    return out


def census(kf: KFusion, depths: list) -> list:
    """(frame, counts, convs) of every steady-state frame (> 3) of the
    bench schedule (-t 1 -r 1) through ``kf``; counts and flags are
    coarsest level first."""
    state = kf.init_state()
    rows = []
    for frame, d in enumerate(depths):
        state = kf.preprocessing(state, kf.to_device(d))
        state, counts, convs = kf.tracking(state, census=True)
        if frame > 3:
            rows.append((frame, counts.cpu().numpy(), convs.cpu().numpy()))
        state = kf.integration(state, integrate_frame=True,
                               force_integrate=(frame <= 3))
        if frame > 2:
            state = kf.raycasting(state)
    synchronize(kf.device)
    return rows


def summarize(rows: list, iterations, image, gather_ns: float) -> dict:
    """The census's report from ``census`` rows."""
    W, H = image
    levels = len(iterations)
    budgets = list(reversed(iterations))          # coarsest-first
    counts = np.stack([r[1] for r in rows]).astype(np.int64)  # [F, levels]
    convs = np.stack([r[2] for r in rows])
    npix = [(H >> (levels - 1 - i)) * (W >> (levels - 1 - i))
            for i in range(levels)]
    per_level = {}
    for i in range(levels):
        c = counts[:, i]
        per_level[f"L{levels - 1 - i}"] = {
            "budget": budgets[i],
            "mean": round(float(c.mean()), 2),
            "p50": int(np.percentile(c, 50)),
            "max": int(c.max()),
            "budget_exhausted_pct": round(
                100.0 * float(np.mean(~convs[:, i])), 1),
            "pixels": npix[i],
        }
    executed = counts.sum(axis=1)
    elems = (counts * 6 * np.asarray(npix)[None, :]).sum(axis=1)
    return {
        "frames": len(rows),
        "iterations_budget": budgets,
        "per_level": per_level,
        "per_frame": {int(r[0]): [int(v) for v in r[1]] for r in rows},
        "total_iters_mean": round(float(executed.mean()), 2),
        "total_iters_budget": int(sum(budgets)),
        "k2f_launches_per_frame": int(sum(budgets)),
        "frozen_k2f_per_frame_mean": round(
            float(sum(budgets) - executed.mean()), 2),
        "frozen_share": round(
            float(1.0 - executed.mean() / sum(budgets)), 4),
        "gathered_elems_per_frame_mean": int(elems.mean()),
        "gather_ns_per_elem": gather_ns,
        "tracking_floor_ms_at_rate": float(elems.mean()) * gather_ns * 1e-6,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--volume", type=int, default=256)
    ap.add_argument("--frames", type=int, default=24,
                    help="frames to run; steady state (frame > 3) is "
                         "what the census reports, so must be >= 5")
    ap.add_argument("--raw", default="",
                    help="a 640x480 .raw clip (default: synthesise the "
                         "traj2-like clip into a new temporary directory)")
    ap.add_argument("--gather-ns", type=float, default=G1_NS_PER_LOOKUP,
                    help="gather rate (ns an element) for the floor: by "
                         "default G1's measured rate on an H100 80GB HBM3 "
                         "at 700 W (PERF.md section 6)")
    ap.add_argument("--motion-model", default="none", choices=("none", "cv"))
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    if args.frames < 5:
        ap.error("--frames must be >= 5 (frames 0-3 are bootstrap; the "
                 "census reports steady-state frames only)")
    device = resolve_device(args.device)
    apply_precision_policy()

    with tempfile.TemporaryDirectory(prefix="slb_census_") as work:
        raw = args.raw
        if not raw:
            raw = generate_dataset(work, device, n_frames=args.frames,
                                   image_size=(640, 480), dim=(4.8,) * 3,
                                   amp=0.25, period=60)["raw"]
        depths = read_frames(raw, args.frames)
    W, H = 320, 240
    camera = tuple(c / 2 for c in (481.2, 480.0, 320.0, 240.0))
    init = (0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8)
    kf = KFusion((W, H), (args.volume,) * 3, (4.8,) * 3, init, (10, 5, 4),
                 camera, mu=0.1, backend="fast",
                 motion_model=args.motion_model, device=device)
    rows = census(kf, depths)
    if not rows:
        print(f"no steady-state frames ran ({raw} yielded {len(depths)} "
              "frames; need > 4)", file=sys.stderr)
        return 1
    res = summarize(rows, kf.iterations, (W, H), args.gather_ns)
    res["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
    text = json.dumps(res, indent=1)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
