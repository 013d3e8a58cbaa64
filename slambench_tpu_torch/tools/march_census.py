"""Per-ray march substep census on the traj2-like clip (port of
``slambench_tpu/tools/march_census.py``).

The march is lockstep: every substep of ``ops/raycast_fast.py:
mip_march`` samples all rays, finished ones included, so its cost is
set by the longest ray, and "where do the substeps go" needs the per-ray
distribution, not the mean. This tool runs the port's min-mip march
rules (the same samplers, ``raycast_fast.march_samplers``, and the same
substep) with per-ray counters on the clip's volume after ``--frames``
frames, from the pose of the last one, and reports:

* the substep histogram over rays: mean, p50, p90, p99, max, hit rate;
* the totals by step class: empty-cell skip, fine step (f < 0.8), large
  step;
* the rays still live after ``MARCH_PHASE1`` substeps (rounded up to
  whole ``MARCH_UNROLL`` groups) against ``march_two_phase``'s slots,
  and so the branch the two-phase march takes;
* the budget that the CUDA graph route runs (phase 1 + ``max_iters``,
  single-phase, every ray) beside the substeps the early-exit routes
  run, and the ray-substeps (rays x substeps, the lockstep work) of each
  route: the full-budget march's share;
* ``raycast_fast``'s own counters for the same view, both routes.

Trip counts depend only on geometry; the volume is the one the port's
pipeline fuses on ``--device``.

Usage: python -m slambench_tpu_torch.tools.march_census [--device cuda]
           [--volume 256] [--frames 8] [--raw clip.raw] [--json f]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.geometry import get_inverse_camera_matrix, mat4mul
from slambench_tpu_torch.io.readers import RawDepthReader
from slambench_tpu_torch.io.synthetic import generate_dataset
from slambench_tpu_torch.ops import raycast_fast as rf
from slambench_tpu_torch.ops.raycast import camera_rays, ray_box_clip
from slambench_tpu_torch.pipeline import KFusion
from slambench_tpu_torch.policy import (
    apply_precision_policy, resolve_device, synchronize,
)

MAX_SUBSTEPS = 2000         # JAX's census cap


def march_census(tsdf: torch.Tensor, mip: torch.Tensor, dim, view,
                 image_size, step: float, large_step: float,
                 near_plane: float = params.NEAR_PLANE,
                 far_plane: float = params.FAR_PLANE,
                 m: int = rf.MIP_BLOCK, max_d: int = rf.SKIP_MAX_D,
                 unroll: int = rf.MARCH_UNROLL) -> dict:
    """Per-ray counters [H, W] of the min-mip march from ``view``:
    ``count`` (substeps the ray was live in), ``empty`` / ``fine`` /
    ``large`` (of those, an empty-cell skip, a fine step, a large step)
    and ``hit``. The march runs until no ray is live (tested every
    ``unroll`` substeps) or ``MAX_SUBSTEPS``."""
    origin, direction = camera_rays(view, image_size)
    tnear, tfar = ray_box_clip(origin, direction, dim, near_plane,
                               far_plane)
    sample_t, dist_exit_t = rf.march_samplers(
        tsdf, mip, dim, origin, step, m, max_d)(direction)
    f0, _ = sample_t(tnear)
    zeros = torch.zeros(tnear.shape, dtype=torch.int32, device=tnear.device)
    s = dict(t=tnear, stepsize=torch.full_like(tnear, large_step),
             done=~((tnear < tfar) & (f0 > 0)),
             hit=torch.zeros_like(tnear, dtype=torch.bool), count=zeros,
             empty=zeros, fine=zeros, large=zeros)

    def substep(s):
        live = ~s["done"]
        f_tt, d_val = sample_t(s["t"])
        empty = d_val >= 1
        is_hit = live & ~empty & (f_tt < 0.0)
        new_step = torch.where(f_tt < 0.8, step, s["stepsize"])
        t_step = s["t"] + new_step
        t_next = torch.where(
            empty, torch.maximum(dist_exit_t(s["t"], d_val), t_step), t_step)
        cont = live & ~is_hit
        t = torch.where(cont, t_next, s["t"])
        occ = live & ~empty
        return dict(
            t=t, stepsize=torch.where(cont & ~empty, new_step, s["stepsize"]),
            done=s["done"] | is_hit | (cont & (t >= tfar)),
            hit=s["hit"] | is_hit,
            count=s["count"] + live.to(torch.int32),
            empty=s["empty"] + (live & empty).to(torch.int32),
            fine=s["fine"] + (occ & (f_tt < 0.8)).to(torch.int32),
            large=s["large"] + (occ & (f_tt >= 0.8)).to(torch.int32))

    iters = 0
    while iters < MAX_SUBSTEPS and bool((~s["done"]).any()):
        for _ in range(unroll):
            s = substep(s)
        iters += unroll
    return {k: s[k] for k in ("count", "empty", "fine", "large", "hit")}


def summarize(c: dict, npix: int, budgets, slot_frac: int) -> dict:
    """The report from ``march_census`` counters (numpy) and the march
    budgets ``(max_iters, phase 1, phase 2)``."""
    count = c["count"].reshape(-1).astype(np.int64)
    total = max(int(count.sum()), 1)
    _, b1, b2 = budgets
    slots = max(128, -(-npix // slot_frac) // 128 * 128)
    live_after = int((count > b1).sum())
    longest = int(count.max())
    return {
        "rays": npix,
        "mean": round(float(count.mean()), 2),
        "p50": int(np.percentile(count, 50)),
        "p90": int(np.percentile(count, 90)),
        "p99": int(np.percentile(count, 99)),
        "max": longest,
        "hit_rate": round(float(c["hit"].mean()), 4),
        "class_pct": {k: round(100.0 * float(c[k].sum()) / total, 1)
                      for k in ("empty", "fine", "large")},
        "phase1_substeps": b1,
        "live_after_phase1": live_after,
        "slots": slots,
        "branch": ("none" if live_after == 0 else
                   "compact" if live_after <= slots else "full"),
        "graph_budget_substeps": b1 + b2,
        "ray_substeps_needed": total,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--volume", type=int, default=256)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--raw", default="",
                    help="a 640x480 .raw clip (default: synthesise the "
                         "traj2-like clip into a new temporary directory)")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    if args.frames < 4:
        ap.error("--frames must be >= 4 (the raycast starts at frame 3)")
    device = resolve_device(args.device)
    apply_precision_policy()

    W, H = 320, 240
    camera = tuple(c / 2 for c in (481.2, 480.0, 320.0, 240.0))
    init = (0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8)
    dim = (4.8,) * 3
    kf = KFusion((W, H), (args.volume,) * 3, dim, init, (10, 5, 4), camera,
                 mu=0.1, backend="fast", device=device)
    with tempfile.TemporaryDirectory(prefix="slb_march_") as work:
        raw = args.raw or generate_dataset(
            work, device, n_frames=args.frames, image_size=(640, 480),
            dim=dim, amp=0.25, period=60)["raw"]
        rd = RawDepthReader(raw)
        state = kf.init_state()
        for f in range(args.frames):
            state = kf.process_frame(state, rd.read_next_depth_frame(), f,
                                     1, 1)
    view = mat4mul(state.pose, get_inverse_camera_matrix(kf._k))
    large_step = 0.75 * kf.mu
    c = march_census(state.tsdf, state.mip, dim, view, (H, W), kf.step,
                     large_step)
    c = {k: v.cpu().numpy() for k, v in c.items()}
    budgets = rf.march_budgets(dim, state.tsdf.shape, kf.step, large_step,
                               params.NEAR_PLANE, params.FAR_PLANE)
    res = summarize(c, W * H, budgets, rf.MARCH_SLOT_FRAC)
    res["knobs"] = rf.read_knobs()
    # raycast_fast's counters on the same view: the per-frame route and
    # the graph route's full budget.
    args_rc = (state.tsdf, state.mip, dim, view, (H, W), params.NEAR_PLANE,
               params.FAR_PLANE, kf.step, large_step)
    for route, early in (("per_frame", True), ("graph", False)):
        rf.reset_counters()
        rf.raycast_fast(*args_rc, early_exit=early)
        res[f"counters_{route}"] = dict(rf.march_counts,
                                        substeps=rf.march_substeps)
    synchronize(device)
    res["frames"] = args.frames
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
    sys.exit(main())
