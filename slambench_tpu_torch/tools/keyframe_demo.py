"""End-to-end drift correction: a long loop-closing run through the
port's CLI with the keyframe layer, ATE before and after in one command
(port of ``slambench_tpu/tools/keyframe_demo.py``).

It synthesizes a long orbiting clip with the port's generator (the
camera revisits its starting viewpoint every ``period`` frames: natural
loop closures), runs the port's benchmark ``run()`` once with
``--keyframes``, and evaluates both
trajectories the run exports against the exact ground truth:

  * raw odometry (frame-to-model tracking only), and
  * the graph-corrected export.

Prints one JSON line with both ATE-RMSE values and the graph stats.

Usage:
  python -m slambench_tpu_torch.tools.keyframe_demo [--frames 300]
      [--volume 64] [--image 160x120] [--out DIR] [--device cuda|cpu]

Without ``--out`` the clip and the logs go to a new directory under
``$TMPDIR`` (``tempfile.mkdtemp``), named in the JSON line's ``out``.

A coarse volume and fast motion are chosen deliberately: they make the
odometry drift visible, so the correction is measurable.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--volume", type=int, default=64)
    ap.add_argument("--image", default="160x120")
    ap.add_argument("--amp", type=float, default=0.35)
    ap.add_argument("--period", type=int, default=48)
    ap.add_argument("--out", default=None,
                    help="output directory (default: a new one under "
                         "$TMPDIR)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; an error without a card) or cpu")
    args = ap.parse_args(argv)

    from slambench_tpu_torch.config import Configuration
    from slambench_tpu_torch.eval.trajectory import ate_rmse, read_tum
    from slambench_tpu_torch.frontend import benchmark as fb
    from slambench_tpu_torch.io.synthetic import generate_dataset
    from slambench_tpu_torch.policy import resolve_device

    device = resolve_device(args.device)
    out = args.out or tempfile.mkdtemp(prefix="slambench_kf_demo_")
    W, H = (int(v) for v in args.image.lower().split("x"))
    man = generate_dataset(out, device, n_frames=args.frames,
                           image_size=(W, H), dim=(4.8,) * 3,
                           amp=args.amp, period=args.period)

    cfg = Configuration()
    cfg.input_file = man["raw"]
    cfg.log_file = os.path.join(out, "kf_demo.log")
    cfg.volume_resolution = (args.volume,) * 3
    cfg.volume_size = man["dim"]
    cfg.initial_pos_factor = man["init_pos_factor"]
    cfg.camera = man["camera"]
    cfg.camera_overrided = True
    cfg.pyramid = (6, 4, 4)

    summary = fb.run(cfg, device, quiet=True, keyframes=True)
    pg = summary["posegraph"]

    gt = np.asarray(man["poses"])[: summary["frames"], :3, 3]
    raw = read_tum(cfg.log_file + ".kf_raw.tum")
    corr = read_tum(cfg.log_file + ".kf_corrected.tum")
    # Alignment-free ATE (both trajectories share the GT's world frame).
    raw_ate = ate_rmse(raw, gt, align=False)
    corr_ate = ate_rmse(corr, gt, align=False)

    n_loops = sum(1 for (i, j, _T, _w) in pg.graph.edges if abs(i - j) > 1)
    print(json.dumps({
        "frames": summary["frames"],
        "volume": args.volume,
        "device": str(device),
        "keyframes": len(pg.store.keyframes),
        "edges": len(pg.graph.edges),
        "loop_closures": n_loops,
        "alignments": pg.alignments,
        "ate_rmse_raw_m": raw_ate,
        "ate_rmse_corrected_m": corr_ate,
        "drift_reduction": 1.0 - corr_ate / raw_ate if raw_ate > 0 else 0.0,
        "out": out,
        "log": cfg.log_file,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
