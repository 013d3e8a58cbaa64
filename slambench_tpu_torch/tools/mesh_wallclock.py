"""Measured wall clock of the sharded step at each rank count, on one
device (port of ``slambench_tpu/tools/mesh_wallclock.py``).

Every rank of an n-rank mesh shares the same device here (on one card,
over gloo past one rank; on the CPU, the same cores), so the curve can
show no speedup. What it measures is what the sharded program adds as
the mesh grows: the collectives (halo exchange, a psum an ICP
iteration, the raycast's pmin / psum and the gathers), the duplicated
replicated work, and any serialization, on an executed program. Each
rank count runs as its own ranks, started as subprocesses
(``parallel/distributed.launch``).

Frames run per frame, eagerly (``ShardedKFusion.process_frame``, -r 1)
at every rank count, so the counts compare like with like: the one-rank
NCCL mesh could replay a CUDA graph, which more ranks over gloo cannot.

Usage: python -m slambench_tpu_torch.tools.mesh_wallclock [--device cuda]
           [--ns 1,2,4] [--volume 64] [--image 160x120] [--frames 12]
           [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WARMUP = 5              # frames 0-4: the bootstrap, untimed


def _child(device: str, volume: int, image, frames: int, raw: str) -> None:
    from slambench_tpu_torch.io.readers import RawDepthReader
    from slambench_tpu_torch.parallel import distributed
    from slambench_tpu_torch.parallel.step import ShardedKFusion
    from slambench_tpu_torch.policy import (
        apply_precision_policy, synchronize,
    )

    torch.set_num_threads(1)
    apply_precision_policy()
    mesh = distributed.initialize(0, device)
    try:
        W, H = image
        ratio = 640 // W
        camera = tuple(c / ratio for c in (481.2, 480.0, 320.0, 240.0))
        kf = ShardedKFusion((W, H), (volume,) * 3, (4.8,) * 3,
                            (0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8), (10, 5, 4),
                            camera, mu=0.1, mesh=mesh)
        rd = RawDepthReader(raw)
        depths = [kf.to_device(rd.read_next_depth_frame())
                  for _ in range(WARMUP + frames)]
        state = kf.init_state()
        for f in range(WARMUP):
            state = kf.process_frame(state, depths[f], f, integration_rate=1)
        synchronize(kf.device)
        t0 = time.monotonic()
        for f in range(WARMUP, WARMUP + frames):
            state = kf.process_frame(state, depths[f], f, integration_rate=1)
        synchronize(kf.device)
        dt = time.monotonic() - t0
        if mesh.rank == 0:
            print(json.dumps({
                "n": mesh.size, "backend": mesh.backend,
                "device": (torch.cuda.get_device_name(kf.device)
                           if kf.device.type == "cuda" else "cpu"),
                "ms_per_frame": dt / frames * 1e3,
                "tracked": bool(state.tracked)}), flush=True)
    finally:
        mesh.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ns", default="1,2,4")
    ap.add_argument("--volume", type=int, default=64)
    ap.add_argument("--image", default="160x120")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--json", default="")
    ap.add_argument("--child-raw", default="")
    args = ap.parse_args(argv)
    image = tuple(int(v) for v in args.image.split("x"))
    if args.child_raw:
        _child(args.device, args.volume, image, args.frames, args.child_raw)
        return 0

    from slambench_tpu_torch.io.synthetic import generate_dataset
    from slambench_tpu_torch.parallel import distributed
    from slambench_tpu_torch.policy import resolve_device

    resolve_device(args.device)
    rows = []
    with tempfile.TemporaryDirectory(prefix="slb_mesh_wallclock_") as work:
        # The clip at 640x480, as the census and the bench; -c from --image.
        raw = generate_dataset(work, torch.device("cpu"),
                               n_frames=WARMUP + args.frames,
                               image_size=(640, 480), dim=(4.8,) * 3,
                               amp=0.25, period=60)["raw"]
        for n in [int(x) for x in args.ns.split(",")]:
            outs = distributed.launch(
                n, ["-m", "slambench_tpu_torch.tools.mesh_wallclock",
                    "--device", args.device, "--volume", str(args.volume),
                    "--image", args.image, "--frames", str(args.frames),
                    "--child-raw", raw], cwd=REPO)
            rc, out, err = outs[0]
            if any(o[0] for o in outs) or not out.strip():
                print(f"n={n} failed:\n" + "\n".join(
                    o[2][-2000:] for o in outs), file=sys.stderr)
                return 1
            rows.append(json.loads(out.strip().splitlines()[-1]))
            print(f"n={n}: {rows[-1]['ms_per_frame']:.3f} ms/frame "
                  f"({rows[-1]['backend']}) tracked={rows[-1]['tracked']}",
                  file=sys.stderr)
    base = rows[0]["ms_per_frame"]
    for r in rows:
        r["overhead_vs_first"] = r["ms_per_frame"] / base
    text = json.dumps({"volume": args.volume, "image": args.image,
                       "frames": args.frames,
                       "note": "every rank on one device: measures what "
                               "the sharded program adds, not speedup",
                       "rows": rows}, indent=1)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
