"""Readings for the limits of ``correct``, in one process on the card:

    python3 -m kfbench.calibrate --workload <cell> --seeds 1,2,3 \
        --standin-seeds 3 --seconds 15 [--out path.jsonl]

runs the cell once a seed (``run.run_cell``) and prints one JSON line a
seed: the five compared numbers of the program's run and, on the first
``--standin-seeds`` seeds, those of the control and of each planted
fault in the program's place on the window's last call
(``check.standin``), each judged against the committed limits. Not a
benchmark run: it prints no result line."""

from __future__ import annotations

import argparse
import json
import sys

from kfbench import check, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--standin-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = run.find_cell(args.workload)
    run.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        run.log("kfbench.calibrate: needs a CUDA card")
        return 3
    torch.set_num_threads(2)
    names = tuple(n for n in check.STANDINS
                  if n != "half_batch"
                  or cell["traffic"]["frames_per_call"] > 1)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = run.run_cell(cell, seed, args.seconds, False,
                           torch.device("cuda", 0),
                           standins=names if i < args.standin_seeds else ())
        line = json.dumps({
            "cell": cell["name"], "seed": seed, "correct": out["correct"],
            "numbers": {k: v["value"] for k, v in out["checks"].items()},
            "standins": {k: dict(v["numbers"], correct=v["correct"])
                         for k, v in out.get("standins", {}).items()},
            "metrics": {k: v["value"] for k, v in out["metrics"].items()}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    bad = run.forbidden_modules()
    if bad:
        run.log(f"kfbench.calibrate: modules loaded: {', '.join(bad)}")
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
