"""Absolute trajectory error (ATE) evaluation.

A copy of ``slambench_tpu/eval/check_pos.py`` (pure NumPy), kept in
the port because the JAX package cannot be imported without JAX.
Re-implementation of the reference's evaluation script
(reference: kfusion/thirdparty/checkPos.py): parses the 14-column
benchmark log, pads frames dropped in real-time mode with the last valid
pose (checkPos.py:53-57), aligns the estimated trajectory to the
ground-truth convention (y-axis sign flip + first-pose shift,
checkPos.py:104), and reports min/max/mean/total statistics per column
plus the per-frame ATE.

Usable both as a library (``compute_ate``) and as a CLI:
``python -m slambench_tpu_torch.eval.check_pos <benchmark.log> <gt.freiburg>``.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Tuple

import numpy as np

# 14-column schema (reference: benchmark.cpp:120-122; asserted by
# checkPos.py:41-46).
COLUMNS = [
    "frame", "acquisition", "preprocessing", "tracking", "integration",
    "raycasting", "rendering", "computation", "total", "X", "Y", "Z",
    "tracked", "integrated",
]

_LOG_RE = re.compile(
    r"([0-9]+)\s*\t" + 8 * r"([0-9.eE+-]+)\t" + 3 * r"([-0-9.eE+]+)\t"
    + r"([01])\s+([01])")

_GT_RE = re.compile(r"([0-9]+)" + 7 * r"\s+([-0-9e.E+]+)" + r"\s*")


def parse_benchmark_log(path: str) -> Dict[str, np.ndarray]:
    """Parse the 14-column TSV into named arrays; stops at the first
    non-matching line like the reference (checkPos.py:50-70)."""
    with open(path) as f:
        lines = f.read().split("\n")
    headers = lines[0].split("\t")
    headers = [h.strip() for h in headers if h.strip() != ""]
    if len(headers) != 14:
        raise ValueError(
            f"Wrong KFusion log file. Expected 14 columns but found {len(headers)}")
    data: Dict[str, List[float]] = {c: [] for c in COLUMNS}
    for line in lines[1:]:
        m = _LOG_RE.match(line)
        if not m:
            break
        for i, c in enumerate(COLUMNS):
            data[c].append(float(m.group(i + 1)))
    return {c: np.asarray(v) for c, v in data.items()}


def load_gt_trajectory(path: str) -> np.ndarray:
    """Ground-truth positions [N, 3] from an ICL-NUIM/freiburg file
    (columns 2-4, reference: checkPos.py:78-84)."""
    out = []
    for line in open(path):
        m = _GT_RE.match(line)
        if not m:
            break
        out.append([float(m.group(2)), float(m.group(3)), float(m.group(4))])
    return np.asarray(out)


def padded_trajectory(log: Dict[str, np.ndarray]
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Estimated trajectory with dropped frames padded by the last valid
    pose (reference: checkPos.py:50-67). Returns (positions [M, 3],
    valid mask [M], dropped_count)."""
    frames = log["frame"].astype(int)
    xyz = np.stack([log["X"], log["Y"], log["Z"]], axis=1)
    traj, valid = [], []
    last = None
    last_frame = -1
    dropped = 0
    for i, fr in enumerate(frames):
        gap = fr - last_frame - 1
        if gap > 0 and last is not None:
            dropped += gap
            for _ in range(gap):
                traj.append(last)
                valid.append(False)
        traj.append(xyz[i])
        valid.append(True)
        last = xyz[i]
        last_frame = fr
    return np.asarray(traj), np.asarray(valid), dropped


def compute_ate(log: Dict[str, np.ndarray], gt: np.ndarray
                ) -> Dict[str, np.ndarray]:
    """Per-frame ATE after the reference's alignment
    (reference: checkPos.py:95-133): estimated position is shifted by the
    first GT position with the y axis negated, then compared euclidean."""
    traj, valid, dropped = padded_trajectory(log)
    n = min(len(traj), len(gt))
    traj, valid, gt = traj[:n], valid[:n], gt[:n]
    first = gt[0]
    adj = np.stack([
        traj[:, 0] + first[0],
        -(traj[:, 1] + first[1]),
        traj[:, 2] + first[2],
    ], axis=1)
    ate = np.linalg.norm(adj - gt, axis=1)
    return {
        "ATE": ate,
        "ATE_wrt_kfusion": ate[valid],
        "valid": valid,
        "dropped": np.asarray(dropped),
    }


def print_statistics(log: Dict[str, np.ndarray],
                     ate: Dict[str, np.ndarray], out=sys.stdout) -> None:
    """Summary table in the reference's format (checkPos.py:139-155)."""
    print("\nA detailed statistical analysis is provided.", file=out)
    print("Runtimes are in seconds and the absolute trajectory error (ATE)"
          " is in meters.", file=out)
    print("The ATE measure accuracy, check this number to see how precise"
          " your computation is.", file=out)
    print("Acceptable values are in the range of few centimeters.", file=out)

    full = dict(log)
    full["ATE"] = ate["ATE"]
    if int(ate["dropped"]) > 0:
        full["ATE_wrt_kfusion"] = ate["ATE_wrt_kfusion"]
    for var in sorted(full.keys()):
        if any(s in var for s in
               ("X", "Y", "Z", "frame", "tracked", "integrated", "valid",
                "dropped")):
            continue
        v = full[var]
        if len(v) == 0:
            continue
        print("%20.20s" % var, end="", file=out)
        print("\tMin : %6.6f" % float(np.min(v)), end="", file=out)
        print("\tMax : %0.6f" % float(np.max(v)), end="", file=out)
        print("\tMean : %0.6f" % float(np.mean(v)), end="", file=out)
        print("\tTotal : %0.8f" % float(np.sum(v)), file=out)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("I need two parameters, the benchmark log file and the"
              " original scene camera position file.")
        return 1
    log = parse_benchmark_log(argv[0])
    gt = load_gt_trajectory(argv[1])
    ate = compute_ate(log, gt)
    nvalid = len(log["frame"])
    # Field-for-field the reference's resume-log banner, including its
    # spacing quirks (reference: checkPos.py:87-91): padded-trajectory
    # length (pre-truncation), GT length, their min, and the tracked==0
    # row count.
    n_kf = nvalid + int(ate["dropped"])
    # The reference initializes its counter to -4 (checkPos.py:33
    # ``untracked = -4``) so the banner reports (rows with tracked==0)
    # minus 4 — discounting the bootstrap frames. Quirk reproduced for
    # field-for-field resume-log parity (same policy as the bilateral
    # border bug).
    untracked = int(np.sum(log["tracked"] == 0)) - 4
    print("KFusion valid frames %d,  dropped frames: %d"
          % (nvalid, int(ate["dropped"])))
    print("KFusion result        : %d positions." % n_kf)
    print("NUIM  result        : %d positions." % len(gt))
    print("Working position is : %d" % min(n_kf, len(gt)))
    print("Untracked frames: %d" % untracked)
    print("Shift KFusion trajectory...")
    print_statistics(log, ate)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
