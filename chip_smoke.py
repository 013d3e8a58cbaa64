"""Smoke test of slambench_tpu_torch on one CUDA card (an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero and prints
no ``ok`` line):

1. device — require CUDA, print the card (nvidia-smi name, power limit),
   torch and CUDA versions; apply the full-f32 precision policy;
2. build — compile the hand-written kernels (K1 bilateral, K2 ICP
   reduction) from ``slambench_tpu_torch/ops/hopper/csrc`` with nvcc;
3. kernels — each kernel against its plain-torch version on the card at
   the main path's shapes (a synthetic 640x480 frame at compute-size
   ratio 2, its pyramid and real ICP TrackData), with median times over
   50 CUDA-event-timed calls;
4. main path — synthesise the traj2-like clip on the card, run the
   port's CLI ``run()`` phased at 256^3 / 4.8 m / 320x240 / pyramid
   10,5,4 / -r 1, check the ATE with the port's check_pos, the tracked
   flags, and that the launch counts of K1 and K2 match the frames and
   ICP iterations the run made;
5. report — one JSON line of kernel results, the nvidia-smi line, and
   the final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_FRAMES = 30
PYRAMID = (10, 5, 4)
CLI_ARGS = ["-s", "4.8", "-p", "0.34,0.5,0.24", "-z", "4", "-c", "2",
            "-r", "1", "-k", "481.2,480,320,240", "-v", "256,256,256"]
ATE_MEAN_BOUND = 0.03           # metres, the synth2 class (ROADMAP.md)
K1_TOL = dict(rtol=1e-5, atol=1e-5)
K2_TOL = dict(rtol=1e-4, atol=1e-3)   # tests/test_pallas.py tolerances


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, n: int = 50, warmup: int = 5) -> float:
    """Median of ``n`` per-call CUDA-event times, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol) -> float:
    torch.cuda.synchronize()
    g = got.detach().cpu().numpy()
    w = want.detach().cpu().numpy()
    np.testing.assert_allclose(g, w, equal_nan=True, err_msg=name, **tol)
    err = float(np.nanmax(np.abs(g.astype(np.float64) - w))) if g.size else 0.0
    log(f"  {name}: shape {tuple(g.shape)} max_abs_err {err:.3e} (ok)")
    return err


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is False; this "
                         "smoke test needs a CUDA card")
    from slambench_tpu_torch.policy import apply_precision_policy
    smi = nvidia_smi_line()
    log(f"[1/5 device] {smi} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    apply_precision_policy()
    return smi


def phase_build() -> None:
    from slambench_tpu_torch.ops.hopper import build
    t0 = time.monotonic()
    path = build.build()
    build.load()
    log(f"[2/5 build] {os.path.relpath(path)} in "
        f"{time.monotonic() - t0:.2f} s (nvcc {build.build_seconds:.2f} s)")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels(dev: torch.device) -> dict:
    from slambench_tpu_torch import geometry as G
    from slambench_tpu_torch.io.synthetic import (
        SyntheticScene, orbit_trajectory, render_depth_frame,
    )
    from slambench_tpu_torch.ops.hopper import bilateral, reduce
    from slambench_tpu_torch.ops.preprocess import (
        half_sample_robust, make_gaussian, mm2meters,
    )
    from slambench_tpu_torch.ops.track import track
    from slambench_tpu_torch.ops.vertex import depth2vertex, vertex2normal

    log("[3/5 kernels] kernel vs plain torch on the card")
    dim = (4.8, 4.8, 4.8)
    poses = orbit_trajectory(12, [0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8])
    depth_mm = render_depth_frame(SyntheticScene(dim=dim), poses[11],
                                  (481.2, 480.0, 320.0, 240.0), (640, 480),
                                  dev)
    fd = mm2meters(torch.from_numpy(depth_mm.astype(np.int32)).to(dev), 2) \
        .contiguous()
    lut = make_gaussian()

    got = bilateral.bilateral_filter_cuda(fd, lut)
    want = bilateral.plain(fd, lut)
    k1_err = compare("K1 bilateral 240x320", got, want, K1_TOL)
    k1_ms = median_ms(lambda: bilateral.bilateral_filter_cuda(fd, lut))
    k1_plain = median_ms(lambda: bilateral.plain(fd, lut))
    log(f"  K1 240x320: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms")

    # Real TrackData per pyramid level: the level maps against the
    # full-size level-0 maps under a small pose offset.
    k = torch.tensor([240.6, 240.0, 160.0, 120.0], device=dev)
    pyr = [want]
    for _ in range(2):
        pyr.append(half_sample_robust(pyr[-1], 0.3, 1))
    maps = []
    for i, d in enumerate(pyr):
        v = depth2vertex(d, G.get_inverse_camera_matrix(k / float(1 << i)))
        maps.append((v, vertex2normal(v)))
    pose = G.se3_exp(torch.tensor([0.01, -0.005, 0.008, 0.004, -0.003,
                                   0.002], device=dev))
    view = G.get_camera_matrix(k)
    cases = []
    for v, n in maps:
        cases.append((f"{v.shape[1]}x{v.shape[2]}",
                      track(v, n, maps[0][0], maps[0][1], pose, view)))
    rng = np.random.default_rng(0)
    for name, (h, w) in (("ragged 13x17", (13, 17)),
                         ("random codes 240x320", (240, 320))):
        cases.append((name, {
            "result": torch.from_numpy(rng.choice(
                [1, -1, -2, -3, -4, -5], size=(h, w)).astype(np.int32)).to(dev),
            "error": torch.from_numpy(rng.standard_normal(
                (h, w)).astype(np.float32)).to(dev),
            "J": torch.from_numpy(rng.standard_normal(
                (6, h, w)).astype(np.float32)).to(dev)}))
    k2_err = 0.0
    k2_times = {}
    for name, data in cases:
        got = reduce.reduce_track_cuda(data)
        want = reduce.plain(data)
        k2_err = max(k2_err, compare(f"K2 reduce {name}", got, want, K2_TOL))
        if name[0].isdigit():
            ms = median_ms(lambda: reduce.reduce_track_cuda(data))
            plain_ms = median_ms(lambda: reduce.plain(data))
            k2_times[name] = (ms, plain_ms)
            log(f"  K2 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"k1": (k1_err, k1_ms, k1_plain), "k2": (k2_err, k2_times)}


def phase_main_path(dev: torch.device, work: str) -> dict:
    from slambench_tpu_torch.config import parse_args
    from slambench_tpu_torch.eval.check_pos import (
        compute_ate, load_gt_trajectory, parse_benchmark_log,
    )
    from slambench_tpu_torch.frontend.benchmark import run
    from slambench_tpu_torch.io.synthetic import generate_dataset
    from slambench_tpu_torch.ops.hopper import bilateral, reduce

    log(f"[4/5 main path] traj2-like clip, {N_FRAMES} frames 640x480, "
        f"CLI {' '.join(CLI_ARGS)}")
    t0 = time.monotonic()
    man = generate_dataset(work, dev, n_frames=N_FRAMES,
                           image_size=(640, 480), dim=(4.8, 4.8, 4.8),
                           init_pos_factor=(0.34, 0.5, 0.24), amp=0.25,
                           period=60)
    log(f"  synthesised on the card in {time.monotonic() - t0:.2f} s")
    log_path = os.path.join(work, "benchmark.log")
    config = parse_args(["-i", man["raw"], "-o", log_path, *CLI_ARGS])

    bilateral.launches = 0
    reduce.launches = 0
    t0 = time.monotonic()
    summary = run(config, dev, quiet=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"K1": bilateral.launches, "K2": reduce.launches}

    logd = parse_benchmark_log(log_path)
    ate = compute_ate(logd, load_gt_trajectory(man["gt"]))["ATE"]
    tracked = logd["tracked"].astype(int)
    n = summary["frames"]
    icp_iters = sum(PYRAMID) * n          # -t 1: every frame tracks
    state = summary["state"]
    for name in ("ref_vertex", "ref_normal", "pose"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise RuntimeError(f"state.{name} holds non-finite values")
    if tuple(state.tsdf.shape) != (256, 256, 256) \
            or state.tsdf.dtype != torch.int16:
        raise RuntimeError(f"tsdf {tuple(state.tsdf.shape)} {state.tsdf.dtype}")
    if n != N_FRAMES:
        raise RuntimeError(f"ran {n} frames, expected {N_FRAMES}")
    if not tracked[5:].all():
        raise RuntimeError(f"untracked frames >= 5: "
                           f"{np.nonzero(tracked[5:] == 0)[0] + 5}")
    if not ate.mean() < ATE_MEAN_BOUND:
        raise RuntimeError(f"ATE mean {ate.mean():.5f} m >= {ATE_MEAN_BOUND}")
    if launches["K1"] != n:
        raise RuntimeError(f"K1 launches {launches['K1']} != frames {n}")
    if launches["K2"] != icp_iters:
        raise RuntimeError(f"K2 launches {launches['K2']} != ICP "
                           f"iterations {icp_iters}")

    steady = slice(5, None)
    ms = {k: 1e3 * float(np.mean(np.asarray(summary[k])[steady]))
          for k in ("preprocessing", "tracking", "integration",
                    "raycasting", "computation")}
    comp = 1e3 * np.asarray(summary["computation"])[steady]
    ms.update(computation_median=float(np.median(comp)),
              computation_p90=float(np.percentile(comp, 90)),
              steady_frames=int(comp.size),
              computation_all_frames=1e3 * float(np.mean(
                  summary["computation"])))
    log(f"  ATE mean {ate.mean():.5f} m, max {ate.max():.5f} m; tracked "
        f"{int(tracked.sum())}/{n}; launches {launches}; run {wall:.2f} s")
    log("  steady-state (frames 5..) ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items()))
    return {"launches": launches, "ate_mean": float(ate.mean()),
            "ate_max": float(ate.max()), "ms": ms}


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kr = phase_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="slb_smoke_") as work:
        mp = phase_main_path(dev, work)
    k1_err, k1_ms, k1_plain = kr["k1"]
    k2_err, k2_times = kr["k2"]
    k2_ms, k2_plain = k2_times["240x320"]
    kernels = {"kernels": [
        {"name": "K1 bilateral_filter", "route": "cuda",
         "source": "slambench_tpu_torch/ops/hopper/csrc/bilateral.cu",
         "replaces": "slambench_tpu/ops/pallas/bilateral.py:64",
         "launches": mp["launches"]["K1"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "K2 reduce_track", "route": "cuda",
         "source": "slambench_tpu_torch/ops/hopper/csrc/reduce.cu",
         "replaces": "slambench_tpu/ops/pallas/reduce.py:87",
         "launches": mp["launches"]["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]}
    log("[5/5 report]")
    log(json.dumps({"main_path": mp, "k2_ms_by_shape": k2_times}))
    log(json.dumps(kernels))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
