"""Run one benchmark cell once and print its result line.

    python3 -m kfbench.run --workload <config>.<mix> --seed <n> \
        --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found
by name: ``BENCHMARK.json`` at the root of the checkout lists the cells;
``kfbench/configs/<config>.json`` holds a deployment's settings,
``kfbench/traffic/<mix>.json`` a traffic mix's parameters,
``kfbench/limits/<cell>.json`` the limits of the numbers that decide
``correct``, and ``kfbench/metrics/<metric>.py`` the reader of each
metric. A run:

1. makes the deployment's frames on the card from the seed
   (``scene.py``) and builds ``slambench_tpu_torch.pipeline.KFusion``
   with the configuration's backend and motion model and the program's
   defaults otherwise (no ``SLAMBENCH_*`` knob is set);
2. runs frames 0-4 eagerly with the reference's gates, then warms the
   mix's one graph signature with two calls on a copy of the state;
3. measures for ``--seconds``: the mix's calls of
   ``KFusion.compute_frames_scan`` back to back (``Mix``), ending with a
   synchronize;
4. with ``--trace 1``, traces a few more calls and times each phase as
   a graph of its own (``trace.py``, ``phases.py``);
5. frees the program and compares what the window produced with the
   plain reference (``check.py``).

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its
limit); the last lines of standard error repeat the checks. A run
without a CUDA card, without the port's package beside this folder, or
with ``jax``, ``jaxlib``, ``flax`` or ``slambench_tpu`` loaded once the
window has closed exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "kfbench"
CACHE = ROOT / ".kfbench_cache"
PORT = "slambench_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "slambench_tpu")
SETUP_FRAMES = 5          # frames 0-4 run eagerly in set-up
PHASE_FRAMES = 8          # frames of a traced run's phase timing


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    mix, limits and metrics, each read from its own file."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(sorted(cells))}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def listed(m):
        return "workloads" not in m or name in m["workloads"]
    return {"name": name, "chips": w["chips"],
            "config": load_json(root / conf["file"]),
            "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
            "per_layer": [m for m in bench["per_layer"] if listed(m)]}


def reader(metric: str):
    """``read(ctx)`` of ``kfbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"kfbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def make_kfusion(setting: dict, device):
    """The program's pipeline for a configuration: its sizes, backend and
    motion model, the program's defaults otherwise."""
    from slambench_tpu_torch.pipeline import KFusion
    iw, ih = setting["input_size"]
    r = int(setting["compute_size_ratio"])
    dim = tuple(setting["volume_size"])
    init = tuple(f * d for f, d in zip(setting["init_pose"], dim))
    return KFusion((iw // r, ih // r), tuple(setting["volume_resolution"]),
                   dim, init, tuple(setting["pyramid"]),
                   tuple(c / r for c in setting["camera"]),
                   mu=setting["mu"], icp_threshold=setting["icp_threshold"],
                   backend=setting["backend"],
                   motion_model=setting["motion_model"], device=device)


# The functions of ``slambench_tpu_torch.pipeline`` that pick the frame
# step's integrate and march, with what each is.
ROUTE = {
    "integrate": "the monolithic integrate (ops/integrate.py:integrate)",
    "integrate_blocks": "the frustum-culled block integrate "
                        "(ops/integrate.py:integrate_blocks)",
    "raycast_maps": "the two-speed trilinear march of the reference "
                    "(ops/raycast.py:masked_march)",
    "raycast_fast_maps": "the min-mip march with rescan_refine "
                         "(ops/raycast_fast.py)",
}


@contextlib.contextmanager
def route_census():
    """Count, while the block runs, each call of a ``ROUTE`` function of
    the program's pipeline with how it was called (the integrate's gate
    on the device or on the host, the march's early exit): what the
    frame step ran, read from the program and not assumed."""
    from slambench_tpu_torch import pipeline
    seen: collections.Counter = collections.Counter()
    saved = {name: getattr(pipeline, name) for name in ROUTE}

    def counted(name, fn):
        def call(*args, **kw):
            if name.startswith("integrate"):
                how = ("gated on the device" if kw.get("gate") is not None
                       else "gated on the host")
            else:
                how = f"early_exit={kw.get('early_exit', True)}"
            seen[(name, how)] += 1
            return fn(*args, **kw)
        return call
    for name, fn in saved.items():
        setattr(pipeline, name, counted(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(pipeline, name, fn)


def describe_route(seen) -> str:
    return "; ".join(f"{ROUTE[name]}, {how}, {n} calls"
                     for (name, how), n in sorted(seen.items())) or "none"


def setup_gates(frame: int) -> dict:
    """The ``-r 1`` gates of the first frames (``bench.py``)."""
    return dict(tracking_on=True, integrate_frame=True,
                force_integrate=frame <= 3, raycast_on=frame > 2)


class Mix:
    """A traffic mix's calls of ``KFusion.compute_frames_scan``, read from
    its parameters: ``frames_per_call``, ``hand_in`` ("device": int32
    frames already on the card, stacked in set-up; "host_uint16": each
    call's frames handed in from host memory as uint16) and
    ``pose_readback`` ("after_window": positions stay on the card until
    the window has closed; "each_call": each call's positions are read
    to the host before the next call, and a call's latency runs from the
    hand-in to the positions on the host)."""

    def __init__(self, kf, stream: dict, traffic: dict, period: int):
        from kfbench import scene
        self.kf, self.stream, self.period = kf, stream, period
        self.n = int(traffic["frames_per_call"])
        self.hand_in = traffic["hand_in"]
        self.each_call = traffic["pose_readback"] == "each_call"
        if self.hand_in not in ("device", "host_uint16"):
            raise ValueError(f"hand_in {self.hand_in!r}")
        if self.hand_in == "host_uint16":
            self.host = stream["depth"].cpu().numpy().astype("uint16")
        self._cache: dict = {}
        self._index = scene.frame_index

    def frames(self, first: int) -> tuple:
        return tuple(self._index(f, self.period)
                     for f in range(first, first + self.n))

    def inputs(self, first: int):
        """The call's frames as the mix hands them in."""
        key = self.frames(first)
        if self.hand_in == "host_uint16":
            if key == tuple(range(key[0], key[0] + self.n)):
                return self.host[key[0]:key[0] + self.n]
            return self.host[list(key)]
        got = self._cache.get(key)
        if got is None:
            import torch
            got = self._cache[key] = self.stream["depth"][
                torch.as_tensor(key, device=self.stream["depth"].device)]
        return got

    def prepare(self, first: int, calls: int) -> None:
        """Stack the device frames of ``calls`` calls from ``first`` and
        of one whole cycle of the lap, so the window stacks nothing."""
        if self.hand_in != "device":
            return
        for k in range(calls + self.period):
            self.inputs(first + k * self.n)

    def window(self, state, first: int, seconds: float, reservoir,
               events: bool = False) -> dict:
        """Calls back to back from stream frame ``first`` until
        ``seconds`` have passed, then a synchronize."""
        import torch
        dev = self.kf.device
        cuda = dev.type == "cuda"
        rows, tracked, lat, host_ms = [], [], [], []
        ahead, done_at = [], []
        start = None
        calls, f = 0, first
        t0 = time.perf_counter()
        while True:
            inp = self.inputs(f)
            t_in = time.perf_counter()
            if events and cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            out, tr = self.kf.compute_frames_scan(state, inp)
            if events and cuda:
                e1.record()
            if self.each_call:
                pos = tr["pos"].cpu()
                t_out = time.perf_counter()
                lat.append(t_out - t_in)
                if events and cuda:
                    host_ms.append(1e3 * (t_out - t_in)
                                   - e0.elapsed_time(e1))
            else:
                pos = tr["pos"]
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record()
                    ahead.append(ev)
                    if len(ahead) > 2:       # at most two calls queued
                        ahead.pop(0).synchronize()
                        done_at.append(time.perf_counter())
            rows.append(pos)
            tracked.append(tr["tracked"])
            if calls == 0:
                start = {"rows": pos}
            reservoir.offer(calls, f, state, out, pos)
            state = out
            calls += 1
            f += self.n
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
        paced = [b - a for a, b in zip(done_at, done_at[1:])] or lat
        if paced:
            log("call ms in order: " + " ".join(f"{1e3 * x:.1f}"
                                                for x in paced))
            slow = sum(x > 1.05 * min(paced) for x in paced)
            log(f"calls over 1.05x the fastest (the card's slow state, "
                f"PERF.md): {slow} of {len(paced)}")
        return {"state": state, "next": f, "calls": calls,
                "frames": calls * self.n, "window_s": window_s,
                "rows": rows, "tracked": tracked, "latencies_s": lat,
                "host_ms": host_ms, "start": start}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, standins: tuple = ()) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's
    object (``checks`` last) and prints the earlier lines. ``standins``
    (``check.STANDINS``; not a benchmark run) judges each named stand-in
    in the program's place too, on the window's last call, and adds
    their numbers and verdicts under ``standins`` before ``checks``."""
    import numpy as np
    import torch

    from kfbench import check, launch_probe, phases, scene, stats
    from kfbench import trace as tracing
    from kfbench.reference import Reference
    from slambench_tpu_torch import policy

    policy.apply_precision_policy()
    setting, traffic = cell["config"], cell["traffic"]
    period = int(setting["orbit"]["period"])
    cuda = device.type == "cuda"

    marks = [("start", t_start), ("imports", time.perf_counter())]
    stream = scene.make_stream(setting, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    marks.append(("frames", time.perf_counter()))
    kf = make_kfusion(setting, device)
    log(f"cell {cell['name']} seed {seed}: orbit direction "
        f"{stream['direction']:+d}, {len(stream['poses'])} frames made")

    state = kf.init_state()
    setup_rows = []
    for frame in range(SETUP_FRAMES):
        state = kf.compute_frame(state, stream["depth"][frame],
                                 **setup_gates(frame))
        setup_rows.append(state.pose[:3, 3].double().cpu().numpy())
    marks.append(("frames 0-4", time.perf_counter()))
    mix = Mix(kf, stream, traffic, period)
    mix.prepare(SETUP_FRAMES, 2)
    scratch = state
    with route_census() as seen:
        for _ in range(2):                 # capture, then a replay
            scratch, tr = kf.compute_frames_scan(scratch,
                                                 mix.inputs(SETUP_FRAMES))
            tr["pos"].cpu()
    del scratch, tr
    log(f"route: KFusion.compute_frames_scan "
        f"({traffic['frames_per_call']} frames a call; backend "
        f"{kf.backend}, warm start {'on' if kf.warm_start else 'off'}); "
        f"called while the graph was warmed and captured: "
        f"{describe_route(seen)}")
    energy = None
    if cuda:
        from kfbench.energy import EnergyCounter
        energy = EnergyCounter(torch.cuda.current_device())
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", t_start + setup_s))
    log("set-up s: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                                 for a, b in zip(marks, marks[1:])))

    probe = [launch_probe.launch_us(device)] if cuda else []
    reservoir = check.Reservoir(seed, last=bool(standins))
    j0 = energy.joules() if energy else None
    win = mix.window(state, SETUP_FRAMES, seconds, reservoir, events=trace)
    joules = energy.joules() - j0 if energy else None
    if cuda:
        probe.append(launch_probe.launch_us(device))
        log("launch probe (a graph of 2000 one-element adds), device us a "
            "kernel, launched on an idle stream / queued behind a sleep: "
            + ", ".join(f"{a:.4f} / {b:.4f} {when}" for (a, b), when
                        in zip(probe, ("before the window", "after"))))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    pos = torch.cat([r.reshape(-1, 3).cpu() for r in win["rows"]]) \
        .double().numpy()
    tracked = torch.cat([t.reshape(-1).cpu() for t in win["tracked"]]) \
        .numpy()
    frames = list(range(SETUP_FRAMES, SETUP_FRAMES + win["frames"]))
    ate = scene.same_frame_ate(pos, scene.ground_truth(stream, frames,
                                                       period))
    failed = int((~tracked.astype(bool)).sum()
                 + (~np.isfinite(pos).all(axis=1)).sum())
    tail = ""
    if win["latencies_s"]:
        tail = (f"; latency ms p50 "
                f"{1e3 * stats.nearest_rank(win['latencies_s'], 0.5):.3f} "
                f"p95 {1e3 * stats.nearest_rank(win['latencies_s'], 0.95):.3f}")
    log(f"window: {win['calls']} calls, {win['frames']} frames in "
        f"{win['window_s']:.6f} s{tail}; not tracked or not finite: {failed}; "
        f"ATE (same frame, m): mean {ate['ate_mean_m']:.6f} "
        f"max {ate['ate_max_m']:.6f}")
    captures = [dict(c, signature=repr(c["signature"]))
                for c in kf.graphs.captures]
    log(f"graph captures: {json.dumps(captures)}")

    ctx = {"setup_s": setup_s, "frames": win["frames"],
           "window_s": win["window_s"], "joules": joules,
           "latencies_s": win["latencies_s"], "host_ms": win["host_ms"],
           "captures": kf.graphs.captures, "traffic": traffic,
           "setting": setting}
    breakdown = None
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda
                else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        nxt, st = win["next"], win["state"]

        def stretch():
            nonlocal nxt, st
            for _ in range(int(traffic["trace_calls"])):
                with torch.profiler.record_function("kfbench.hand_in"):
                    inp = mix.inputs(nxt)
                with torch.profiler.record_function("kfbench.call"):
                    st, tr = kf.compute_frames_scan(st, inp)
                if mix.each_call:
                    with torch.profiler.record_function(
                            "kfbench.pose_readback"):
                        tr["pos"].cpu()
                nxt += mix.n
        traced_run = tracing.traced(stretch, device)
        ctx["trace"] = traced_run
        dev_info["busy_s"] = traced_run.busy_s
        dev_info["window_s"] = traced_run.window_s
        breakdown = {"device_ops": traced_run.top_ops(), "idle_gaps":
                     traced_run.idle_gaps()}
        log(f"trace: {traced_run.window_s:.6f} s traced, device busy "
            f"{traced_run.busy_s:.6f} s over a span of {traced_run.span_s:.6f} s")
        if cuda:
            n = PHASE_FRAMES
            pg = phases.PhaseGraphs(kf, st, tuple(
                stream["depth"].shape[1:]))
            ph = pg.run(scene.stream_depths(stream, nxt, n, period))
            ref = Reference(setting, device)
            counts = [ref.updated_voxels(p, d) for p, d
                      in zip(ph["poses"], ph["depths"])]
            ctx["phase_ms"] = ph["ms"]
            ctx["updated_voxels"] = sum(counts) / len(counts)
            ctx["depth_pixels"] = kf.H * kf.W
            log(f"phases over {n} frames, device ms a frame: "
                f"{json.dumps(ph['ms'])}; updated voxels a frame "
                f"{ctx['updated_voxels']:.1f}")
            del pg, ph
        del st
    del kf, mix
    if cuda:
        torch.cuda.empty_cache()

    kept = reservoir.kept
    n_call = int(traffic["frames_per_call"])
    start = {"frames": SETUP_FRAMES + n_call,
             "rows": np.concatenate([np.stack(setup_rows), win["start"][
                 "rows"].reshape(-1, 3).double().cpu().numpy()])}
    sample = {"first": kept["first"], "frames": n_call,
              "before": kept["before"], "after": kept["after"],
              "rows": kept["rows"].reshape(-1, 3).double().cpu().numpy()}
    log(f"checks: start = frames 0-{start['frames'] - 1} from a fresh "
        f"state; sample = call {kept['call']} of {win['calls']} (frames "
        f"{kept['first']}-{kept['first'] + n_call - 1}) from the "
        f"program's state")
    del win
    limits = cell["limits"]

    def depths(first, count):
        return scene.stream_depths(stream, first, count, period)
    t_ref = time.perf_counter()
    numbers = check.compare(setting, device, start, sample, depths)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s")
    correct = check.judge(numbers, limits)
    judged = {}
    for name in standins:
        got = check.compare(setting, device, start, sample, depths,
                            standin_name=name)
        judged[name] = {"correct": check.judge(got, limits),
                        "numbers": got}
        log(f"stand-in {name}: correct {judged[name]['correct']}, "
            + ", ".join(f"{k} {v!r}" for k, v in got.items()))

    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": int(ctx["frames"]),
           "failed": failed, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if standins:
        out["standins"] = judged
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in check.NUMBERS}
    return out


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / PORT / "pipeline.py").is_file():
        log(f"kfbench: the program's package {PORT}/ is not beside "
            f"kfbench/ in {ROOT}")
        return 2
    cell = find_cell(args.workload)
    set_cache_dirs()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"kfbench: {cell['name']} needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} card(s)")
        return 3
    torch.set_num_threads(2)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        log(f"kfbench: modules loaded in this process: {', '.join(bad)}")
        return 4
    for k, v in result["checks"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
