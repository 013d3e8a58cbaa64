"""Whole runs of a cell on the CPU at a small size, with the harness's
look for a card skipped: the result line, the comparison's control, the
faults it has to catch, and the modules the run loads."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, small_cell
from kfbench import check, run
from slambench_tpu_torch.pipeline import KFusion

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


def go(cell, trace=False, standins=(), seed=SEED, seconds=1.0):
    return run.run_cell(cell, seed, seconds, trace, CPU, standins=standins)


@pytest.mark.parametrize("mix", ["offline", "live"])
def test_sound_run_is_correct(mix):
    cell = small_cell(mix)
    out = go(cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == set(check.NUMBERS)
    assert out["device"]["platform"] == "cpu"
    names = set(out["metrics"])
    assert "setup_s" in names
    assert ("frames_per_s" if mix == "offline" else "frame_ms_mean") in names


def test_traced_run_reads_nothing_without_a_card():
    out = go(small_cell("live"), trace=True)
    assert list(out)[-2:] == ["breakdown", "checks"]
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    # No device activity, no CUDA graphs, no events on the CPU.
    assert out["metrics"] == {}


@pytest.mark.parametrize("mix", ["offline", "live"])
def test_control_is_not_correct(mix):
    out = go(small_cell(mix), standins=("control",))
    assert out["correct"], out["checks"]
    assert not out["standins"]["control"]["correct"], out["standins"]


@pytest.mark.parametrize("mix", ["offline", "live"])
def test_planted_faults_in_the_programs_place_are_not_correct(mix):
    names = ("unchanged", "skip_integrate", "altered") + \
        (("half_batch",) if mix == "offline" else ())
    out = go(small_cell(mix), standins=names)
    assert list(out)[-2:] == ["standins", "checks"]
    for name in names:
        assert not out["standins"][name]["correct"], (name, out["standins"])


@pytest.mark.parametrize("frames", [1, 8])
def test_skipped_integrate_at_the_weight_cap_is_caught(frames):
    """Late in a window the observed voxels sit at the weight cap, where
    a left-out integrate moves a value by a hundred-and-first of the new
    sample: the comparison still sees it."""
    import dataclasses

    from kfbench import scene
    cell = small_cell("offline")
    cfg = cell["config"]
    stream = scene.make_stream(cfg, SEED, CPU)
    kf = run.make_kfusion(cfg, CPU)
    state = kf.init_state()
    for f in range(run.SETUP_FRAMES):
        state = kf.compute_frame(state, stream["depth"][f],
                                 **run.setup_gates(f))
    weight = state.weight.clone()
    weight[weight > 0] = 100
    before = dataclasses.replace(state, weight=weight)
    first = run.SETUP_FRAMES
    after, rows = kf.compute_frames_scan(
        before, stream["depth"][first:first + frames])
    sample = {"first": first, "frames": frames, "before": before,
              "after": after, "rows": rows["pos"].double().numpy()}
    # The start check is not under test here: frame 0 alone.
    start = {"frames": 1, "rows": [kf.init_state().pose[:3, 3].double()
                                   .numpy()]}

    def depths(a, n):
        return scene.stream_depths(stream, a, n, cfg["orbit"]["period"])
    limit = cell["limits"]["tsdf_pct"]
    sound = check.compare(cfg, CPU, start, sample, depths)
    skipped = check.compare(cfg, CPU, start, sample, depths,
                            standin_name="skip_integrate")
    assert sound["tsdf_pct"] < limit < skipped["tsdf_pct"], (sound, skipped)


def unchanged(self, state, depth, **kw):
    """A step that returns its state unchanged."""
    return state


def altered(orig):
    def step(self, state, depth, **kw):
        out = orig(self, state, depth, **kw)
        vertex = out.ref_vertex.clone()
        vertex[2] += 0.02                   # every hit 2 cm deeper
        import dataclasses
        return dataclasses.replace(out, ref_vertex=vertex)
    return step


def half_batch(orig):
    def scan(self, state, depths):
        n = len(depths)
        out, rows = orig(self, state, depths[: max(1, n // 2)])
        pad = lambda t: torch.cat([t, t[-1:].expand(n - len(t),
                                                    *t.shape[1:])])
        return out, {k: pad(v) for k, v in rows.items()}
    return scan


# A live call holds one frame: it has no half batch to leave out.
@pytest.mark.parametrize("mix,fault", [
    ("offline", "unchanged"), ("offline", "altered"),
    ("offline", "half_batch"), ("live", "unchanged"), ("live", "altered")])
def test_faults_are_not_correct(monkeypatch, mix, fault):
    if fault == "unchanged":
        monkeypatch.setattr(KFusion, "scan_step", unchanged)
    elif fault == "altered":
        monkeypatch.setattr(KFusion, "scan_step",
                            altered(KFusion.scan_step))
    else:
        monkeypatch.setattr(KFusion, "compute_frames_scan",
                            half_batch(KFusion.compute_frames_scan))
    out = go(small_cell(mix))
    assert not out["correct"], out["checks"]


def test_no_jax_in_a_rehearsal_run():
    code = (
        "import sys, json, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'kfbench/tests')!r}]\n"
        "from conftest import small_cell\n"
        "from kfbench import run\n"
        "run.run_cell(small_cell('offline', width=64, volume=32), 7, 0.5,"
        " True, torch.device('cpu'))\n"
        "print(json.dumps(sorted(m.split('.')[0] for m in sys.modules)))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    top = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "slambench_tpu_torch" in top and "kfbench" in top
    assert not top & {"jax", "jaxlib", "flax", "slambench_tpu"}


def test_exits_without_a_card_or_without_the_port(tmp_path):
    res = subprocess.run([sys.executable, "-m", "kfbench.run", "--workload",
                          "traj2_256.offline", "--seed", "1", "--seconds",
                          "1"], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=300)
    if not torch.cuda.is_available():
        assert res.returncode != 0 and res.stdout == ""
    bare = tmp_path / "bare"
    (bare / "kfbench").mkdir(parents=True)
    for p in (ROOT / "kfbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            dst = bare / p.relative_to(ROOT)
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(p.read_bytes())
    (bare / "BENCHMARK.json").write_bytes((ROOT / "BENCHMARK.json")
                                          .read_bytes())
    res = subprocess.run([sys.executable, "-m", "kfbench.run", "--workload",
                          "traj2_256.offline", "--seed", "1", "--seconds",
                          "1"], capture_output=True, text=True,
                         cwd=str(bare), timeout=300)
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest "
                    "kfbench/tests -m cuda)")
    cell = run.find_cell("traj2_256.live")
    out = run.run_cell(cell, 2 ** 31 + 7, 3.0, False,
                       torch.device("cuda", 0))
    assert out["correct"], out["checks"]
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)


def test_route_census_reads_what_the_step_called():
    from kfbench import scene
    cfg = small_cell("offline", width=64, volume=32)["config"]
    stream = scene.make_stream(cfg, 3, CPU)
    kf = run.make_kfusion(cfg, CPU)
    state = kf.init_state()
    for f in range(run.SETUP_FRAMES):
        state = kf.compute_frame(state, stream["depth"][f],
                                 **run.setup_gates(f))
    with run.route_census() as seen:
        kf.compute_frames_scan(state, stream["depth"][5:7])
    assert dict(seen) == {("integrate", "gated on the device"): 2,
                          ("raycast_maps", "early_exit=False"): 2}
    assert "masked_march" in run.describe_route(seen)
    from slambench_tpu_torch import pipeline
    assert pipeline.raycast_maps.__name__ == "raycast_maps"
