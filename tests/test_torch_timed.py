"""The port's KERNEL_TIMINGS route (``slambench_tpu_torch/frontend/
timed.py:TimedRunner``) on the CPU, at 64x48 (sides multiples of the
warm start's 8x8 pool) with pyramid (3, 2, 2):

* one frame from a state shared with the JAX package's ``TimedRunner``,
  on ``fast`` and on ``jnp`` + cv: the same ``(name, size)`` line
  sequence, and the pose, tracked flag, TSDF, weights, result codes and
  reduction within test_steady_state_frame_matches_jax's gates;
* the route's ``reduce`` rows a frame and level equal the executed
  iterations of ``KFusion.tracking(census=True)`` from the same states,
  and the K1 and K2 wrappers get contiguous inputs;
* the phased CLI with KERNEL_TIMINGS=1 prints JAX's rows (and the
  render spans), no fused row;
* at 80x60 the route raises the warm start's shape error at frame 3
  (JAX's route raises a broadcasting TypeError there);
* ``utils/timers.py:KernelTimer`` and ``timed``: the reference's line.
"""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu.frontend.timed import TimedRunner as JTimedRunner  # noqa: E402
from slambench_tpu.pipeline import KFusion as JKFusion  # noqa: E402
from slambench_tpu.pipeline import KFusionState as JState  # noqa: E402

from slambench_tpu_torch import convert  # noqa: E402
from slambench_tpu_torch.config import parse_args  # noqa: E402
from slambench_tpu_torch.eval.check_kernels import (  # noqa: E402
    FUSED_ROWS, JAX_ROWS, aggregate_kernel_log, missing_rows,
)
from slambench_tpu_torch.frontend import timed as timed_mod  # noqa: E402
from slambench_tpu_torch.frontend.benchmark import run  # noqa: E402
from slambench_tpu_torch.frontend.timed import TimedRunner  # noqa: E402
from slambench_tpu_torch.io import synthetic as TS  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion  # noqa: E402
from slambench_tpu_torch.utils import (  # noqa: E402
    KernelTimer, kernel_timings_enabled, timed,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")
SIZE = (64, 48)
PYRAMID = (3, 2, 2)
N_FRAMES = 8
VOLUME = 64
RENDER_ROWS = {"renderDepth", "renderTrack", "renderVolume"}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synth_timed"))
    man = TS.generate_dataset(out, CPU, n_frames=N_FRAMES, image_size=SIZE,
                              dim=(4.8, 4.8, 4.8), amp=0.12)
    rd = RawDepthReader(man["raw"])
    man["frames"] = [np.ascontiguousarray(rd.read_next_depth_frame())
                     for _ in range(N_FRAMES)]
    return man


def _kf_args(man):
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    return (man["image_size"], (VOLUME,) * 3, man["dim"], init, PYRAMID,
            man["camera"])


def _rows(text: str):
    """(name, size) of every ``name ns size`` line."""
    out = []
    for line in text.splitlines():
        name, _, size = line.split()
        out.append((name, int(size)))
    return out


@pytest.mark.parametrize("backend,motion", [("fast", "none"),
                                            ("jnp", "cv")])
def test_one_frame_matches_jax(dataset, backend, motion):
    """Bootstrap frames 0-4 in the port, hand the state to both
    packages' routes and run frame 5 (integrated, raycast warm-started
    on ``fast``)."""
    man = dataset
    frames = man["frames"]
    kf = KFusion(*_kf_args(man), backend=backend, motion_model=motion,
                 device=CPU)
    state = kf.init_state()
    for f in range(5):
        state = kf.process_frame(state, frames[f], f, integration_rate=1)
    assert bool(state.tracked)
    shared = convert.state_to_numpy(state)

    jkf = JKFusion(*_kf_args(man), backend=backend, motion_model=motion)
    jout, tout = io.StringIO(), io.StringIO()
    js = JTimedRunner(jkf, stream=jout).process_frame(
        JState(**{k: jnp.asarray(v) for k, v in shared.items()}),
        jnp.asarray(frames[5]), 5, 1, 1)
    ts = TimedRunner(kf, stream=tout).process_frame(
        convert.state_from_numpy(shared, CPU), frames[5], 5, 1, 1)

    rows = _rows(tout.getvalue())
    assert rows == _rows(jout.getvalue())
    assert ("integrate", SIZE[0] * SIZE[1]) in rows
    assert ("raycast", SIZE[0] * SIZE[1]) in rows
    np.testing.assert_allclose(ts.pose[:3, 3].numpy(),
                               np.asarray(js.pose[:3, 3]), atol=1e-4)
    assert bool(ts.tracked) == bool(js.tracked) is True
    assert bool(ts.integrated) and bool(js.integrated)
    d = np.abs(ts.tsdf.numpy().astype(np.int32)
               - np.asarray(js.tsdf, np.int32))
    assert (d > 0).mean() < 0.02, f"{(d > 0).mean():.4f} voxels differ"
    assert (d > 2).mean() < 1e-4, f"{(d > 2).sum()} voxels beyond 2 LSB"
    np.testing.assert_array_equal(ts.weight.numpy(), np.asarray(js.weight))
    same = ts.track_result.numpy() == np.asarray(js.track_result)
    assert same.mean() > 0.999, f"{same.mean():.5f} of result codes agree"
    np.testing.assert_allclose(ts.reduction.numpy(),
                               np.asarray(js.reduction), rtol=1e-3, atol=1e-2)


def test_reduce_rows_equal_the_census(dataset, monkeypatch):
    """Over 8 frames the route's ``reduce`` rows by level equal the
    iterations that ``KFusion.tracking(census=True)`` counts from the
    same states (its loop runs the budget frozen past convergence; the
    route breaks there). K1 and K2 get contiguous inputs, as the kernels
    need."""
    seen = {"K1": 0, "K2": 0}
    real_k1, real_k2 = (timed_mod.bilateral_filter_cuda,
                        timed_mod.reduce_track_cuda)

    def k1(depth, *args):
        assert depth.is_contiguous()
        seen["K1"] += 1
        return real_k1(depth, *args)

    def k2(data):
        assert all(t.is_contiguous() for t in data.values())
        seen["K2"] += 1
        return real_k2(data)

    monkeypatch.setattr(timed_mod, "bilateral_filter_cuda", k1)
    monkeypatch.setattr(timed_mod, "reduce_track_cuda", k2)

    man = dataset
    kf = KFusion(*_kf_args(man), device=CPU)
    sizes = [SIZE[0] * SIZE[1] >> (2 * lv) for lv in range(len(PYRAMID))]
    state = kf.init_state()
    total = 0
    for f, depth in enumerate(man["frames"]):
        pre = kf.preprocessing(state, kf.to_device(depth))
        _, counts, _ = kf.tracking(pre, census=True)
        out = io.StringIO()
        state = TimedRunner(kf, stream=out).process_frame(state, depth, f,
                                                          1, 1)
        rows = [size for name, size in _rows(out.getvalue())
                if name == "reduce"]
        got = [rows.count(s) for s in reversed(sizes)]   # coarsest first
        assert got == counts.tolist(), f"frame {f}"
        total += len(rows)
    assert bool(state.tracked)
    assert seen == {"K1": N_FRAMES, "K2": total}


def _cli(man, tmp_path, monkeypatch, *extra):
    monkeypatch.setenv("KERNEL_TIMINGS", "1")
    cam = ",".join(str(c) for c in man["camera"])
    cfg = parse_args(["-i", man["raw"], "-o", str(tmp_path / "b.log"),
                      "-v", str(VOLUME), "-s", "4.8", "-p", "0.34,0.5,0.24",
                      "-c", "1", "-r", "1", "-z", "2", "-y", "3,2,2",
                      "-k", cam, *extra])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        summary = run(cfg, CPU, quiet=True)
    return summary, err.getvalue()


def test_cli_prints_the_jax_rows(dataset, tmp_path, monkeypatch):
    """The phased CLI with KERNEL_TIMINGS=1 takes the route: JAX's rows
    and the render spans, no fused row, every line positive; the
    per-phase columns 0."""
    summary, err = _cli(dataset, tmp_path, monkeypatch)
    agg = aggregate_kernel_log(err.splitlines())
    assert set(agg) - RENDER_ROWS == set(JAX_ROWS)
    assert not set(FUSED_ROWS) & set(agg)
    assert missing_rows(agg) == []
    assert len(agg["mm2meters"]) == len(agg["bilateralFilter"]) == N_FRAMES
    assert len(agg["checkPose"]) == N_FRAMES
    assert len(agg["raycast"]) == N_FRAMES - 3
    assert len(agg["track"]) == len(agg["reduce"]) == len(agg["updatePose"])
    assert N_FRAMES <= len(agg["reduce"]) <= N_FRAMES * sum(PYRAMID)
    assert len(agg["integrate"]) == len(agg["minMip"]) >= 4
    for name, ns in agg.items():
        assert (ns > 0).all(), name
    assert summary["frames"] == N_FRAMES
    for phase in ("preprocessing", "tracking", "integration"):
        assert summary[phase] == [0.0] * N_FRAMES, phase
    assert all(c > 0 for c in summary["computation"])


def test_shape_error_is_loud(tmp_path, monkeypatch):
    """At 80x60 the warm start's 8x8 pool does not divide the frame: the
    phased KERNEL_TIMINGS=1 run raises at frame 3, naming the shape."""
    man = TS.generate_dataset(str(tmp_path), CPU, n_frames=4,
                              image_size=(80, 60), dim=(4.8, 4.8, 4.8),
                              amp=0.12)
    with pytest.raises(ValueError, match="60x80"):
        _cli(man, tmp_path, monkeypatch)


def test_kernel_timer_line(monkeypatch):
    """``name ns size``, printed on exit; off without KERNEL_TIMINGS
    unless enabled explicitly; ``timed`` returns the function's
    result."""
    out = io.StringIO()
    with KernelTimer("track", 77, stream=out, enabled=True) as t:
        t.result = torch.ones(4) * 2
    name, ns, size = out.getvalue().split()
    assert (name, size) == ("track", "77")
    assert int(ns) == t.elapsed_ns > 0
    monkeypatch.delenv("KERNEL_TIMINGS", raising=False)
    assert not kernel_timings_enabled()
    quiet = io.StringIO()
    with KernelTimer("x", stream=quiet) as t:
        t.result = torch.zeros(1)
    assert quiet.getvalue() == "" and t.elapsed_ns == 0
    monkeypatch.setenv("KERNEL_TIMINGS", "1")
    assert kernel_timings_enabled()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        r = timed("reduce", lambda a, b: a + b, torch.ones(2), torch.ones(2),
                  size=3)
    assert torch.equal(r, torch.full((2,), 2.0))
    assert err.getvalue().split()[0::2] == ["reduce", "3"]
