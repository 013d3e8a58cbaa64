"""The port's CLI observation flags, one CPU run each: ``--break-at-frame``,
``--break-on-untracked``, ``--debug-nans`` (the clean clip's outcome is
the JAX CLI's: every frame runs, no fault; a NaN names its phase),
``--report-device``, ``--stats``; and the KERNEL_TIMINGS row set: a log
of the port's ``--fused`` spans, read by ``eval/check_kernels.py``, has a
row for every row name of the JAX package's route, the fused rows
standing for their pairs."""

import dataclasses
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch.config import parse_args  # noqa: E402
from slambench_tpu_torch.eval.check_kernels import (  # noqa: E402
    FUSED_ROWS, JAX_ROWS, aggregate_kernel_log, missing_rows,
    print_statistics,
)
from slambench_tpu_torch.eval.check_pos import parse_benchmark_log  # noqa: E402
from slambench_tpu_torch.frontend import benchmark  # noqa: E402
from slambench_tpu_torch.io.raw import RawWriter  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.io.synthetic import generate_dataset  # noqa: E402
from slambench_tpu_torch.utils.checkpoint import load_state  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
FLAGS = ["-v", "64", "-s", "4.8", "-p", "0.34,0.5,0.24", "-c", "1",
         "-r", "1", "-z", "4", "-k", "120.3,120.0,80,60"]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """10 frames of test_pipeline_e2e.py's clip (160x120, amp 0.12): the
    clip the JAX CLI was run on by hand with --debug-nans."""
    out = str(tmp_path_factory.mktemp("synth_flags"))
    return generate_dataset(out, CPU, n_frames=10, image_size=(160, 120),
                            dim=(4.8,) * 3, amp=0.12)


def _main(clip, tmp_path, *flags, raw=None):
    log = str(tmp_path / "b.log")
    rc = benchmark.main(["--device", "cpu", *flags, "-i", raw or clip["raw"],
                         "-o", log, *FLAGS])
    return rc, parse_benchmark_log(log)


def test_break_at_frame(clip, tmp_path, capsys):
    """--break-at-frame 5: rows 0-5 written, then the checkpoint (at
    frame 6) and the volume dump."""
    ck, vol = str(tmp_path / "s.npz"), str(tmp_path / "vol.bin")
    rc, log = _main(clip, tmp_path, "--break-at-frame", "5",
                    "--checkpoint", ck, "-d", vol)
    assert rc == 0
    np.testing.assert_array_equal(log["frame"], np.arange(6))
    assert "BREAK: at frame 5" in capsys.readouterr().err
    assert load_state(ck, CPU)[1] == 6
    assert os.path.getsize(vol) == 64 ** 3 * 2


def test_break_on_untracked(clip, tmp_path, capsys):
    """Frames 6-9 of the clip emptied: frame 6 is the first untracked
    frame past the bootstrap; its row is written and the run stops."""
    rd = RawDepthReader(clip["raw"])
    raw = str(tmp_path / "lost.raw")
    with RawWriter(raw, 160, 120) as w:
        for f in range(10):
            d = rd.read_next_depth_frame()
            w.write(d if f <= 5 else np.zeros_like(d))
    rc, log = _main(clip, tmp_path, "--break-on-untracked", raw=raw)
    assert rc == 0
    np.testing.assert_array_equal(log["frame"], np.arange(7))
    assert log["tracked"][4:6].all() and not log["tracked"][6]
    assert "BREAK: untracked at frame 6" in capsys.readouterr().err


def test_debug_nans_clean_clip_matches_jax_outcome(clip, tmp_path):
    """The JAX CLI with --debug-nans on this clip and these flags
    (checked by hand, CPU) exits 0 with 10 rows, tracked from frame 4:
    no NaN fault. The port reaches the same outcome."""
    rc, log = _main(clip, tmp_path, "--debug-nans")
    assert rc == 0
    np.testing.assert_array_equal(log["frame"], np.arange(10))
    np.testing.assert_array_equal(log["tracked"].astype(int),
                                  [0, 0, 0, 0, 1, 1, 1, 1, 1, 1])


@pytest.mark.parametrize("phase,leaf,frame", [
    ("tracking", "pose", 0), ("raycasting", "ref_vertex", 3)])
def test_debug_nans_names_the_phase(clip, tmp_path, monkeypatch, phase,
                                    leaf, frame):
    """A phase that writes a NaN raises FloatingPointError naming the
    phase, the tensor and the frame (the phase's first run)."""
    real = getattr(benchmark.KFusion, phase)

    def poisoned(self, state, *a, **kw):
        out = real(self, state, *a, **kw)
        bad = getattr(out, leaf).clone()
        bad.view(-1)[0] = float("nan")
        return dataclasses.replace(out, **{leaf: bad})

    monkeypatch.setattr(benchmark.KFusion, phase, poisoned)
    cfg = parse_args(["-i", clip["raw"], "-o", str(tmp_path / "n.log"),
                      *FLAGS])
    with pytest.raises(FloatingPointError, match=(
            f"{phase} wrote a NaN into {leaf} at frame {frame}")):
        benchmark.run(cfg, CPU, max_frames=5, quiet=True, debug_nans=True)


def test_debug_nans_checks_what_the_phase_wrote():
    """Only NaN faults (inf passes, as with jax_debug_nans), and only in
    the float tensors the phase replaced."""
    kf = benchmark.KFusion((16, 8), (8,) * 3, (2.0,) * 3, (1, 1, 0), (2, 2),
                           (30.0, 30.0, 8.0, 4.0), device=CPU)
    before = dataclasses.replace(
        kf.init_state(), ref_normal=torch.full((3, 8, 16), float("nan")))
    inf = dataclasses.replace(before, pose=before.pose + float("inf"))
    benchmark.check_nans("integration", 7, before, inf)
    nan = dataclasses.replace(inf, reduction=inf.reduction * float("nan"))
    with pytest.raises(FloatingPointError, match="into reduction at frame 7"):
        benchmark.check_nans("tracking", 7, before, nan)


def test_report_device_prints_the_cpu_line(clip, tmp_path, capsys):
    rc, log = _main(clip, tmp_path, "--report-device", "--break-at-frame",
                    "0")
    assert rc == 0 and len(log["frame"]) == 1
    err = capsys.readouterr().err
    assert f"platform: cpu (torch {torch.__version__}" in err
    assert "  device 0: cpu " in err and "cores" in err


def test_stats_prints_both_tables(clip, tmp_path, capsys):
    """--stats on the CPU: the Stats table (frame, computation, total)
    and the host monitor's table, one sample a frame."""
    from slambench_tpu_torch.utils.perfstats import Stats
    Stats.reset()
    rc, _ = _main(clip, tmp_path, "--stats", "--break-at-frame", "2")
    assert rc == 0
    err = capsys.readouterr().err
    for key in ("frame", "computation", "total", "sample_t"):
        line = [ln for ln in err.splitlines() if ln.startswith(key + " ")]
        assert len(line) == 1 and line[0].endswith("n: 3"), (key, err)
    assert Stats.get("frame") == [0.0, 1.0, 2.0]


def test_kernel_timings_row_set(clip, tmp_path, monkeypatch, capsys):
    """KERNEL_TIMINGS=1 with --fused (the spans' route; the phased one
    is tests/test_torch_timed.py's) over 6 frames: a row for every JAX
    row name, K1F once a frame, and the analyser saying which pair each
    fused row stands for."""
    monkeypatch.setenv("KERNEL_TIMINGS", "1")
    rc, _ = _main(clip, tmp_path, "--fused", "--break-at-frame", "5")
    assert rc == 0
    agg = aggregate_kernel_log(capsys.readouterr().err.splitlines())
    assert missing_rows(agg) == []
    assert not {"mm2meters", "bilateralFilter", "track", "reduce"} & set(agg)
    assert len(agg["mm2meters+bilateralFilter"]) == 6
    assert len(agg["track+reduce"]) == len(agg["updatePose"])
    assert len(agg["checkPose"]) == 6
    assert len(agg["halfSampleRobustImage"]) == 2 * 6
    assert len(agg["depth2vertex"]) == len(agg["vertex2normal"]) == 3 * 6
    out = io.StringIO()
    print_statistics(agg, out)
    text = out.getvalue()
    assert "stands for mm2meters + bilateralFilter" in text
    assert "stands for track + reduce" in text
    assert missing_rows({"raycast": np.ones(1)}) == [
        r for r in JAX_ROWS if r != "raycast"]
    assert set(FUSED_ROWS) == {"mm2meters+bilateralFilter", "track+reduce"}


def test_wrapper_spans_on_the_cpu(monkeypatch):
    """On CPU tensors the K1F and K2F wrappers enter their span around
    the twin; with timing off the span is the shared no-op, whose launch
    events are null."""
    from slambench_tpu_torch.ops.hopper import bilateral, reduce
    from slambench_tpu_torch.ops.preprocess import make_gaussian
    from slambench_tpu_torch.utils.timers import NULL_SPAN, KernelTimings
    assert KernelTimings(CPU).span("x") is NULL_SPAN
    assert NULL_SPAN.device_events() == (0, 0)
    monkeypatch.setenv("KERNEL_TIMINGS", "1")
    t = KernelTimings(CPU)
    mm = torch.randint(0, 4000, (24, 32), dtype=torch.int32)
    bilateral.mm2m_bilateral_cuda(mm, 2, make_gaussian(),
                                  span=t.span("mm2m_bilateral", 192))
    v = torch.rand(3, 12, 16)
    n = torch.nn.functional.normalize(torch.rand(3, 12, 16), dim=0)
    reduce.track_reduce_cuda(v, n, v, n, torch.eye(4), torch.eye(4),
                             span=t.span("track_reduce", 192))
    spans = t.flush(io.StringIO())
    assert [(name, size) for name, _, size in spans] == [
        ("mm2m_bilateral", 192), ("track_reduce", 192)]
