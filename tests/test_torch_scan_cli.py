"""The port's CLI with ``--scan-chunk`` and ``KERNEL_TIMINGS=xprof`` on the
CPU, against the JAX CLI's contracts:

* ``--fused --scan-chunk 4`` rows against the port's own per-frame
  ``--fused`` rows, at ``-r 1`` and at ``-r 2`` (the rated route): equal
  positions, tracked and integrated (exact on the CPU: the batched route
  loops the same step), phase columns 0, one acquisition a chunk (the
  JAX CLI's scan compile would take this file past a minute; the JAX
  comparison of the routes is test_torch_scan.py);
* the loud fallback to per-frame dispatch for each reason
  (tests/test_rates_and_modes.py:103-126);
* ``eval/xprof2log.py`` on a fake trace (tests/test_frontend_tools.py:
  202-228) and on a trace in torch.profiler's form;
* the ``KERNEL_TIMINGS=xprof`` route on the CPU: a chunk is traced and
  the no-device-lanes notice printed (tests/test_frontend_tools.py:
  231-262)."""

import gzip
import io
import json
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch.config import parse_args  # noqa: E402
from slambench_tpu_torch.eval import xprof2log  # noqa: E402
from slambench_tpu_torch.eval.check_kernels import aggregate_kernel_log  # noqa: E402
from slambench_tpu_torch.eval.check_pos import parse_benchmark_log  # noqa: E402
from slambench_tpu_torch.frontend.benchmark import main, run  # noqa: E402
from slambench_tpu_torch.io.synthetic import generate_dataset  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
FLAGS = ["-v", "32", "-s", "4.8", "-p", "0.34,0.5,0.24", "-c", "1",
         "-z", "4", "-y", "3,2,2", "-k", "60.15,60.0,40,30"]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synth_scan_cli"))
    return generate_dataset(out, CPU, n_frames=14, image_size=(80, 60),
                            dim=(4.8,) * 3, amp=0.12)


def _run(clip, log_path, rate, **kw):
    cfg = parse_args(["-i", clip["raw"], "-o", str(log_path), *FLAGS,
                      "-r", str(rate)])
    return run(cfg, CPU, quiet=True, **kw)


@pytest.mark.parametrize("rate", [1, 2])
def test_scan_chunk_rows_equal_per_frame_rows(clip, tmp_path, capsys, rate):
    """14 frames: boot 0-3 per frame, chunks 4-7 and 8-11, then 12-13
    (at -r 2 whole periods; at -r 1 a short chunk)."""
    _run(clip, tmp_path / "f.log", rate, fused=True)
    summary = _run(clip, tmp_path / "s.log", rate, fused=True, scan_chunk=4)
    assert "disabled" not in capsys.readouterr().err
    assert summary["frames"] == 14
    want = parse_benchmark_log(str(tmp_path / "f.log"))
    got = parse_benchmark_log(str(tmp_path / "s.log"))
    for col in ("frame", "X", "Y", "Z", "tracked", "integrated"):
        np.testing.assert_array_equal(got[col], want[col], err_msg=col)
    assert got["tracked"][4:].all()
    if rate == 2:
        np.testing.assert_array_equal(got["integrated"][4:],
                                      np.arange(4, 14) % 2 == 0)
    batched = slice(4, 14)
    for col in ("preprocessing", "tracking", "integration", "raycasting"):
        assert (got[col][batched] == 0).all(), col
    comp = got["computation"][batched]
    assert (comp > 0).all()
    np.testing.assert_array_equal(comp[:4], comp[0])      # one chunk
    assert (got["rendering"][batched] > 0).all()
    acq = got["acquisition"][batched]
    assert (acq[[1, 2, 3, 5, 6, 7]] == 0).all() and acq[0] > 0


@pytest.mark.parametrize("reason,rate,kw,env", [
    ("gate period 3 > chunk", 3, {"fused": True}, None),
    ("requires --fused or --mesh", 1, {}, None),
    ("KERNEL_TIMINGS spans", 1, {"fused": True}, "1"),
    ("--keyframes", 1, {"fused": True, "keyframes": True}, None),
    ("--stats", 1, {"fused": True, "stats": True}, None),
    ("breakpoint flags", 1, {"fused": True, "break_at_frame": 5}, None),
    ("--debug-nans", 1, {"fused": True, "debug_nans": True}, None),
])
def test_scan_chunk_fallback_is_loud(clip, tmp_path, capsys, monkeypatch,
                                     reason, rate, kw, env):
    if env is not None:
        monkeypatch.setenv("KERNEL_TIMINGS", env)
    chunk = 2 if rate == 3 else 8
    summary = _run(clip, tmp_path / "b.log", rate, scan_chunk=chunk,
                   max_frames=6, **kw)
    err = capsys.readouterr().err
    line = next(l for l in err.splitlines() if "--scan-chunk" in l)
    assert line.startswith(f"--scan-chunk {chunk} disabled (")
    assert line.endswith("); running per-frame dispatch")
    assert reason in line
    log = parse_benchmark_log(str(tmp_path / "b.log"))
    assert summary["frames"] == len(log["frame"]) == 6
    if kw.get("fused") and not kw.get("keyframes"):
        # Per-frame dispatch, not a chunk: every frame's own window.
        assert len(set(log["computation"][4:])) == 2


def test_scan_chunk_flag_is_consumed(clip, tmp_path):
    assert main(["--device", "cpu", "--fused", "--scan-chunk", "4",
                 "-i", clip["raw"], "-o", str(tmp_path / "m.log"),
                 *FLAGS, "-r", "1"]) == 0
    assert len(parse_benchmark_log(str(tmp_path / "m.log"))["frame"]) == 14


def _fake_trace():
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 3,
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 9,
         "args": {"name": "python host"}},
        {"ph": "X", "pid": 3, "name": "fusion.123", "dur": 250.0},
        {"ph": "X", "pid": 3, "name": "copy.4", "dur": 10.5},
        {"ph": "X", "pid": 9, "name": "hostframe", "dur": 9999.0},
        {"ph": "B", "pid": 3, "name": "notcomplete"},
    ]}


def test_xprof2log_device_filter_and_units(tmp_path):
    run_dir = tmp_path / "plugins" / "profile" / "run1"
    run_dir.mkdir(parents=True)
    with gzip.open(run_dir / "host.trace.json.gz", "wt") as f:
        json.dump(_fake_trace(), f)
    out = io.StringIO()
    n = xprof2log.convert(str(tmp_path), out=out)
    lines = out.getvalue().strip().splitlines()
    assert n == 2 and len(lines) == 2
    durs = {l.split()[0]: float(l.split()[1]) for l in lines}
    assert set(durs) == {"fusion.123", "copy.4"}
    assert durs["fusion.123"] == pytest.approx(250e3)     # us -> ns
    agg = aggregate_kernel_log(lines)
    assert agg["fusion.123"][0] == pytest.approx(250e3)


def test_xprof2log_falls_back_without_device_metadata(tmp_path):
    p = tmp_path / "t.trace.json"
    p.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "pid": 1, "name": "k", "dur": 1.0}]}))
    out = io.StringIO()
    assert xprof2log.convert(str(p), out=out) == 1
    assert xprof2log.main([str(tmp_path), "extra"]) == 1


def test_xprof2log_reads_torch_profiler_form(tmp_path):
    """torch.profiler's export: a CUDA lane found by its events' category
    (no "GPU" process name needed), demangled names cut to one field."""
    trace = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 4242,
         "args": {"name": "python3"}},
        {"ph": "X", "cat": "cpu_op", "pid": 4242, "name": "aten::add",
         "dur": 7.0},
        {"ph": "X", "cat": "cuda_runtime", "pid": 4242,
         "name": "cudaGraphLaunch", "dur": 3.0},
        {"ph": "X", "cat": "kernel", "pid": 0,
         "name": "void (anonymous namespace)::track_reduce_kernel"
                 "(TrackPixel, float const*, float*, unsigned int*)",
         "dur": 6.5},
        {"ph": "X", "cat": "kernel", "pid": 0,
         "name": "void at::native::vectorized_elementwise_kernel<4, "
                 "at::native::FillFunctor<float>>(int, float*)",
         "dur": 1.25},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0,
         "name": "Memcpy DtoD (Device -> Device)", "dur": 2.0},
    ]}
    (tmp_path / "kernels.trace.json").write_text(json.dumps(trace))
    out = io.StringIO()
    assert xprof2log.convert(str(tmp_path), out=out) == 3
    names = [l.split()[0] for l in out.getvalue().splitlines()]
    assert all(len(l.split()) == 2 for l in out.getvalue().splitlines())
    assert names[0] == "(anonymous_namespace)::track_reduce_kernel"
    assert names[1].startswith("at::native::vectorized_elementwise_kernel<4")
    assert names[2] == "Memcpy_DtoD"


def test_kernel_timings_xprof_route(clip, tmp_path, capsys, monkeypatch):
    """KERNEL_TIMINGS=xprof with --scan-chunk 4: the second chunk (frames
    8-11) repeats the first one's signature and is traced; the CPU trace
    has no device lane, so the route prints its notice."""
    monkeypatch.setenv("KERNEL_TIMINGS", "xprof")
    # The trace directory goes under tempfile's directory ($TMPDIR).
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    summary = _run(clip, tmp_path / "x.log", 1, fused=True, scan_chunk=4,
                   max_frames=12)
    assert summary["frames"] == 12
    err = capsys.readouterr().err
    assert "xprof kernel attribution" in err
    assert "no device lanes" in err
    assert "--scan-chunk 4 disabled" not in err
    traces = list(tmp_path.glob("slambench_xprof_*/kernels.trace.json"))
    assert len(traces) == 1
    assert any(ev.get("ph") == "X" for ev in
               xprof2log.load_trace(str(traces[0]))["traceEvents"])
