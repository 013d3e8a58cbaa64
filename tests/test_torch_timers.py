"""The port's KERNEL_TIMINGS spans (``slambench_tpu_torch/utils/
timers.py:KernelTimings``): the reference's ``name duration_ns size``
line, a CPU run of the port's CLI with ``--fused`` (where the spans
time the production dispatches; the phased route takes
``frontend/timed.py``, tests/test_torch_timed.py) whose stderr the
port's ``eval/check_kernels.py`` reads (one K1F span a frame, one K2F
and one solve span per ICP iteration), and silence with the variable
unset."""

import contextlib
import io

import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch.config import parse_args  # noqa: E402
from slambench_tpu_torch.eval import check_kernels  # noqa: E402
from slambench_tpu_torch.frontend.benchmark import run  # noqa: E402
from slambench_tpu_torch.io import synthetic as TS  # noqa: E402
from slambench_tpu_torch.utils.timers import KernelTimings  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
N_FRAMES = 6
PYRAMID = (3, 2, 2)


def test_kernel_timer_format(monkeypatch):
    """As test_utils.py::test_kernel_timer_format: name, positive ns,
    size."""
    monkeypatch.setenv("KERNEL_TIMINGS", "1")
    t = KernelTimings(CPU)
    with t.span("trackKernel", 320 * 240):
        torch.zeros(8) + 1
    out = io.StringIO()
    lines = t.flush(out)
    line = out.getvalue().strip().split()
    assert len(lines) == 1 and len(line) == 3
    assert line[0] == "trackKernel"
    assert int(line[1]) > 0
    assert line[2] == str(320 * 240)
    assert t.flush(io.StringIO()) == []


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synth_timers"))
    return TS.generate_dataset(out, CPU, n_frames=N_FRAMES,
                               image_size=(80, 60), dim=(4.8, 4.8, 4.8),
                               amp=0.12)


def _run_cli(man, tmp_path, monkeypatch, value):
    if value is None:
        monkeypatch.delenv("KERNEL_TIMINGS", raising=False)
    else:
        monkeypatch.setenv("KERNEL_TIMINGS", value)
    cfg = parse_args(["-i", man["raw"], "-o", str(tmp_path / "b.log"),
                      "-v", "32", "-s", "4.8", "-p", "0.34,0.5,0.24",
                      "-c", "1", "-r", "1", "-z", "2", "-y", "3,2,2",
                      "-k", "60.15,60.0,40,30"])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        run(cfg, CPU, fused=True, quiet=True)
    return err.getvalue()


def test_cli_kernel_timings_parse(dataset, tmp_path, monkeypatch):
    log = _run_cli(dataset, tmp_path, monkeypatch, "1")
    agg = check_kernels.aggregate_kernel_log(log.splitlines())
    icp = N_FRAMES * sum(PYRAMID)           # -r 1: every frame tracks
    assert len(agg["mm2meters+bilateralFilter"]) == N_FRAMES
    assert len(agg["track+reduce"]) == icp
    assert len(agg["updatePose"]) == icp
    assert len(agg["renderDepth"]) == len(agg["renderTrack"]) == N_FRAMES
    assert len(agg["renderVolume"]) == N_FRAMES // 2      # -z 2
    assert len(agg["raycast"]) == N_FRAMES - 3            # frame > 2
    # Frames 0-3 integrate by force; later ones only once tracked.
    assert len(agg["integrate"]) == len(agg["minMip"]) >= 4
    for name, ns in agg.items():
        assert (ns > 0).all(), name
    out = io.StringIO()
    check_kernels.print_statistics(agg, out)
    assert "track+reduce" in out.getvalue() and "ALL" in out.getvalue()
    sizes = {int(line.split()[2]) for line in log.splitlines()
             if line.startswith("track_reduce ")}
    assert sizes == {80 * 60, 40 * 30, 20 * 15}


@pytest.mark.parametrize("value", [None, ""])
def test_no_lines_without_kernel_timings(dataset, tmp_path, monkeypatch,
                                         value):
    log = _run_cli(dataset, tmp_path, monkeypatch, value)
    assert not check_kernels.aggregate_kernel_log(log.splitlines())
    t = KernelTimings(CPU)
    assert not t.enabled
    with t.span("integrate", 1):
        pass
    assert t.flush(io.StringIO()) == [] and not t._spans
