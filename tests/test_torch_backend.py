"""The port's platform and device selection, kernel build directory and
failure -> remedy table (``slambench_tpu_torch/utils/backend.py``),
mirroring the JAX module's tests (``tests/test_backend_autotune.py``),
and the CLI's wiring of them. The port raises where JAX's
``select_device`` warns and keeps the default."""

import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch.frontend import benchmark  # noqa: E402
from slambench_tpu_torch.io import native  # noqa: E402
from slambench_tpu_torch.io.raw import RawWriter  # noqa: E402
from slambench_tpu_torch.ops.hopper import build  # noqa: E402
from slambench_tpu_torch.utils import backend  # noqa: E402

torch.set_num_threads(2)
ENV = (backend.PLATFORM_ENV, backend.DEVICE_ENV, build.CACHE_ENV)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def test_select_backend_unset_is_noop():
    assert backend.select_backend() is None
    assert backend.select_device() is None
    assert backend.device_name() == "cuda"


@pytest.mark.parametrize("value,want", [("cpu", "cpu"), ("CPU", "cpu"),
                                        ("gpu", "cuda"), ("cuda", "cuda")])
def test_select_backend_sets_platform(monkeypatch, value, want):
    monkeypatch.setenv(backend.PLATFORM_ENV, value)
    assert backend.select_backend() == want
    if want == "cpu":
        assert backend.device_name() == "cpu"


@pytest.mark.parametrize("value", ["tpu", "opencl", "cuda:0"])
def test_select_backend_refuses(monkeypatch, value):
    monkeypatch.setenv(backend.PLATFORM_ENV, value)
    with pytest.raises(ValueError, match="SLAMBENCH_PLATFORM"):
        backend.select_backend()
    with pytest.raises(ValueError, match="SLAMBENCH_PLATFORM"):
        backend.device_name()


@pytest.mark.parametrize("value", ["x", "-1", "1.5", "99"])
def test_select_device_refuses(monkeypatch, value):
    monkeypatch.setenv(backend.DEVICE_ENV, value)
    with pytest.raises(ValueError, match="SLAMBENCH_DEVICE"):
        backend.select_device()


def test_select_device_beyond_the_cards(monkeypatch):
    """An ordinal at the card count raises (JAX warns and keeps the
    default)."""
    monkeypatch.setenv(backend.DEVICE_ENV, str(torch.cuda.device_count()))
    with pytest.raises(ValueError, match="out of range"):
        backend.device_name()


def test_explicit_device_wins(monkeypatch):
    monkeypatch.setenv(backend.PLATFORM_ENV, "tpu")
    monkeypatch.setenv(backend.DEVICE_ENV, "x")
    assert backend.device_name("cpu") == "cpu"


def test_cpu_platform_takes_ordinal_zero_only(monkeypatch):
    monkeypatch.setenv(backend.PLATFORM_ENV, "cpu")
    monkeypatch.setenv(backend.DEVICE_ENV, "0")
    assert backend.device_name() == "cpu"
    monkeypatch.setenv(backend.DEVICE_ENV, "1")
    with pytest.raises(ValueError, match="SLAMBENCH_DEVICE"):
        backend.device_name()


def test_jit_cache_moves_both_build_directories(monkeypatch, tmp_path):
    """``SLAMBENCH_JIT_CACHE`` moves the nvcc and the native build
    directories, read where each library builds; unset, 0 or off keep
    the ignored ``_build/``. The native library then builds there."""
    defaults = (build.BUILD_DIR, native.BUILD_DIR)
    assert all(os.path.basename(d) == "_build" for d in defaults)
    for value in ("0", "off", "OFF"):
        monkeypatch.setenv(build.CACHE_ENV, value)
        assert (build.build_dir(),
                build.build_dir("native", native.BUILD_DIR)) == defaults
    monkeypatch.delenv(build.CACHE_ENV)
    assert build.build_dir() == defaults[0]
    monkeypatch.setenv(build.CACHE_ENV, str(tmp_path))
    assert build.build_dir() == str(tmp_path / "hopper")
    monkeypatch.setattr(native, "_lib", None)
    lib = native.build()
    assert os.path.dirname(lib) == str(tmp_path / "native")


def test_device_report_lists_devices():
    out = io.StringIO()
    backend.device_report(torch.device("cpu"), out)
    text = out.getvalue()
    assert text.startswith("platform: cpu") and "device 0: cpu" in text


@pytest.mark.parametrize("exc,phrase", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 "
                            "GiB"), "--volume-resolution"),
    (RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                  "is False; pass --device cpu"), "SLAMBENCH_PLATFORM=cpu"),
    (RuntimeError("No CUDA GPUs are available"), "--device cpu"),
    (RuntimeError("nvcc not found (searched $PATH)"), "CUDA_HOME"),
    (RuntimeError("nvcc failed (exit 1): nvcc -c bilateral.cu"), "sm_90a"),
    (FloatingPointError("NaN in tracking: pose"), "--debug-nans"),
    (ValueError("SLAMBENCH_DEVICE=9 out of range"), "ordinal"),
])
def test_explain_error_table(exc, phrase):
    hint = backend.explain_error(exc)
    assert hint is not None and phrase in hint


def test_explain_error_benign():
    assert backend.explain_error(ValueError("benign")) is None


@pytest.fixture
def tiny_raw(tmp_path):
    path = str(tmp_path / "t.raw")
    with RawWriter(path, 16, 12) as w:
        w.write(np.zeros((12, 16), np.uint16))
    return path


def cli_args(raw, tmp_path):
    return ["-i", raw, "-o", str(tmp_path / "b.log"), "-v", "16"]


def test_cli_prints_hint_and_fails_on_oom(monkeypatch, capsys, tiny_raw,
                                          tmp_path):
    def run(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                     "allocate 536870912 bytes")
    monkeypatch.setattr(benchmark, "run", run)
    with pytest.raises(torch.OutOfMemoryError):
        benchmark.main(["--device", "cpu", *cli_args(tiny_raw, tmp_path)])
    err = capsys.readouterr().err
    assert "hint: device memory exhausted" in err


def test_cli_honours_the_environment(monkeypatch, capsys, tiny_raw,
                                     tmp_path):
    seen = []
    monkeypatch.setattr(benchmark, "run",
                        lambda config, device, **kw: seen.append(device))
    monkeypatch.setenv(backend.PLATFORM_ENV, "cpu")
    assert benchmark.main(cli_args(tiny_raw, tmp_path)) == 0
    assert seen == [torch.device("cpu")]
    # A malformed ordinal raises, names the variable, prints its hint.
    monkeypatch.delenv(backend.PLATFORM_ENV)
    monkeypatch.setenv(backend.DEVICE_ENV, "first")
    with pytest.raises(ValueError, match="SLAMBENCH_DEVICE"):
        benchmark.main(cli_args(tiny_raw, tmp_path))
    assert "hint: SLAMBENCH_DEVICE" in capsys.readouterr().err
    # An explicit --device wins over both variables.
    monkeypatch.setenv(backend.PLATFORM_ENV, "tpu")
    assert benchmark.main(["--device", "cpu",
                           *cli_args(tiny_raw, tmp_path)]) == 0
    assert seen[-1] == torch.device("cpu")
