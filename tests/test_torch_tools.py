"""The port's profiling tool runs its measurement path on the CPU; the
device fields stay null there ("not measured")."""

import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch.tools.profile_frame import main, profile_frames  # noqa: E402

torch.set_num_threads(2)


def test_profile_frame_on_cpu(tmp_path):
    r = profile_frames(torch.device("cpu"), 32, (80, 60), 1, 5, 1,
                       str(tmp_path / "work"))
    assert r["device"] == "cpu" and r["frames"] == 1 and r["tracked"]
    assert set(r["phase_ms"]) == {"preprocessing", "tracking", "integration",
                                  "raycasting", "frame"}
    assert all(v > 0 for v in r["phase_ms"].values())
    assert r["phase_ms"]["frame"] >= r["phase_ms"]["tracking"]
    for key in ("device_busy_ms", "device_idle_share",
                "kernel_launches_per_frame", "hand_kernels_ms",
                "top_kernels_ms"):
        assert r[key] is None


def test_profile_frame_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--device", "cuda"])
