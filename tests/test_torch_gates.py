"""The port's host-side gates, mirrored from the JAX package's tests:
the tracking and integration rate gates and the reader's fps and
blocking modes (test_rates_and_modes.py), the bootstrap frames and the
motion-model check (test_pipeline_e2e.py), all on the port's
``KFusion.process_frame`` and readers at 160x120 and 64^3; and the
phased CLI's ``tracked`` column on the frames that ``-t 2`` skips: the
previous frame's value, as JAX's phased CLI leaves the state alone there
(test_torch_tracked_parity.py holds the two CLIs' columns equal)."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch.config import parse_args  # noqa: E402
from slambench_tpu_torch.eval.check_pos import parse_benchmark_log  # noqa: E402
from slambench_tpu_torch.frontend.benchmark import run  # noqa: E402
from slambench_tpu_torch.io.raw import RawWriter  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.io.synthetic import generate_dataset  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """test_rates_and_modes.py's clip: 14 frames, 160x120, amp 0.06
    (gentle motion keeps the rate gates off the 15% track cliff)."""
    out = str(tmp_path_factory.mktemp("synth_gates"))
    return generate_dataset(out, CPU, n_frames=14, image_size=(160, 120),
                            dim=(4.8,) * 3, amp=0.06, period=60)


def _kfusion(man, res=64, pyramid=(10, 5, 4), **kw):
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    return KFusion(man["image_size"], (res,) * 3, man["dim"], init, pyramid,
                   man["camera"], device=CPU, **kw)


def test_tracking_rate_gate(dataset):
    """frame % tracking_rate != 0 skips tracking entirely: pose frozen,
    tracked false (reference: cpp/kernels.cpp:927)."""
    rd = RawDepthReader(dataset["raw"])
    kf = _kfusion(dataset)
    st = kf.init_state()
    poses, trackeds = [], []
    for frame in range(12):
        st = kf.process_frame(st, rd.read_next_depth_frame(), frame,
                              tracking_rate=2)
        poses.append(st.pose.numpy().copy())
        trackeds.append(bool(st.tracked))
    assert not any(trackeds[1::2])
    for i in range(5, 12, 2):
        np.testing.assert_array_equal(poses[i], poses[i - 1])
    assert any(trackeds[4::2])


def test_integration_rate_gate(dataset):
    """integrated follows (tracked && frame % rate == 0) || frame <= 3
    (reference: cpp/kernels.cpp:994)."""
    rd = RawDepthReader(dataset["raw"])
    kf = _kfusion(dataset)
    st = kf.init_state()
    flags = []
    for frame in range(12):
        st = kf.process_frame(st, rd.read_next_depth_frame(), frame,
                              integration_rate=3)
        flags.append(bool(st.integrated))
    assert flags[0] and flags[1] and flags[2] and flags[3]
    assert flags[6] and flags[9]
    assert not flags[4] and not flags[5] and not flags[7] and not flags[8]


def test_fps_mode_drops_frames(tmp_path):
    """In fps mode the frame index follows the wall clock: a slow
    consumer skips frames (reference: interface.h:49-80)."""
    path = str(tmp_path / "t.raw")
    with RawWriter(path, 16, 12) as w:
        for i in range(50):
            w.write(np.full((12, 16), i, np.uint16))
    rd = RawDepthReader(path, fps=100)
    first = rd.read_next_depth_frame()
    time.sleep(0.12)
    second = rd.read_next_depth_frame()
    assert int(second[0, 0]) - int(first[0, 0]) >= 10


def test_blocking_read_paces(tmp_path):
    path = str(tmp_path / "t.raw")
    with RawWriter(path, 16, 12) as w:
        for i in range(8):
            w.write(np.full((12, 16), i, np.uint16))
    rd = RawDepthReader(path, fps=50, blocking_read=True)
    t0 = time.monotonic()
    n = 0
    while rd.read_next_depth_frame() is not None:
        n += 1
    assert n == 8
    assert time.monotonic() - t0 >= 0.08


def test_bootstrap_semantics(dataset):
    """Frames 0-3 integrate whatever tracking says
    (reference: cpp/kernels.cpp:994 'frame <= 3')."""
    rd = RawDepthReader(dataset["raw"])
    kf = _kfusion(dataset, res=32, pyramid=(3, 2, 2))
    st = kf.init_state()
    for frame in range(4):
        st = kf.process_frame(st, rd.read_next_depth_frame(), frame)
        assert bool(st.integrated)
    assert int((st.weight > 0).sum()) > 100


def test_motion_model_validation():
    with pytest.raises(ValueError):
        KFusion((16, 12), (16,) * 3, (2.0,) * 3, (1, 1, 0), (2, 2),
                (30.0, 30.0, 8.0, 6.0), motion_model="accel", device=CPU)


def test_cli_tracked_column_on_skipped_frames(dataset, tmp_path):
    """The phased CLI with -t 2: the odd frames, which skip tracking,
    repeat the even frame before them in the ``tracked`` column (JAX's
    phased CLI leaves the state alone on a skipped frame) and keep the
    previous frame's pose; even frames past the bootstrap track."""
    log_path = str(tmp_path / "t2.log")
    cfg = parse_args(["-i", dataset["raw"], "-o", log_path, "-v", "64",
                      "-s", "4.8", "-p", "0.34,0.5,0.24", "-c", "1",
                      "-r", "1", "-t", "2", "-z", "8",
                      "-k", "120.3,120.0,80,60"])
    summary = run(cfg, CPU, max_frames=10, quiet=True)
    assert summary["frames"] == 10
    log = parse_benchmark_log(log_path)
    tracked = log["tracked"].astype(int)
    np.testing.assert_array_equal(tracked[1::2], tracked[0::2])
    assert tracked[4::2].all(), tracked
    # A row logs the pose at its frame's start: frame i+1's row holds
    # frame i's result, so a skipped frame i leaves row i+1 == row i.
    pos = np.stack([log["X"], log["Y"], log["Z"]], 1)
    for i in range(5, 9, 2):
        np.testing.assert_array_equal(pos[i + 1], pos[i])
