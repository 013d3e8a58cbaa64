"""The window's arithmetic: the rate over the whole window, the mean
latency and the 95th percentile over all frames, the union of device
intervals and the integrate's least bytes."""

import pytest

from kfbench import run, stats


def test_rate_is_all_frames_over_all_the_window():
    read = run.reader("frames_per_s")
    assert read({"frames": 96, "window_s": 10.0}) == pytest.approx(9.6)


def test_p95_is_nearest_rank_over_every_frame():
    lat = [0.1] * 190 + [0.2] * 9 + [1.0]
    assert stats.nearest_rank(lat, 0.95) == 0.1
    lat = [0.1] * 189 + [0.2] * 10 + [1.0]
    assert stats.nearest_rank(lat, 0.95) == 0.2
    with pytest.raises(ValueError):
        stats.nearest_rank([], 0.95)


def test_mean_latency_is_over_every_frame():
    read = run.reader("frame_ms_mean")
    assert read({"latencies_s": [0.1] * 9 + [0.2]}) == pytest.approx(110.0)
    assert read({"latencies_s": []}) is None


def test_union_of_device_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 6.5)]
    assert stats.union(iv) == [(0.0, 2.0), (3.0, 4.0), (6.0, 6.5)]
    busy, span = stats.busy_and_span(iv)
    assert busy == pytest.approx(3.5) and span == pytest.approx(6.5)
    assert stats.idle_share_pct(busy, span) == pytest.approx(
        100 * 3.0 / 6.5)
    assert stats.gaps(iv) == [(2.0, 3.0), (4.0, 6.0)]
    assert stats.busy_and_span([]) == (0.0, 0.0)


def test_integrate_roofline_bytes():
    # 1e6 updated voxels (3 bytes read, 3 written) and a 320x240 float
    # depth map read once.
    b = stats.integrate_bytes(1e6, 320 * 240)
    assert b == 6e6 + 4 * 76800
    ms = b / 3.35e12 * 1e3           # the least time itself
    assert stats.roofline_pct(b, ms) == pytest.approx(100.0)
    read = run.reader("integrate_roofline")
    ctx = {"phase_ms": {"integration": 2 * ms}, "updated_voxels": 1e6,
           "depth_pixels": 76800}
    assert read(ctx) == pytest.approx(50.0)
    assert read({"phase_ms": {}}) is None


def test_idle_and_host_readers():
    from kfbench.trace import Trace
    tr = Trace([("k", 0.0, 1.0), ("k", 3.0, 4.0)],
               [("kfbench.call", 0.0, 4.0), ("aten::copy_", 1.5, 2.5)], 4.0)
    assert run.reader("idle_share.offline")({"trace": tr}) == \
        pytest.approx(50.0)
    assert tr.idle_gaps() == [["aten::copy_", 2.0]]
    assert tr.top_ops() == [["k", 2.0]]
    assert run.reader("host_ms.live")({"host_ms": [0.5, 0.7, 9.0]}) == 0.7
    caps = [{"capture_s": 1.0, "instantiate_s": 0.25}]
    assert run.reader("graph_capture_s")({"captures": caps}) == 1.25
    empty = Trace([], [], 1.0)
    assert run.reader("idle_share.live")({"trace": empty}) is None
