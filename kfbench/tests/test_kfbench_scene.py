"""The seeded frames: the same seed gives the same frames, another seed
other frames of the same sizes, and the stream cycles through the lap."""

import numpy as np
import torch

from conftest import small_setting
from kfbench import scene

CPU = torch.device("cpu")


def small(seed):
    cfg = small_setting(width=64, volume=32)
    cfg["orbit"] = {"amp": 0.25, "period": 12}
    return scene.make_stream(cfg, seed, CPU)


def test_same_seed_same_frames():
    a, b = small(2 ** 31 + 5), small(2 ** 31 + 5)
    assert torch.equal(a["depth"], b["depth"])
    assert np.array_equal(a["poses"], b["poses"])


def test_seed_changes_frames_not_sizes():
    runs = [small(s) for s in (1, 2, 3, 4, 5)]
    shapes = {tuple(r["depth"].shape) for r in runs}
    assert shapes == {(scene.lap_frames(12), 48, 64)}
    assert not torch.equal(runs[0]["depth"], runs[1]["depth"])
    assert {r["direction"] for r in runs} == {1, -1}
    for r in runs:
        d = r["depth"]
        assert d.dtype == torch.int32 and int(d.min()) >= 0
        assert int(d.max()) <= 65535 and float((d > 0).float().mean()) > 0.9
        # Every seed starts at the deployment's initial pose.
        assert np.allclose(r["poses"][0][:3, 3], [0.34 * 4.8, 0.5 * 4.8,
                                                  0.24 * 4.8])


def test_stream_cycles_through_the_lap():
    period = 60
    poses = scene.orbit(scene.lap_frames(period) + period, [1, 2, 1], 0.25,
                        period)
    for f in range(scene.EASE_IN, scene.lap_frames(period)):
        assert np.allclose(poses[f], poses[f + period], atol=1e-5)
    for f in range(200):
        i = scene.frame_index(f, period)
        assert np.allclose(poses[i] if i < len(poses) else None,
                           scene.orbit(f + 1, [1, 2, 1], 0.25, period)[f],
                           atol=1e-4)


def test_same_frame_ate():
    gt = np.zeros((3, 3))
    pos = np.array([[0.0, 0.0, 0.01], [0.0, 0.0, 0.0], [0.03, 0.04, 0.0]])
    ate = scene.same_frame_ate(pos, gt)
    assert np.isclose(ate["ate_mean_m"], 0.02)
    assert np.isclose(ate["ate_max_m"], 0.05)
