"""The port's keyframe layer end to end on the CPU (port only): the JAX
tests' revisiting orbit at 160x120 with a 48^3 volume through
``PoseGraphKFusion`` with online optimization (test_keyframes_e2e.py's
contract). The CLI routes are in test_torch_keyframes_cli.py and the BA
backend's replay in test_torch_keyframes_ba_e2e.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.io.synthetic import generate_dataset  # noqa: E402
from slambench_tpu_torch.models.keyframes import (  # noqa: E402
    KeyframeStore, PoseGraphKFusion,
)
from slambench_tpu_torch.pipeline import KFusion  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
N_FRAMES, PERIOD = 44, 22


@pytest.fixture(scope="module")
def revisit(tmp_path_factory):
    """The orbit repeats exactly after PERIOD frames, so the second lap
    revisits the first: 44 frames, online optimization every 3
    keyframes."""
    man = generate_dataset(str(tmp_path_factory.mktemp("kf_revisit")), CPU,
                           n_frames=N_FRAMES, image_size=(160, 120),
                           dim=(4.8,) * 3, amp=0.3, period=PERIOD)
    rd = RawDepthReader(man["raw"])
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    kf = KFusion((160, 120), (48,) * 3, man["dim"], init, (10, 5, 4),
                 man["camera"], device=CPU)
    slam = PoseGraphKFusion(
        kf, KeyframeStore(trans_threshold=0.08, rot_threshold=0.08),
        optimize_every=3)
    state = kf.init_state()
    for frame in range(N_FRAMES):
        state = slam.process_frame(state, rd.read_next_depth_frame(), frame)
    return man, slam


def test_loop_closure_fires_and_corrects(revisit):
    """Non-consecutive edges come from snapshot ICP through both
    acceptance gates, and the corrected trajectory's tail (frames 22-43,
    where the odometry has drifted) is closer to the truth than the raw
    one (JAX: 0.049 -> 0.038 m)."""
    man, slam = revisit
    n_loops = sum(1 for (i, j, _T, _w) in slam.graph.edges if abs(i - j) > 1)
    assert n_loops >= 1, "revisiting orbit produced no loop closures"
    assert slam.alignments >= n_loops
    assert len(slam.graph.edges) >= len(slam.store.keyframes) - 1
    raw = np.stack(slam._trajectory)
    corr = slam.corrected_trajectory()
    assert raw.shape == corr.shape == (N_FRAMES, 4, 4)
    gt = man["poses"][:N_FRAMES, :3, 3]
    tail = slice(N_FRAMES // 2, N_FRAMES)
    e_raw = np.linalg.norm(raw[:, :3, 3] - gt, axis=1)[tail].mean()
    e_corr = np.linalg.norm(corr[:, :3, 3] - gt, axis=1)[tail].mean()
    assert e_corr < e_raw, (e_corr, e_raw)
    for T in corr[::7]:
        np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3),
                                   atol=1e-4)
    # Snapshots stay on the pipeline's device, contiguous, downsampled.
    kf = slam.store.keyframes[0]
    assert kf.vertex.shape == (3, 60, 80) and kf.vertex.is_contiguous()
