"""The port's BA backend against its pose graph on the JAX tests'
revisiting orbit (test_ba_frontend.py's contract): one odometry pass at
160x120 with a 48^3 volume and no online optimization, then both
optimizers replayed offline on the same keyframe store; the BA tail ATE
must not be worse than the pose graph's (JAX: 0.0345 against 0.0374 m)."""

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


def test_ba_backend_not_worse_than_posegraph_on_replay(tmp_path):
    n, period = 44, 22
    man = generate_dataset(str(tmp_path / "d"), CPU, n_frames=n,
                           image_size=(160, 120), dim=(4.8,) * 3, amp=0.3,
                           period=period)
    rd = RawDepthReader(man["raw"])
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    kf = KFusion((160, 120), (48,) * 3, man["dim"], init, (10, 5, 4),
                 man["camera"], device=CPU)
    slam = PoseGraphKFusion(
        kf, KeyframeStore(trans_threshold=0.08, rot_threshold=0.08),
        optimize_every=10 ** 9)           # optimize offline below
    state = kf.init_state()
    for frame in range(n):
        state = slam.process_frame(state, rd.read_next_depth_frame(), frame)
    assert sum(1 for (i, j, _T, _w) in slam.graph.edges if abs(i - j) > 1)

    gt = man["poses"][:n, :3, 3]
    tail = slice(n // 2, n)

    def tail_ate():
        corr = slam.corrected_trajectory()
        return np.linalg.norm(corr[:, :3, 3] - gt, axis=1)[tail].mean()

    raw = np.linalg.norm(np.stack(slam._trajectory)[:, :3, 3] - gt,
                         axis=1)[tail].mean()
    base = [p.copy() for p in slam.graph.poses]
    slam.graph.optimize(n_iters=8)
    pg = tail_ate()

    slam.graph.poses = base
    slam.backend = "ba"
    slam._optimize_ba()
    ba = tail_ate()
    assert ba <= pg + 1e-4, (ba, pg)
    assert pg < raw, (pg, raw)
