"""Replay one odometry pass through the JAX package's and the port's
keyframe wrappers, on the CPU, at ``chip_smoke.py`` phase 8 (a)'s
settings: the revisiting orbit (640x480, 44 frames, amp 0.3, period 22)
at compute-size ratio 2 (320x240), pyramid 10,5,4, integration every
frame, default keyframe thresholds, optimization every 5 keyframes.

The port's ``KFusion`` runs the odometry once; the per-frame states
(pose, raycast maps) are then replayed through
``PoseGraphKFusion`` of both packages with both backends (online, as
``--keyframes`` and ``--keyframes --ba`` run), and through the offline
procedure of ``test_ba_frontend.py::test_ba_backend_beats_posegraph_on_
revisit`` (no online optimization, then the graph and BA each from the
same unoptimized graph). Prints one JSON line of tail ATEs (frames
22-43, mean position error against the ground truth) and graph counts.

Not a test (pytest does not collect it); it imports both packages, so
it runs where JAX is installed:

    python tests/compare_keyframes_jax.py [--volume 256] [--threads 6]

At 256^3 the odometry takes ~80 s and the replays ~90 s on 6 cores.
"""

import argparse
import json
import os
import sys
import tempfile
import time
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

from slambench_tpu.models import keyframes as JK  # noqa: E402

from slambench_tpu_torch.io.readers import make_reader  # noqa: E402
from slambench_tpu_torch.io.synthetic import generate_dataset  # noqa: E402
from slambench_tpu_torch.models import keyframes as PK  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion  # noqa: E402

CPU = torch.device("cpu")
N_FRAMES, PERIOD, AMP = 44, 22, 0.3
CAMERA = (240.6, 240.0, 160.0, 120.0)      # 481.2,480,320,240 at ratio 2


class _Replay:
    def __init__(self, states, as_tensor: bool):
        self.camera, self.device = CAMERA, CPU
        conv = torch.from_numpy if as_tensor else (lambda x: x)
        self.states = [types.SimpleNamespace(
            pose=conv(p), ref_vertex=conv(v), ref_normal=conv(n))
            for p, v, n in states]

    def process_frame(self, state, depth, frame, *rates):
        return self.states[frame]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--volume", type=int, default=256)
    ap.add_argument("--threads", type=int, default=6)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)

    with tempfile.TemporaryDirectory() as work:
        man = generate_dataset(work, CPU, n_frames=N_FRAMES,
                               image_size=(640, 480), dim=(4.8,) * 3,
                               init_pos_factor=(0.34, 0.5, 0.24), amp=AMP,
                               period=PERIOD)
        kf = KFusion((320, 240), (args.volume,) * 3, (4.8,) * 3,
                     [0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8], (10, 5, 4), CAMERA,
                     device=CPU)
        reader = make_reader(man["raw"])
        state = kf.init_state()
        states = []
        t0 = time.monotonic()
        for frame in range(N_FRAMES):
            state = kf.process_frame(state, reader.read_next_depth_frame(),
                                     frame, 1, 1)
            states.append((state.pose.numpy().copy(),
                           state.ref_vertex.numpy().copy(),
                           state.ref_normal.numpy().copy()))
        odometry_s = time.monotonic() - t0
    gt = np.asarray(man["poses"])[:, :3, 3]

    def tail(traj) -> float:
        return float(np.linalg.norm(traj[:, :3, 3] - gt, axis=1)
                     [PERIOD:N_FRAMES].mean())

    out = {"volume": args.volume, "odometry_s": odometry_s}
    packages = (("port", PK, True), ("jax", JK, False))
    for backend in ("posegraph", "ba"):
        for name, mod, as_tensor in packages:
            drv = mod.PoseGraphKFusion(_Replay(states, as_tensor),
                                       mod.KeyframeStore(), backend=backend)
            for frame in range(N_FRAMES):
                drv.process_frame(None, None, frame)
            edges = [(i, j) for i, j, _T, _w in drv.graph.edges]
            out[f"{name}_{backend}"] = {
                "keyframes": len(drv.store.keyframes), "edges": len(edges),
                "loop_closures": sum(abs(i - j) > 1 for i, j in edges),
                "tail_ate_raw": tail(np.stack(drv._trajectory)),
                "tail_ate_corrected": tail(drv.corrected_trajectory())}
    for name, mod, as_tensor in packages:
        drv = mod.PoseGraphKFusion(_Replay(states, as_tensor),
                                   mod.KeyframeStore(),
                                   optimize_every=10 ** 9)
        for frame in range(N_FRAMES):
            drv.process_frame(None, None, frame)
        base = [p.copy() for p in drv.graph.poses]
        drv.graph.optimize(n_iters=8)
        pg = tail(drv.corrected_trajectory())
        drv.graph.poses = base
        drv.backend = "ba"
        drv._optimize_ba()
        out[f"{name}_offline"] = {"posegraph": pg,
                                  "ba": tail(drv.corrected_trajectory())}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
