"""The keyframe layer on a CUDA card: the pose graph (whose class
optimizes on the card by default) and bundle adjustment against the
same functions on the CPU, the loop-closure
alignment through K2F against its plain twin, and the CLI's
``--keyframes --ba`` route with K2F's launches split between the frame
path and the alignment.

On the card ``index_add_`` adds with float atomics in an order that
varies between runs, so the card's results agree with the CPU's within
a tolerance (``CARD_TOL``, 1e-4 on poses and landmarks), not bit for
bit. Imports torch and the port only (no JAX), so it runs on the card's
machine with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_keyframes.py -m cuda

Without a card every test skips."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch.geometry import (  # noqa: E402
    get_inverse_camera_matrix, mat4mul, rigid_inverse, se3_exp, transform,
)
from slambench_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticScene, generate_dataset, orbit_trajectory, render_depth_frame,
)
from slambench_tpu_torch.models.ba import (  # noqa: E402
    bundle_adjust, make_observations,
)
from slambench_tpu_torch.models.keyframes import (  # noqa: E402
    KeyframeStore, PoseGraphKFusion,
)
from slambench_tpu_torch.models.posegraph import (  # noqa: E402
    PoseGraph, optimize_pose_graph,
)
from slambench_tpu_torch.ops.hopper import reduce  # noqa: E402
from slambench_tpu_torch.ops.vertex import (  # noqa: E402
    depth2vertex, vertex2normal,
)
from slambench_tpu_torch.policy import apply_precision_policy  # noqa: E402

pytestmark = pytest.mark.cuda
CPU = torch.device("cpu")
CARD_TOL = 1e-4
CAMERA = (120.3, 120.0, 80.0, 60.0)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    apply_precision_policy()
    return torch.device("cuda")


def _exp(x) -> np.ndarray:
    return se3_exp(torch.as_tensor(np.asarray(x, np.float32))).numpy()


def test_pose_graph_on_card_matches_cpu(dev):
    rng = np.random.default_rng(21)
    gt = [_exp([np.cos(a), np.sin(a), 0, 0, 0, a])
          for a in 2 * np.pi * np.arange(8) / 8]
    est, ij, T = [gt[0]], [], []
    for i in range(1, 8):
        meas = (np.linalg.inv(gt[i - 1]) @ gt[i]
                @ _exp(0.01 * rng.normal(size=6)))
        est.append(est[-1] @ meas @ _exp(0.02 * rng.normal(size=6)))
        ij.append((i - 1, i))
        T.append(meas)
    ij += [(0, 7), (2, 6)] + [(0, 0)] * 7
    T += [np.linalg.inv(gt[0]) @ gt[7], np.linalg.inv(gt[2]) @ gt[6]]
    T += [np.eye(4)] * 7
    args = (np.stack(est).astype(np.float32), np.array(ij, np.int32),
            np.stack(T).astype(np.float32),
            np.array([1.0] * 7 + [2.0, 2.0] + [0.0] * 7, np.float32))
    cpu, _ = optimize_pose_graph(*map(torch.from_numpy, args))
    card, _ = optimize_pose_graph(*(torch.from_numpy(a).to(dev)
                                    for a in args))
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(),
                               atol=CARD_TOL)


def test_pose_graph_class_defaults_to_the_card(dev):
    graph = PoseGraph()
    assert graph.device.type == "cuda"
    graph.add_pose(np.eye(4, dtype=np.float32))
    graph.add_pose(_exp([0.1, 0, 0, 0, 0, 0.05]))
    graph.add_odometry_edge(0, 1)
    poses = graph.optimize(n_iters=2)
    assert poses.shape == (2, 4, 4) and np.isfinite(poses).all()


def test_bundle_adjust_on_card_matches_cpu(dev):
    rng = np.random.default_rng(2)
    gt_p = np.stack([_exp([0.5 * i, 0.1 * np.sin(i), 0, 0, 0.05 * i, 0])
                     for i in range(4)])
    gt_l = rng.uniform(-1, 1, size=(12, 3)).astype(np.float32)
    gt_l[:, 2] += 3.0
    obs = make_observations(gt_p, gt_l, noise=0.01, rng=rng)
    p0 = np.stack([gt_p[0]] + [gt_p[i] @ _exp(0.05 * rng.normal(size=6))
                               for i in range(1, 4)]).astype(np.float32)
    l0 = (gt_l + 0.05 * rng.normal(size=gt_l.shape)).astype(np.float32)
    args = (p0, l0, *obs)
    cpu = bundle_adjust(*map(torch.from_numpy, args), n_iters=4, n_cg=64)
    card = bundle_adjust(*(torch.from_numpy(a).to(dev) for a in args),
                         n_iters=4, n_cg=64)
    for a, b in zip(card[:2], cpu[:2]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=CARD_TOL)


def _snapshot(scene, gt, drift, dev):
    """A world-frame vertex/normal map (raycast-map shape) of the depth
    rendered at ``gt``, back-projected through the drifted pose,
    downsampled by 2 and contiguous, as a keyframe stores it."""
    pose = gt @ _exp(drift)
    depth = torch.from_numpy(render_depth_frame(
        scene, gt, CAMERA, (160, 120), dev).astype(np.float32) / 1000.0
    ).to(dev)
    v = depth2vertex(depth, get_inverse_camera_matrix(
        torch.tensor(CAMERA, device=dev)))
    world = torch.where(depth[None] > 0,
                        transform(torch.from_numpy(pose).to(dev), v),
                        torch.zeros_like(v))
    n = vertex2normal(world)
    return (pose.astype(np.float32), world[:, ::2, ::2].contiguous(),
            n[:, ::2, ::2].contiguous())


def test_alignment_through_k2f_matches_cpu_twin(dev):
    """One loop-closure alignment on the card (K2F, 5 launches) and on
    the CPU (the plain twin): the relative pose within CARD_TOL and the
    inlier count equal."""
    scene = SyntheticScene(dim=(4.8,) * 3)
    gt = orbit_trajectory(28, [0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8], amp=0.3,
                          period=15)
    a = _snapshot(scene, gt[27], [0.02, -0.01, 0.01, 0.004, -0.003, 0.002],
                  dev)
    b = _snapshot(scene, gt[12], [0.0] * 6, dev)
    out = {}
    for d in (dev, CPU):
        kf = KeyframeStore()
        pg = PoseGraphKFusion(type("Stub", (), {"camera": CAMERA,
                                                "device": d})(), kf)
        view = mat4mul(pg._K, rigid_inverse(torch.from_numpy(b[0]).to(d)))
        before = reduce.fused_launches
        rel, red = pg.align(a[1].to(d), a[2].to(d), b[1].to(d), b[2].to(d),
                            torch.eye(4, device=d), view)
        out[d.type] = (rel.cpu().numpy(), red.cpu().numpy(),
                       reduce.fused_launches - before)
    assert out["cuda"][2] == 5 and out["cpu"][2] == 0
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=CARD_TOL)
    assert out["cuda"][1][28] == out["cpu"][1][28] > 0


def test_keyframes_ba_cli_on_card(dev, tmp_path):
    from slambench_tpu_torch.eval.trajectory import read_tum
    from slambench_tpu_torch.frontend.benchmark import parse_args, run
    man = generate_dataset(str(tmp_path / "d"), dev, n_frames=14,
                           image_size=(160, 120), amp=0.3, period=12)
    log = str(tmp_path / "kf.log")
    reduce.fused_launches = 0
    summary = run(parse_args(["-i", man["raw"], "-o", log, "-v", "32",
                              "-s", "4.8", "-p", "0.34,0.5,0.24",
                              "-k", "120.3,120.0,80,60"]),
                  dev, quiet=True, keyframes=True, ba=True)
    pg = summary["posegraph"]
    assert pg.backend == "ba" and pg.device.type == "cuda"
    assert pg.store.keyframes[0].vertex.is_cuda
    assert reduce.fused_launches == 19 * 14 + 5 * pg.alignments
    for name in ("kf_raw", "kf_corrected"):
        assert os.path.exists(f"{log}.{name}.tum")
        assert read_tum(f"{log}.{name}.tum").shape == (14, 3)
