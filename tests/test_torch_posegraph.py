"""Port parity for the pose graph (``slambench_tpu_torch/models/
posegraph.py``) and the keyframe promotion policy, held against the JAX
package's ``models/posegraph.py`` and ``models/keyframes.py`` on the
same seeded inputs (test_posegraph.py mirrored on the port)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu.models import keyframes as JK  # noqa: E402
from slambench_tpu.models import posegraph as JP  # noqa: E402

from slambench_tpu_torch.geometry import se3_exp  # noqa: E402
from slambench_tpu_torch.models import keyframes as PK  # noqa: E402
from slambench_tpu_torch.models import posegraph as PP  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-4          # optimized poses, port vs JAX (f32)
CPU = torch.device("cpu")


def _exp(x) -> np.ndarray:
    return se3_exp(torch.as_tensor(np.asarray(x, np.float32))).numpy()


def _circle(n=8, radius=1.0):
    return [_exp([radius * np.cos(a), radius * np.sin(a), 0, 0, 0, a])
            for a in 2 * np.pi * np.arange(n) / n]


@pytest.fixture(scope="module")
def chain():
    """An 8-pose circle driven by noisy odometry edges, two loop edges,
    padded to 16 edges with zero-weight identity slots."""
    rng = np.random.default_rng(21)
    gt = _circle()
    est, ij, T, w = [gt[0]], [], [], []
    for i in range(1, len(gt)):
        rel = np.linalg.inv(gt[i - 1]) @ gt[i]
        meas = rel @ _exp(0.01 * rng.normal(size=6))
        est.append(est[-1] @ meas @ _exp(0.02 * rng.normal(size=6)))
        ij.append((i - 1, i))
        T.append(meas)
        w.append(1.0)
    for a, b in ((0, 7), (2, 6)):
        ij.append((a, b))
        T.append(np.linalg.inv(gt[a]) @ gt[b])
        w.append(2.0)
    pad = 16 - len(ij)
    return (np.stack(gt), np.stack(est).astype(np.float32),
            np.array(ij + [(0, 0)] * pad, np.int32),
            np.concatenate([np.stack(T), np.tile(np.eye(4), (pad, 1, 1))])
            .astype(np.float32),
            np.array(w + [0.0] * pad, np.float32))


def test_optimize_pose_graph_matches_jax(chain):
    gt, est, ij, T, w = chain
    got, r2 = PP.optimize_pose_graph(*map(torch.from_numpy, (est, ij, T, w)))
    want, jr2 = JP.optimize_pose_graph(*map(jnp.asarray, (est, ij, T, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    assert abs(float(r2) - float(jr2)) <= 1e-6 + 1e-3 * float(jr2)
    # The loop edges pull the drifted chain back toward the truth.
    before = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1).mean()
    after = np.linalg.norm(got.numpy()[:, :3, 3] - gt[:, :3, 3],
                           axis=1).mean()
    assert after < 0.5 * before
    for R in got.numpy()[:, :3, :3]:
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)


def test_posegraph_class_matches_jax(chain):
    """``PoseGraph`` (host lists, power-of-two edge padding) on the
    chain's real edges: the same solution as JAX's within TOL."""
    _gt, est, ij, T, w = chain
    port, jax_ = PP.PoseGraph(device=CPU), JP.PoseGraph()
    for p in est:
        assert port.add_pose(p) == jax_.add_pose(p)
    for k in range(int((w > 0).sum())):
        port.add_edge(*ij[k], T[k], w[k])
        jax_.add_edge(*ij[k], T[k], w[k])
    port.add_odometry_edge(3, 5, 0.5)
    jax_.add_odometry_edge(3, 5, 0.5)
    np.testing.assert_allclose(port.optimize(n_iters=8),
                               jax_.optimize(n_iters=8), atol=TOL)
    np.testing.assert_allclose(np.stack(port.poses), np.stack(jax_.poses),
                               atol=TOL)
    assert PP.PoseGraph(device=CPU).optimize().shape == (0, 4, 4)


def test_posegraph_defaults_to_the_card():
    """Without ``device`` the graph optimizes on the card, as JAX's on
    its default device; with no card that raises, as ``resolve_device``
    does, and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present (tests/test_torch_cuda_keyframes.py)")
    with pytest.raises(RuntimeError, match="--device cpu"):
        PP.PoseGraph()


def test_edge_residual_zero_when_consistent():
    gt = _circle(12)
    Tij = np.linalg.inv(gt[2]) @ gt[3]
    r = PP.edge_residual(*(torch.from_numpy(np.asarray(x, np.float32))
                           for x in (gt[2], gt[3], Tij)))
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-5)
    jr = JP.edge_residual(*(jnp.asarray(x, jnp.float32)
                            for x in (gt[2], gt[3], Tij)))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-6)


def test_padded_edges_are_inert(chain):
    """Zero-weight padding edges do not move the solution: the chain's
    real edges alone, and padded to 16 and to 64, agree."""
    _gt, est, ij, T, w = chain
    k = int((w > 0).sum())
    base, _ = PP.optimize_pose_graph(*map(torch.from_numpy, (
        est, ij[:k], T[:k], w[:k])), n_iters=3)
    for cap in (16, 64):
        pad = cap - k
        args = (est, np.concatenate([ij[:k], np.zeros((pad, 2), np.int32)]),
                np.concatenate([T[:k], np.tile(np.eye(4, dtype=np.float32),
                                               (pad, 1, 1))]),
                np.concatenate([w[:k], np.zeros(pad, np.float32)]))
        out, _ = PP.optimize_pose_graph(*map(torch.from_numpy, args),
                                        n_iters=3)
        np.testing.assert_allclose(out.numpy(), base.numpy(), atol=1e-5)


def test_keyframe_store_decisions_match_jax():
    """Promotion and loop-candidate decisions on a seeded pose walk: the
    port's store and JAX's decide alike at every step."""
    rng = np.random.default_rng(5)
    port = PK.KeyframeStore(trans_threshold=0.1, rot_threshold=0.1)
    jax_ = JK.KeyframeStore(trans_threshold=0.1, rot_threshold=0.1)
    snap = np.zeros((3, 8, 8), np.float32)
    pose = np.eye(4, dtype=np.float32)
    promoted = candidates = 0
    for frame in range(60):
        pose = (pose @ _exp(np.concatenate([
            0.04 * rng.normal(size=3), 0.03 * rng.normal(size=3)])))
        pose = pose.astype(np.float32)
        decide = port.should_promote(pose)
        assert decide == jax_.should_promote(pose), frame
        if decide:
            kf = port.promote(frame, pose, torch.from_numpy(snap),
                              torch.from_numpy(snap))
            jkf = jax_.promote(frame, pose, snap, snap)
            assert kf.vertex.shape == (3, 4, 4) and kf.vertex.is_contiguous()
            got = [c.index for c in port.loop_candidates(kf)]
            assert got == [c.index for c in jax_.loop_candidates(jkf)]
            promoted += 1
            candidates += len(got)
    assert promoted >= 10 and candidates >= 1
