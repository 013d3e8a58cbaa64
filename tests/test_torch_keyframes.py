"""Port parity for the keyframe layer's wrapper: the loop-closure ICP
(``PoseGraphKFusion.align``: the plain K2F twin and the port's
``update_pose`` on the CPU) and ``PoseGraphKFusion`` with both backends,
each held against the JAX package's ``models/keyframes.py`` on the same
inputs.

The inputs are per-frame states made from a seed: depth frames of the
synthetic scene rendered along the revisiting orbit, back-projected to
world-frame vertex/normal maps through a pose that drifts from the
ground truth (the shape of KinectFusion's raycast maps and odometry).
Both wrap a stub pipeline that replays these states, so what is
compared is the keyframe layer alone."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu.models import keyframes as JK  # noqa: E402

from slambench_tpu_torch import params  # noqa: E402
from slambench_tpu_torch.geometry import (  # noqa: E402
    get_inverse_camera_matrix, se3_exp, transform,
)
from slambench_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticScene, orbit_trajectory, render_depth_frame,
)
from slambench_tpu_torch.models import keyframes as PK  # noqa: E402
from slambench_tpu_torch.ops.vertex import (  # noqa: E402
    depth2vertex, vertex2normal,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")
N_FRAMES, PERIOD = 28, 15
REPLAY = 16         # frames replayed through both wrappers
SIZE = (160, 120)
CAMERA = (120.3, 120.0, 80.0, 60.0)
DIM = (4.8, 4.8, 4.8)
TOL = 1e-4          # poses and relative poses, port vs JAX (f32)


@pytest.fixture(scope="module")
def states():
    """[(pose [4,4], vertex [3,H,W], normal [3,H,W])] as numpy f32: the
    orbit's depth frames seen through a pose with a seeded random-walk
    drift from the ground truth."""
    scene = SyntheticScene(dim=DIM)
    gt = orbit_trajectory(N_FRAMES, [0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8],
                          amp=0.3, period=PERIOD)
    rng = np.random.default_rng(11)
    drift = np.cumsum(rng.normal(size=(N_FRAMES, 6)) * np.array(
        [2e-3, 2e-3, 2e-3, 1e-3, 1e-3, 1e-3]), axis=0).astype(np.float32)
    inv_k = get_inverse_camera_matrix(torch.tensor(CAMERA))
    out = []
    for i in range(N_FRAMES):
        pose = gt[i] @ se3_exp(torch.from_numpy(drift[i])).numpy()
        depth = torch.from_numpy(render_depth_frame(
            scene, gt[i], CAMERA, SIZE, CPU).astype(np.float32) / 1000.0)
        v = depth2vertex(depth, inv_k)
        world = torch.where(depth[None] > 0,
                            transform(torch.from_numpy(pose), v),
                            torch.zeros_like(v))
        out.append((pose.astype(np.float32), world.numpy(),
                    vertex2normal(world).numpy()))
    return out


class _Replay:
    """Stands in for KFusion: ``process_frame`` returns the recorded
    state of the frame, as tensors (port) or numpy arrays (JAX)."""

    def __init__(self, states, as_tensor: bool):
        self.camera = CAMERA
        self.device = CPU
        conv = torch.from_numpy if as_tensor else (lambda x: x)
        self.states = [types.SimpleNamespace(
            pose=conv(p), ref_vertex=conv(v), ref_normal=conv(n))
            for p, v, n in states]

    def process_frame(self, state, depth, frame, tracking_rate=1,
                      integration_rate=2):
        return self.states[frame]


_JAX_ALIGN = {}


def _wrappers(states, backend):
    """The port's and JAX's wrapper over the replayed states. The JAX
    wrappers share one jitted ``_align`` (each instance would compile its
    own; all use the same ``icp_iters``)."""
    port = PK.PoseGraphKFusion(
        _Replay(states, True),
        PK.KeyframeStore(trans_threshold=0.08, rot_threshold=0.08),
        optimize_every=3, backend=backend)
    jax_ = JK.PoseGraphKFusion(
        _Replay(states, False),
        JK.KeyframeStore(trans_threshold=0.08, rot_threshold=0.08),
        optimize_every=3, backend=backend)
    jax_._align = _JAX_ALIGN.setdefault("align", jax_._align)
    return port, jax_


def test_align_matches_jax(states):
    """One loop-closure alignment of a snapshot pair one orbit period
    apart after the orbit's ease-in (the same true pose, different
    drift): the relative pose within
    TOL and the inlier count equal. The pair lies clear of both
    acceptance gates, so rounding cannot decide them."""
    port, jax_ = _wrappers(states, "posegraph")
    i, j = 12 + PERIOD, 12
    snap = [(np.ascontiguousarray(v[:, ::2, ::2]),
             np.ascontiguousarray(n[:, ::2, ::2]))
            for _, v, n in (states[i], states[j])]
    cand_pose = states[j][0]
    rel, red = port.align(
        *(torch.from_numpy(a) for a in (*snap[0], *snap[1])),
        torch.eye(4), port._K @ torch.linalg.inv(torch.from_numpy(cand_pose)))
    jrel, jred = jax_._align(
        *(jnp.asarray(a) for a in (*snap[0], *snap[1])), jnp.eye(4),
        jax_._K @ jnp.linalg.inv(jnp.asarray(cand_pose)))
    np.testing.assert_allclose(rel.numpy(), np.asarray(jrel), atol=TOL)
    count = float(red[28])
    assert count == float(jred[28])
    npix = snap[0][0].shape[1] * snap[0][0].shape[2]
    rms = float(np.sqrt(float(red[0]) / count))
    assert count / npix > 0.4 and rms < 0.5 * params.RMS_RESIDUAL_BOUND
    # The alignment moves the pose (the drift differs between the two).
    assert np.abs(rel.numpy() - np.eye(4)).max() > 1e-3


@pytest.mark.parametrize("backend", ["posegraph", "ba"])
def test_posegraph_kfusion_matches_jax(states, backend):
    """Both wrappers on the same replayed states: the same keyframes and
    graph edges (loop closures included) and corrected trajectories
    within TOL, through three optimizations. (Further on, BA's landmark
    hashing is discrete: pose differences of ~1e-5 m move points across
    cell borders, and the two sides then solve different problems.)"""
    port, jax_ = _wrappers(states, backend)
    for frame in range(REPLAY):
        port.process_frame(None, None, frame)
        jax_.process_frame(None, None, frame)
    assert [k.frame for k in port.store.keyframes] \
        == [k.frame for k in jax_.store.keyframes]
    edges = [(i, j) for i, j, _T, _w in port.graph.edges]
    assert edges == [(i, j) for i, j, _T, _w in jax_.graph.edges]
    assert sum(abs(i - j) > 1 for i, j in edges) >= 1
    assert port.alignments >= sum(abs(i - j) > 1 for i, j in edges)
    for (_, _, T, w), (_, _, jT, jw) in zip(port.graph.edges,
                                          jax_.graph.edges):
        np.testing.assert_allclose(T, jT, atol=TOL)
        assert abs(w - jw) < 1e-6
    np.testing.assert_allclose(np.stack(port._trajectory),
                               np.stack(jax_._trajectory), atol=0)
    np.testing.assert_allclose(port.corrected_trajectory(),
                               jax_.corrected_trajectory(), atol=TOL)
