"""Port parity for the sparse Schur-complement bundle adjuster
(``slambench_tpu_torch/models/ba.py``) and the keyframe BA problem
constructor, held against the JAX package's ``models/ba.py`` and
``models/keyframes.build_ba_problem`` on the same seeded inputs
(test_ba.py and test_ba_frontend.py mirrored on the port)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu.models import ba as JB  # noqa: E402
from slambench_tpu.models import keyframes as JK  # noqa: E402

from slambench_tpu_torch.geometry import se3_exp  # noqa: E402
from slambench_tpu_torch.models import ba as PB  # noqa: E402
from slambench_tpu_torch.models import keyframes as PK  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-4          # poses and landmarks, port vs JAX (f32)


def _exp(x) -> np.ndarray:
    return se3_exp(torch.as_tensor(np.asarray(x, np.float32))).numpy()


def _problem(seed, n_cams=4, n_lms=12, noise=0.0, pose_noise=0.05,
             lm_noise=0.05):
    """test_ba.py's problem: cameras along a line looking at a landmark
    cloud 3 m ahead, observations from ``make_observations``, initial
    poses (pose 0 exact: the gauge) and landmarks perturbed."""
    rng = np.random.default_rng(seed)
    gt_p = np.stack([_exp([0.5 * i, 0.1 * np.sin(i), 0, 0, 0.05 * i, 0])
                     for i in range(n_cams)])
    gt_l = rng.uniform(-1, 1, size=(n_lms, 3)).astype(np.float32)
    gt_l[:, 2] += 3.0
    obs = PB.make_observations(gt_p, gt_l, noise=noise, rng=rng)
    p0 = np.stack([gt_p[0]] + [gt_p[i] @ _exp(pose_noise * rng.normal(
        size=6)) for i in range(1, n_cams)]).astype(np.float32)
    l0 = (gt_l + lm_noise * rng.normal(size=gt_l.shape)).astype(np.float32)
    return gt_p, gt_l, p0, l0, obs


def _port(*arrays, **kw):
    return [t.numpy() for t in PB.bundle_adjust(
        *map(torch.from_numpy, arrays), **kw)]


def _jax(*arrays, **kw):
    return [np.asarray(t) for t in JB.bundle_adjust(
        *map(jnp.asarray, arrays), **kw)]


def test_make_observations_matches_jax():
    _gt_p, _gt_l, p0, l0, obs = _problem(1, noise=0.01)
    jobs = JB.make_observations(p0, l0, noise=0.01,
                                rng=np.random.default_rng(3))
    pobs = PB.make_observations(p0, l0, noise=0.01,
                                rng=np.random.default_rng(3))
    for a, b in zip(pobs, jobs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bundle_adjust_matches_jax():
    """4 cameras, 12 landmarks, observation noise 0.01: poses and
    landmarks within TOL of JAX's after the default 5 iterations and
    with a pinned CG depth."""
    _gt_p, _gt_l, p0, l0, obs = _problem(2, noise=0.01)
    for kw in ({}, {"n_iters": 4, "n_cg": 24}):
        got = _port(p0, l0, *obs, **kw)
        want = _jax(p0, l0, *obs, **kw)
        np.testing.assert_allclose(got[0], want[0], atol=TOL)
        np.testing.assert_allclose(got[1], want[1], atol=TOL)
        assert abs(float(got[2]) - float(want[2])) <= 1e-6


def test_ba_converges_to_ground_truth():
    gt_p, gt_l, p0, l0, obs = _problem(3, n_cams=6, n_lms=24)
    out_p, out_l, r2 = _port(p0, l0, *obs, n_iters=8)
    assert np.linalg.norm(out_p[:, :3, 3] - gt_p[:, :3, 3], axis=1).max() \
        < 1e-3
    assert np.linalg.norm(out_l - gt_l, axis=1).max() < 1e-3
    assert float(r2) < 1e-6


def test_ba_padding_inert():
    """Zero-weight observations, identity-pose cameras and zero landmarks
    appended as padding leave the real solution within 1e-5, and the
    padded cameras and landmarks exactly where they started."""
    _gt_p, _gt_l, p0, l0, (cam, lm, z, w) = _problem(4)
    a_p, a_l, _ = _port(p0, l0, cam, lm, z, w, n_iters=4, n_cg=24)
    obs_pad = (np.concatenate([cam, np.zeros(7, np.int32)]),
               np.concatenate([lm, np.zeros(7, np.int32)]),
               np.concatenate([z, 99 * np.ones((7, 3), np.float32)]),
               np.concatenate([w, np.zeros(7, np.float32)]))
    b_p, b_l, _ = _port(p0, l0, *obs_pad, n_iters=4, n_cg=24)
    np.testing.assert_allclose(b_p, a_p, atol=1e-5)
    np.testing.assert_allclose(b_l, a_l, atol=1e-5)
    eye = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    c_p, c_l, _ = _port(np.concatenate([p0, eye]),
                        np.concatenate([l0, np.zeros((4, 3), np.float32)]),
                        cam, lm, z, w, n_iters=4, n_cg=24)
    np.testing.assert_allclose(c_p[:4], a_p, atol=1e-5)
    np.testing.assert_allclose(c_l[:12], a_l, atol=1e-5)
    np.testing.assert_array_equal(c_p[4:], eye)
    np.testing.assert_array_equal(c_l[12:], np.zeros((4, 3), np.float32))


def _snapshots(seed, n_kf=5, h=12, w=16):
    """Keyframe snapshots as raycast maps hold them: world points of a
    shared cloud seen from drifting poses, with invalid pixels (zero
    vertex, INVALID normal)."""
    rng = np.random.default_rng(seed)
    world = rng.uniform(1.0, 3.0, size=(h * w, 3)).astype(np.float32)
    out = []
    for i in range(n_kf):
        pose = _exp([0.1 * i, 0.05 * i, 0.02 * i, 0.01 * i, 0.0, 0.02 * i])
        pts = world + 0.004 * rng.normal(size=world.shape)
        vert = pts.T.reshape(3, h, w).astype(np.float32)
        norm = np.zeros_like(vert)
        norm[2] = 1.0
        holes = rng.random((h, w)) < 0.1
        vert[:, holes] = 0.0
        norm[0, holes] = -2.0
        out.append((i, 5 * i, pose.astype(np.float32), vert, norm))
    return out


def test_build_ba_problem_matches_jax():
    """The same snapshots give JAX's arrays exactly: landmarks, the
    observation lists, the power-of-two padding, with the creation poses
    and with other current poses; None when degenerate."""
    snaps = _snapshots(6)
    port = [PK.Keyframe(*s) for s in snaps]
    jax_ = [JK.Keyframe(*s) for s in snaps]
    moved = [s[2] @ _exp([0.01, 0, 0, 0, 0, 0.002]) for s in snaps]
    for kw in ({}, {"stride": 1, "cell": 0.2}, {"poses_cur": moved},
               {"stride": 1, "max_obs": 100}):
        got = PK.build_ba_problem(port, **kw)
        want = JK.build_ba_problem(jax_, **kw)
        assert got is not None
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        k = len(got[2])
        assert k & (k - 1) == 0 and got[5].sum() > 0
    assert PK.build_ba_problem(port[:1]) is None
    assert PK.build_ba_problem([]) is None


def test_keyframe_on_host_feeds_build_ba_problem():
    """Device snapshots (tensors) reach build_ba_problem as numpy through
    ``Keyframe.on_host``, with the same result as numpy snapshots."""
    snaps = _snapshots(7, n_kf=3)
    host = [PK.Keyframe(*s) for s in snaps]
    dev = [PK.Keyframe(i, f, p, torch.from_numpy(v), torch.from_numpy(n))
           for i, f, p, v, n in snaps]
    for a, b in zip(PK.build_ba_problem([k.on_host() for k in dev]),
                    PK.build_ba_problem(host)):
        np.testing.assert_array_equal(a, b)
