"""Port parity: slambench_tpu_torch ops vs the JAX package on the same
numpy inputs (made from a seed). Each assertion states its tolerance;
they are the JAX suite's own for the same op (test_geometry.py,
test_ops.py, test_raycast_fast.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu import geometry as JG  # noqa: E402
from slambench_tpu import volume as JVol  # noqa: E402
from slambench_tpu.ops import preprocess as JP  # noqa: E402
from slambench_tpu.ops import vertex as JV  # noqa: E402
from slambench_tpu.ops.integrate import integrate as j_integrate  # noqa: E402
from slambench_tpu.ops.raycast_fast import (  # noqa: E402
    make_min_mip as j_min_mip, make_skip_mip as j_skip_mip,
)

from slambench_tpu_torch import geometry as TG  # noqa: E402
from slambench_tpu_torch import volume as TVol  # noqa: E402
from slambench_tpu_torch.ops import preprocess as TP  # noqa: E402
from slambench_tpu_torch.ops import vertex as TV  # noqa: E402
from slambench_tpu_torch.ops.integrate import integrate as t_integrate  # noqa: E402
from slambench_tpu_torch.ops.raycast_fast import (  # noqa: E402
    make_min_mip as t_min_mip, make_skip_mip as t_skip_mip,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def N(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def depth_image():
    """Structured depth with a hole and a step edge (test_ops.py's)."""
    H, W = 24, 32
    d = 1.5 + 0.2 * np.sin(np.linspace(0, 3, W))[None, :] \
        + 0.1 * np.cos(np.linspace(0, 2, H))[:, None]
    d = d.astype(np.float32)
    d[5:9, 5:9] = 0.0
    d[12:, 20:] += 0.8
    return d


# ------------------------------ geometry ------------------------------ #

TWISTS = {
    "zero": [0.0] * 6,
    "translation": [0.1, -0.2, 0.3, 0.0, 0.0, 0.0],
    "rotation": [0.05, 0.02, -0.03, 0.3, -0.1, 0.2],
    "small_angle": [0.01, 0.0, 0.0, 1e-5, 0.0, 0.0],
    "mid_angle": [0.01, 0.0, 0.0, 5e-4, 0.0, 0.0],
    "large": [0.4, -0.1, 0.2, 0.3, 0.2, -0.1],
}


@pytest.mark.parametrize("name", sorted(TWISTS))
def test_se3_exp_matches_jax(name):
    x = np.asarray(TWISTS[name], np.float32)
    got = N(TG.se3_exp(T(x)))
    want = np.asarray(JG.se3_exp(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[:3, :3] @ got[:3, :3].T, np.eye(3),
                               atol=1e-6)


@pytest.mark.parametrize("name", ["translation", "rotation", "large"])
def test_se3_log_matches_jax(name):
    T4 = np.asarray(JG.se3_exp(jnp.asarray(TWISTS[name], jnp.float32)))
    got = N(TG.se3_log(T(T4)))
    np.testing.assert_allclose(got, np.asarray(JG.se3_log(jnp.asarray(T4))),
                               atol=1e-5)
    np.testing.assert_allclose(got, TWISTS[name], atol=1e-5)


def test_camera_matrices_and_rigid_inverse():
    k = np.array([481.2, 480.0, 320.0, 240.0], np.float32)
    K, iK = N(TG.get_camera_matrix(T(k))), N(TG.get_inverse_camera_matrix(T(k)))
    np.testing.assert_allclose(K, np.asarray(JG.get_camera_matrix(jnp.asarray(k))))
    np.testing.assert_allclose(
        iK, np.asarray(JG.get_inverse_camera_matrix(jnp.asarray(k))), rtol=1e-6)
    np.testing.assert_allclose(K @ iK, np.eye(4), atol=1e-4)
    M = np.asarray(JG.se3_exp(jnp.asarray(TWISTS["large"], jnp.float32)))
    Mi = N(TG.rigid_inverse(T(M)))
    np.testing.assert_allclose(Mi, np.asarray(JG.rigid_inverse(jnp.asarray(M))),
                               atol=1e-6)
    np.testing.assert_allclose(M @ Mi, np.eye(4), atol=1e-6)


def test_transform_rotate_match_jax(rng):
    M = np.asarray(JG.se3_exp(jnp.asarray(TWISTS["large"], jnp.float32)))
    v = rng.normal(size=(3, 4, 5)).astype(np.float32)
    for tf, jf in ((TG.transform, JG.transform), (TG.rotate, JG.rotate)):
        np.testing.assert_allclose(N(tf(T(M), T(v))),
                                   np.asarray(jf(jnp.asarray(M), jnp.asarray(v))),
                                   atol=1e-6)


def test_make_jtj_packing():
    tri = np.arange(21, dtype=np.float32) + 1
    C = N(TG.make_jtj(T(tri)))
    np.testing.assert_array_equal(C, np.asarray(JG.make_jtj(jnp.asarray(tri))))
    assert C[0, 0] == 1 and C[0, 5] == 6 and C[1, 1] == 7 and C[5, 5] == 21


def _packed(C, b):
    return np.concatenate([b, C[np.triu_indices(6)]]).astype(np.float32)


@pytest.mark.parametrize("case", ["well_posed", "rank_deficient", "zero"])
def test_solve_normal_equations_matches_jax(case, rng):
    if case == "well_posed":
        Jr = rng.normal(size=(100, 6)).astype(np.float32)
        e = rng.normal(size=100).astype(np.float32)
        packed = _packed(Jr.T @ Jr, Jr.T @ e)
        expect = np.linalg.solve(Jr.T @ Jr, Jr.T @ e)
        tol = dict(rtol=1e-3, atol=1e-4)
    elif case == "rank_deficient":
        # The 1e6 condition clamp zeroes the null directions: the answer
        # is the minimum-norm solution 2 j / |j|^2.
        j = np.array([1.0, 2, 3, 4, 5, 6], np.float32)
        packed = _packed(np.outer(j, j), j * 2.0)
        expect = 2 * j / np.dot(j, j)
        tol = dict(atol=1e-5)
    else:
        packed = np.zeros(27, np.float32)
        expect = np.zeros(6)
        tol = dict(atol=0)
    got = N(TG.solve_normal_equations(T(packed)))
    want = np.asarray(JG.solve_normal_equations(jnp.asarray(packed)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, expect, **tol)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_jacobi_eigh_matches_jax(rng):
    A = rng.normal(size=(6, 6)).astype(np.float32)
    C = A @ A.T
    lt, Vt = map(N, TG.sym_eigh6_jacobi(T(C)))
    lj, Vj = map(np.asarray, JG.sym_eigh6_jacobi(jnp.asarray(C)))
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.abs(Vt), np.abs(Vj), atol=1e-4)


# ----------------------------- preprocess ----------------------------- #

def test_mm2meters_matches_jax():
    raw = (np.arange(48 * 64) % 5000).astype(np.uint16).reshape(48, 64)
    got = N(TP.mm2meters(T(raw.astype(np.int32)), 2))
    np.testing.assert_array_equal(got, np.asarray(JP.mm2meters(jnp.asarray(raw), 2)))
    assert got.shape == (24, 32)


def test_half_sample_matches_jax(depth_image):
    got = N(TP.half_sample_robust(T(depth_image), 0.3, 1))
    want = np.asarray(JP.half_sample_robust(jnp.asarray(depth_image), 0.3, 1))
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)


def test_vertex_and_normal_match_jax(depth_image):
    k = np.array([100.0, 100.0, 16.0, 12.0], np.float32)
    got_v = TV.depth2vertex(T(depth_image), TG.get_inverse_camera_matrix(T(k)))
    want_v = JV.depth2vertex(jnp.asarray(depth_image),
                             JG.get_inverse_camera_matrix(jnp.asarray(k)))
    np.testing.assert_allclose(N(got_v), np.asarray(want_v), rtol=1e-5, atol=1e-6)
    got_n = N(TV.vertex2normal(got_v))
    want_n = np.asarray(JV.vertex2normal(want_v))
    inv = want_n[0] == -2.0
    np.testing.assert_array_equal(got_n[0] == -2.0, inv)
    np.testing.assert_allclose(got_n[:, ~inv], want_n[:, ~inv], rtol=1e-4,
                               atol=1e-5)


# ------------------------------- volume ------------------------------- #

def test_pack_tsdf_truncates_toward_zero():
    vals = np.array([0.9999, -0.9999, 0.5, -0.5, 1.0, -1.0], np.float32)
    np.testing.assert_array_equal(
        N(TVol.pack_tsdf(T(vals))), np.asarray(JVol.pack_tsdf(jnp.asarray(vals))))


@pytest.mark.parametrize("fn", ["interp", "grad"])
def test_interp_grad_match_jax(fn, rng):
    tsdf = (rng.normal(size=(8, 8, 8)) * 1000).astype(np.int16)
    dim = (2.0, 2.0, 2.0)
    # Points across the volume, the border clamp band included.
    pts = rng.uniform(-0.1, 2.1, size=(3, 5, 7)).astype(np.float32)
    got = N(getattr(TVol, fn)(T(tsdf), dim, T(pts)))
    want = np.asarray(getattr(JVol, fn)(jnp.asarray(tsdf), dim,
                                        jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("pose_name", ["front", "rotated"])
def test_integrate_matches_jax(depth_image, pose_name):
    rng = np.random.default_rng(5)
    res, dim = (16, 16, 16), (2.0, 2.0, 2.0)
    tsdf = rng.integers(-32766, 32767, (16,) * 3).astype(np.int16)
    weight = rng.integers(0, 100, (16,) * 3).astype(np.int8)
    k = np.array([100.0, 100.0, 16.0, 12.0], np.float32)
    if pose_name == "front":
        pose = np.asarray(JG.translation_pose([1.0, 1.0, 0.0]))
    else:
        pose = np.asarray(JG.mat4mul(
            JG.translation_pose([1.0, 0.9, 0.1]),
            JG.se3_exp(jnp.asarray([0, 0, 0, 0.1, -0.2, 0.05], jnp.float32))))
    inv = np.asarray(JG.rigid_inverse(jnp.asarray(pose)))
    K = np.asarray(JG.get_camera_matrix(jnp.asarray(k)))
    gt, gw = map(N, t_integrate(T(tsdf), T(weight), T(depth_image), T(inv),
                                T(K), 0.1, 100.0, dim))
    jt, jw = map(np.asarray, j_integrate(
        jnp.asarray(tsdf), jnp.asarray(weight), jnp.asarray(depth_image),
        jnp.asarray(inv), jnp.asarray(K), 0.1, 100.0, dim))
    assert (gw != weight).sum() > 50          # the frame really fused
    np.testing.assert_array_equal(gw, jw)     # weights identical
    assert np.abs(gt.astype(np.int32) - jt.astype(np.int32)).max() <= 1


def test_min_and_skip_mip_match_jax(rng):
    # A sphere-ish TSDF with a surface, plus noise, at a non-multiple size.
    c = np.linspace(-1, 1, 40)
    Z, Y, X = np.meshgrid(c, c[:36], c[:44], indexing="ij")
    sdf = np.clip((np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.5) / 0.2, -1, 1)
    tsdf = np.trunc(sdf * 32766).astype(np.int16)
    mip_t = t_min_mip(T(tsdf))
    mip_j = j_min_mip(jnp.asarray(tsdf))
    np.testing.assert_array_equal(N(mip_t), np.asarray(mip_j))
    assert mip_t.dtype == torch.int16
    skip_t = t_skip_mip(mip_t)
    np.testing.assert_array_equal(N(skip_t), np.asarray(j_skip_mip(mip_j)))
    assert skip_t.dtype == torch.int8 and 0 < int((N(skip_t) == 0).sum())
