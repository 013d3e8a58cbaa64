"""Port parity for the two hand-kernel modules (K1 bilateral, K2 ICP
reduction) and their plain-torch twins.

On the CPU the wrappers run the plain twins; those are held against the
Pallas kernels in interpret mode and against the JAX jnp versions. The
CUDA kernels themselves run only on a card: see test_torch_cuda.py and
``python3 chip_smoke.py``."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu import geometry as JG  # noqa: E402
from slambench_tpu.ops.pallas.bilateral import bilateral_filter_pallas  # noqa: E402
from slambench_tpu.ops.pallas.reduce import reduce_track_pallas  # noqa: E402
from slambench_tpu.ops.preprocess import bilateral_filter as j_bilateral  # noqa: E402
from slambench_tpu.ops.track import reduce_track as j_reduce  # noqa: E402
from slambench_tpu.ops.track import track as j_track  # noqa: E402
from slambench_tpu.ops.vertex import depth2vertex, vertex2normal  # noqa: E402

from slambench_tpu_torch.casts import f32_to_i32  # noqa: E402
from slambench_tpu_torch.ops.hopper import bilateral, build, reduce  # noqa: E402
from slambench_tpu_torch.ops.preprocess import make_gaussian  # noqa: E402
from slambench_tpu_torch.ops.track import track as t_track  # noqa: E402

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _depth(H, W, seed):
    rng = np.random.default_rng(seed)
    d = (1.5 + 0.3 * rng.normal(size=(H, W))).astype(np.float32)
    d[d < 1.0] = 0.0
    d[H // 4:H // 4 + 4, W // 3:W // 3 + 20] = 0.0
    return d


@pytest.fixture(scope="module")
def depth_image():
    return _depth(48, 128, 11)


# ------------------------------- K1 ---------------------------------- #

@pytest.mark.parametrize("shape", [(48, 128), (13, 21)])
def test_bilateral_plain_matches_pallas_and_jnp(shape):
    d = _depth(*shape, seed=shape[0])
    g = make_gaussian()
    got = bilateral.bilateral_filter_cuda(T(d), g).numpy()   # CPU: plain
    want_pallas = np.asarray(bilateral_filter_pallas(jnp.asarray(d), g,
                                                     interpret=True))
    want_jnp = np.asarray(j_bilateral(jnp.asarray(d), jnp.asarray(g)))
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want_jnp, rtol=1e-5, atol=1e-6)
    assert (got[d == 0] == 0).all()


# ------------------------------- K2 ---------------------------------- #

def _track_inputs(depth, level_shift=0):
    """Level maps (optionally half-size) against full-size reference
    maps, under a small pose offset: a mix of every result code."""
    k = np.array([100.0, 100.0, 64.0, 24.0], np.float32)
    iK = JG.get_inverse_camera_matrix(jnp.asarray(k))
    ref_v = depth2vertex(jnp.asarray(depth), iK)
    ref_n = vertex2normal(ref_v)
    d = depth[::2, ::2] if level_shift else depth
    v = depth2vertex(jnp.asarray(d), JG.get_inverse_camera_matrix(
        jnp.asarray(k / (1 << level_shift))))
    n = vertex2normal(v)
    pose = JG.se3_exp(jnp.array([0.03, -0.02, 0.02, 0.02, -0.01, 0.01]))
    view = JG.get_camera_matrix(jnp.asarray(k))
    return [np.asarray(a) for a in (v, n, ref_v, ref_n, pose, view)]


def _on_camera_plane(args):
    """Move four level-map vertices onto the camera's z = 0 plane (to
    f32 rounding), at x = +-10 m and y = +-10 m: their projections reach
    far past the int32 range or are infinite, so the reference-map index
    gathered there (for the error and J of a -2 pixel, or of a -1 pixel
    where the normal map has a hole) depends on how the float coordinate
    is cast to int32."""
    v, n, rv, rn, pose, view = args
    inv = np.linalg.inv(pose.astype(np.float64))
    v = v.copy()
    for i, (x, y) in enumerate(((10.0, 10.0), (-10.0, 10.0),
                                (10.0, -10.0), (-10.0, -10.0))):
        v[:, 2, 2 + 3 * i] = (inv @ (x, y, 0.0, 1.0))[:3]
    return [v, n, rv, rn, pose, view]


@pytest.mark.parametrize("level_shift", [0, 1])
def test_track_matches_jax(depth_image, level_shift):
    args = _on_camera_plane(_track_inputs(depth_image, level_shift))
    got = t_track(*[T(a) for a in args])
    want = j_track(*[jnp.asarray(a) for a in args])
    res = np.asarray(want["result"])
    np.testing.assert_array_equal(got["result"].numpy(), res)
    assert set(np.unique(res)) >= {1, -1, -2, -4}
    # Every code, -2 included: the port casts the projection to int32 as
    # XLA does (casts.f32_to_i32), so it gathers at the same index.
    np.testing.assert_allclose(got["error"].numpy(),
                               np.asarray(want["error"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["J"].numpy(), np.asarray(want["J"]),
                               rtol=1e-4, atol=1e-5)


def test_f32_to_i32_casts_as_xla():
    x = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.7, -2.7,
                  2147483520.0, -2147483648.0, 2147483648.0], np.float32)
    got = f32_to_i32(T(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.asarray(x).astype(jnp.int32)))


def _trackdata(kind, depth_image):
    if kind == "tracked":
        v, n, rv, rn, pose, view = _track_inputs(depth_image)
        d = j_track(*map(jnp.asarray, (v, n, rv, rn, pose, view)))
        return {k: np.asarray(a) for k, a in d.items()}
    if kind == "padding":      # 13x17: no multiple of any tile
        h, w = 13, 17
        return {"result": np.ones((h, w), np.int32),
                "error": np.full((h, w), 0.5, np.float32),
                "J": np.ones((6, h, w), np.float32)}
    rng = np.random.default_rng(3)
    h, w = 96, 128
    return {"result": rng.choice([1, -1, -2, -3, -4, -5],
                                 size=(h, w)).astype(np.int32),
            "error": rng.standard_normal((h, w)).astype(np.float32),
            "J": rng.standard_normal((6, h, w)).astype(np.float32)}


@pytest.mark.parametrize("kind", ["tracked", "padding", "random_codes"])
def test_reduce_plain_matches_pallas(kind, depth_image):
    data = _trackdata(kind, depth_image)
    got = reduce.reduce_track_cuda({k: T(a) for k, a in data.items()}).numpy()
    jdata = {k: jnp.asarray(a) for k, a in data.items()}
    want = np.asarray(reduce_track_pallas(jdata, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(j_reduce(jdata)),
                               rtol=1e-4, atol=1e-3)
    assert got[28:].sum() <= data["result"].size
    if kind == "padding":
        assert got[28] == 13 * 17


# ------------------------- wrappers and build ------------------------- #

def test_wrappers_on_cpu_use_plain_and_count_nothing(depth_image):
    bilateral.launches = 0
    reduce.launches = 0
    d = T(depth_image)
    g = make_gaussian()
    np.testing.assert_array_equal(bilateral.bilateral_filter_cuda(d, g).numpy(),
                                  bilateral.plain(d, g).numpy())
    data = {k: T(a) for k, a in _trackdata("random_codes", None).items()}
    np.testing.assert_array_equal(reduce.reduce_track_cuda(data).numpy(),
                                  reduce.plain(data).numpy())
    assert bilateral.launches == 0 and reduce.launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take(depth_image):
    g = make_gaussian()
    with pytest.raises(ValueError, match="float32"):
        bilateral.bilateral_filter_cuda(T(depth_image).double(), g)
    with pytest.raises(ValueError, match="radius 2"):
        bilateral.bilateral_filter_cuda(T(depth_image), g, r=1)
    data = {k: T(a) for k, a in _trackdata("padding", None).items()}
    with pytest.raises(ValueError, match="dtypes"):
        reduce.reduce_track_cuda(dict(data, result=data["result"].long()))
    with pytest.raises(ValueError, match="shapes"):
        reduce.reduce_track_cuda(dict(data, J=data["J"][:5]))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc (as on a CPU-only machine): the build raises with a clear
    message and nothing falls back."""
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()
    assert build._lib is None
    assert not (tmp_path / "_build").exists()
