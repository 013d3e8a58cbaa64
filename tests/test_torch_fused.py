"""Port parity for the fused ICP data term (``ops/hopper/reduce.py:
track_reduce_cuda``, kernel ``csrc/reduce.cu:slb_track_reduce_f32``) and
for ``mm2meters``.

On the CPU the wrapper runs its plain twin (``track`` then
``reduce_track``); that is held against the JAX package's
``track_and_reduce`` with the Pallas reduction in interpret mode and with
the jnp one. The kernel itself runs only on a card: see
test_torch_cuda.py and ``python3 chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu import geometry as JG  # noqa: E402
from slambench_tpu.ops.preprocess import mm2meters as j_mm2meters  # noqa: E402
from slambench_tpu.ops.track import track_and_reduce as j_track_and_reduce  # noqa: E402
from slambench_tpu.ops.vertex import depth2vertex, vertex2normal  # noqa: E402

from slambench_tpu_torch.ops.hopper import reduce  # noqa: E402
from slambench_tpu_torch.ops.preprocess import mm2meters  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-3)   # tests/test_pallas.py's K2 tolerances


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def inputs():
    """Per level (0, 1 of a 48x128 image): level maps against the
    full-size reference maps under a small pose offset, as numpy."""
    rng = np.random.default_rng(11)
    depth = (1.5 + 0.3 * rng.normal(size=(48, 128))).astype(np.float32)
    depth[depth < 1.0] = 0.0
    depth[12:16, 42:62] = 0.0
    k = np.array([100.0, 100.0, 64.0, 24.0], np.float32)
    ref_v = depth2vertex(jnp.asarray(depth),
                         JG.get_inverse_camera_matrix(jnp.asarray(k)))
    ref_n = vertex2normal(ref_v)
    pose = JG.se3_exp(jnp.array([0.03, -0.02, 0.02, 0.02, -0.01, 0.01]))
    view = JG.get_camera_matrix(jnp.asarray(k))
    out = {}
    for level in (0, 1):
        d = depth[::1 << level, ::1 << level]
        v = depth2vertex(jnp.asarray(d), JG.get_inverse_camera_matrix(
            jnp.asarray(k / (1 << level))))
        out[level] = [np.asarray(a) for a in
                      (v, vertex2normal(v), ref_v, ref_n, pose, view)]
    return out


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_fused_twin_matches_jax_track_and_reduce(inputs, level, use_pallas):
    args = inputs[level]
    got, result = reduce.track_reduce_cuda(*[T(a) for a in args])
    want, wdata = j_track_and_reduce(*[jnp.asarray(a) for a in args],
                                     use_pallas=use_pallas)
    codes = np.asarray(wdata["result"])
    np.testing.assert_array_equal(result.numpy(), codes)
    assert set(np.unique(codes)) >= {1, -1, -4}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got[28] == (codes >= 1).sum() > 0
    assert got[28:].sum() <= codes.size


def test_fused_wrapper_on_cpu_counts_no_launch_and_equals_twin(inputs):
    args = [T(a) for a in inputs[1]]
    reduce.fused_launches = reduce.launches = 0
    got, result = reduce.track_reduce_cuda(*args)
    want, wres = reduce.track_reduce_plain(*args)
    assert torch.equal(got, want) and torch.equal(result, wres)
    assert result.dtype == torch.int32 and result.shape == args[0].shape[1:]
    assert reduce.fused_launches == 0 and reduce.launches == 0


def test_fused_all_no_input_pixels(inputs):
    """Every level normal INVALID: every code -1, no Gram term."""
    v, n, rv, rn, pose, view = [T(a) for a in inputs[1]]
    n = torch.full_like(n, -2.0)
    got, result = reduce.track_reduce_cuda(v, n, rv, rn, pose, view)
    assert (result == -1).all()
    want = torch.zeros(32)
    want[31] = result.numel()
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad,match", [
    ("dtype", "dtypes"), ("level_shape", "shapes"), ("ref_shape", "shapes"),
    ("pose_shape", "shapes"), ("devices", "different devices")])
def test_fused_wrapper_rejects_what_the_kernel_does_not_take(inputs, bad,
                                                             match):
    args = [T(a) for a in inputs[0]]
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "level_shape":
        args[1] = args[1][:, :-1]
    elif bad == "ref_shape":
        args[3] = args[3][:2]
    elif bad == "pose_shape":
        args[4] = args[4][:3]
    else:
        args[5] = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match=match):
        reduce.track_reduce_cuda(*args)


def test_mm2meters_every_uint16_value_bit_for_bit_with_jax():
    mm = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    got = mm2meters(T(mm.astype(np.int32)), 1).numpy()
    want = np.asarray(j_mm2meters(jnp.asarray(mm), 1))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(
        got, mm.astype(np.float32) / np.float32(1000))
