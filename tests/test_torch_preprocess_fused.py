"""Port parity for the fused preprocessing kernel K1F (``ops/hopper/
bilateral.py:mm2m_bilateral_cuda``, kernel ``csrc/bilateral.cu:
slb_mm2m_bilateral_f32``) and for ``geometry.constant``'s cache.

On the CPU the wrapper runs its plain twin (``mm2meters`` then
``bilateral_filter``); that is held against the JAX package's
``mm2meters`` followed by the Pallas bilateral filter in interpret mode
and by the jnp one, at ratios 1, 2 and 4 on frames that the ratio does
not divide. The kernel itself runs only on a card: see
test_torch_cuda.py and ``python3 chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from slambench_tpu.ops.pallas.bilateral import bilateral_filter_pallas  # noqa: E402
from slambench_tpu.ops.preprocess import bilateral_filter as j_bilateral  # noqa: E402
from slambench_tpu.ops.preprocess import mm2meters as j_mm2meters  # noqa: E402

from slambench_tpu_torch import geometry as G  # noqa: E402
from slambench_tpu_torch.ops.hopper import bilateral  # noqa: E402
from slambench_tpu_torch.ops.preprocess import make_gaussian  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion  # noqa: E402
from slambench_tpu_torch.tools.mosaic_probe import K1_TOL  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _frame(shape, seed):
    """Seeded millimetres with zero holes and values up to 65,535."""
    rng = np.random.default_rng(seed)
    mm = rng.integers(300, 5000, shape)
    mm[rng.random(shape) < 0.1] = 0
    mm[4:7, 5:12] = 0
    mm[rng.random(shape) < 0.02] = 65535
    return mm.astype(np.int32)


def _jax(mm, ratio):
    """(metres, Pallas-filtered, jnp-filtered) from the JAX package."""
    g = make_gaussian()
    fd = j_mm2meters(jnp.asarray(mm.astype(np.uint16)), ratio)
    return (np.asarray(fd),
            np.asarray(bilateral_filter_pallas(fd, g, interpret=True)),
            np.asarray(jax.jit(j_bilateral)(fd, jnp.asarray(g))))


@pytest.mark.parametrize("ratio", [1, 2, 4])
def test_fused_twin_matches_jax(ratio):
    """27x35 at ratio 2 gives 14x18, at 4 7x9; metres bit for bit, the
    filtered depth within K1_TOL of the Pallas kernel and of the jnp
    filter."""
    shape = (27, 35)
    mm = _frame(shape, 7 * ratio)
    fd, sd = bilateral.mm2m_bilateral_cuda(torch.from_numpy(mm), ratio,
                                           make_gaussian())
    want_fd, want_pallas, want_jnp = _jax(mm, ratio)
    assert fd.shape == sd.shape == tuple(-(-n // ratio) for n in shape)
    np.testing.assert_array_equal(fd.numpy().view(np.uint32),
                                  want_fd.view(np.uint32))
    np.testing.assert_allclose(sd.numpy(), want_pallas, equal_nan=True,
                               **K1_TOL)
    np.testing.assert_allclose(sd.numpy(), want_jnp, equal_nan=True,
                               **K1_TOL)


def test_preprocessing_phase_runs_the_fused_wrapper():
    """KFusion.preprocessing on a 640-wide frame at compute width 160
    (ratio 4): float_depth and scaled_depth0 equal the wrapper's, which
    counts no launch on the CPU."""
    mm = _frame((480, 640), 3)
    kf = KFusion((160, 120), (16,) * 3, (4.8,) * 3, (2.4,) * 3, (1, 1, 1),
                 (120.3, 120.0, 80.0, 60.0), device=CPU)
    bilateral.launches = bilateral.fused_launches = 0
    state = kf.preprocessing(kf.init_state(), kf.to_device(mm))
    fd, sd = bilateral.mm2m_bilateral_cuda(torch.from_numpy(mm), 4,
                                           make_gaussian())
    assert torch.equal(state.float_depth, fd)
    assert torch.equal(state.scaled_depth0, sd)
    assert state.float_depth.shape == (120, 160)
    assert bilateral.launches == 0 and bilateral.fused_launches == 0


@pytest.mark.parametrize("bad,ratio,kw,match", [
    (np.zeros((8, 8), np.float32), 2, {}, "int32"),
    (np.zeros((8, 8), np.int64), 2, {}, "int32"),
    (np.zeros((2, 8, 8), np.int32), 2, {}, "2-D"),
    (np.zeros((8, 8), np.int32), 0, {}, "ratio"),
    (np.zeros((8, 8), np.int32), 2.0, {}, "ratio"),
    (np.zeros((0, 8), np.int32), 1, {}, "empty"),
    (np.zeros((8, 8), np.int32), 1, {"r": 1}, "radius 2"),
])
def test_fused_wrapper_rejects_what_the_kernel_does_not_take(bad, ratio, kw,
                                                             match):
    with pytest.raises(ValueError, match=match):
        bilateral.mm2m_bilateral_cuda(torch.from_numpy(bad), ratio,
                                      make_gaussian(), **kw)


def test_constant_is_uploaded_once_per_values_dtype_device():
    a = G.constant((1000.0,), torch.float32, CPU)
    assert G.constant((1000.0,), torch.float32, CPU).data_ptr() \
        == a.data_ptr()
    assert G.constant((1000.0,), torch.float32, "cpu") is a
    other = [G.constant((1000.0,), torch.float64, CPU),
             G.constant((999.0,), torch.float32, CPU)]
    assert all(t.data_ptr() != a.data_ptr() for t in other)
    assert other[0].dtype == torch.float64 and float(other[1]) == 999.0
    # 0.0 and -0.0 compare equal; each keeps its own bits.
    neg = G.constant((-0.0,), torch.float32, CPU)
    pos = G.constant((0.0,), torch.float32, CPU)
    assert torch.signbit(neg).item() and not torch.signbit(pos).item()
