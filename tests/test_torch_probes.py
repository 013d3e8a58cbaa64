"""The cores of ``tools/slice_probe.py`` and ``tools/probe_r3.py``
against JAX on the CPU (numpy inputs from a seed), and both tools' runs
at small sizes with their asserted equalities. Tolerances: the gathers
exact; the slab loop at JAX's integrate tolerance (weights equal, TSDF
within 1 LSB: ``tests/test_torch_ops.py::test_integrate_matches_jax``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from slambench_tpu import geometry as JG  # noqa: E402
from slambench_tpu.ops.integrate import integrate as j_integrate  # noqa: E402

from slambench_tpu_torch.tools import probe_r3, slice_probe  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("s", [1, 2, 4])
def test_slice_gather_matches_lax_gather(s):
    rng = np.random.default_rng(11)
    table = rng.integers(-32766, 32766, 4096).astype(np.int16)
    idx = rng.integers(0, table.size - s + 1, (30, 7)).astype(np.int32)
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(idx.ndim,), collapsed_slice_dims=(),
        start_index_map=(0,))
    want = np.asarray(jax.lax.gather(
        jnp.asarray(table), jnp.asarray(idx)[..., None], dn,
        slice_sizes=(s,),
        mode=jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS))
    got = slice_probe.slice_gather(T(table), T(idx).long(), s).numpy()
    assert got.shape == (30, 7, s)
    np.testing.assert_array_equal(got, want)


def test_slab_loop_matches_jax_integrate_per_slab():
    """One slab hidden: each visible slab equals JAX's ``integrate`` of
    that slab (``z_offset`` / ``z_total``), the hidden one is
    unchanged."""
    rng = np.random.default_rng(5)
    V, S = 16, 4
    zs = V // S
    dim = (2.0, 2.0, 2.0)
    tsdf = rng.integers(-32766, 32767, (V,) * 3).astype(np.int16)
    weight = rng.integers(0, 100, (V,) * 3).astype(np.int8)
    depth = (rng.random((24, 32)) * 1.5 + 0.5).astype(np.float32)
    K = np.asarray(JG.get_camera_matrix(
        jnp.asarray([30.0, 30.0, 16.0, 12.0], jnp.float32)))
    inv = np.asarray(JG.rigid_inverse(JG.translation_pose([1.0, 1.0, -0.2])))
    visible = [True, False, True, True]
    gt, gw = probe_r3.integrate_slabs(T(tsdf), T(weight), T(depth), T(inv),
                                      T(K), 0.1, 100.0, dim, visible)
    gt, gw = gt.numpy(), gw.numpy()
    fused = 0
    for i, vis in enumerate(visible):
        z = slice(i * zs, (i + 1) * zs)
        if not vis:
            np.testing.assert_array_equal(gt[z], tsdf[z])
            np.testing.assert_array_equal(gw[z], weight[z])
            continue
        jt, jw = map(np.asarray, j_integrate(
            jnp.asarray(tsdf[z]), jnp.asarray(weight[z]), jnp.asarray(depth),
            jnp.asarray(inv), jnp.asarray(K), 0.1, 100.0, dim,
            z_offset=i * zs, z_total=V))
        np.testing.assert_array_equal(gw[z], jw)
        assert np.abs(gt[z].astype(np.int32) - jt.astype(np.int32)).max() \
            <= 1
        fused += int((jw != weight[z]).sum())
    assert fused > 50                         # the frame really fused


def test_ref_gathers_match_jax():
    rng = np.random.default_rng(3)
    npix = 12 * 16
    idx = rng.integers(0, npix, (12, 16)).astype(np.int32)
    t6 = rng.random((6, npix)).astype(np.float32)
    t8 = rng.random((npix, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        probe_r3.ref_rowgather_8(T(idx).long(), T(t8)).numpy(),
        np.asarray(jnp.asarray(t8).at[jnp.asarray(idx), :].get(
            mode="promise_in_bounds")))
    np.testing.assert_array_equal(
        probe_r3.ref_gather_6(T(idx).long(), T(t6)).numpy(),
        np.asarray(jnp.asarray(t6).at[:, jnp.asarray(idx)].get(
            mode="promise_in_bounds")))


def test_lane_gather_matches_take_along_axis():
    rng = np.random.default_rng(4)
    tbl = rng.random((64, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (64, 128)).astype(np.int64)
    np.testing.assert_array_equal(
        probe_r3.lane_gather(T(tbl), T(idx)).numpy(),
        np.asarray(jnp.take_along_axis(jnp.asarray(tbl), jnp.asarray(idx),
                                       axis=-1)))


def test_slice_probe_run_on_cpu():
    out = slice_probe.run(CPU, side=16)
    assert [v["equal"] for v in out["variants"].values()] == [True] * 8
    assert all(v["ms"] is None for v in out["variants"].values())
    assert out["base_indices"] == 600 * 128


def test_probe_r3_run_on_cpu():
    out = probe_r3.run(CPU, volume=16, slabs=8, reps=1)
    assert out["slabs_equal_integrate"] and out["ref_fetch_equal"] \
        and out["lane_equal_flat"]
    keys = ["integrate_monolithic", "integrate_slabs_8of8",
            "integrate_slabs_4of8", "integrate_slabs_1of8",
            "ref_gather_6xHW", "ref_rowgather_HWx8", "taa_lane_2M",
            "gather_flat_2M",
            *(f"integrate_blocks_{z}x{y}x{x}"
              for z, y, x in probe_r3.BLOCK_GRIDS)]
    assert all(k in out and out[k] is None for k in keys)
    assert out["rows"]["integrate_slabs_1of8"]["route"].startswith("eager")
    vis, total = out["visible_blocks"]["integrate_blocks_8x8x2"]
    assert 0 < vis < total == 128
