"""Port parity for the min-mip raycast: ``raycast_fast_maps`` in torch vs
the JAX package's on a volume integrated from synthetic frames, and vs
the JAX oracle march on the analytic sphere of test_raycast_fast.py, with
that file's fast-vs-oracle gates: <= 2 hit mismatches, p95 |dt| < 0.5
voxel, max < 2 voxels, normal dot > 0.99 on >= 95% of the common hits.

Spread measured on the CPU (torch 2.13 vs jax 0.9), integrated-frame
case: no hit mismatch, max vertex difference 7.0e-5 voxel, max |dt|
5.5e-6 m, min normal dot 0.9999998. The test holds that case to 1e-3
voxel, well inside the oracle gates."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu import geometry as JG  # noqa: E402
from slambench_tpu.ops.integrate import integrate as j_integrate  # noqa: E402
from slambench_tpu.ops.preprocess import mm2meters  # noqa: E402
from slambench_tpu.ops.raycast import raycast_maps  # noqa: E402
from slambench_tpu.ops.raycast_fast import make_min_mip as j_min_mip  # noqa: E402
from slambench_tpu.ops.raycast_fast import raycast_fast_maps as j_raycast  # noqa: E402
from slambench_tpu.volume import init_volume  # noqa: E402

from slambench_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticScene, orbit_trajectory, render_depth_frame,
)
from slambench_tpu_torch.ops.raycast_fast import make_min_mip as t_min_mip  # noqa: E402
from slambench_tpu_torch.ops.raycast_fast import raycast_fast_maps as t_raycast  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _gates(vt, nt, vj, nj, voxel, oracle=False):
    """test_raycast_fast.py's fast-vs-oracle gates; returns the spread.
    Against the oracle only lost hits count: nearest sampling may catch
    crossings the oracle's large steps jump over."""
    ht = nt[0] != -2
    hj = nj[0] != -2
    lost = (hj & ~ht) if oracle else (ht ^ hj)
    assert lost.sum() <= 2, f"{lost.sum()} hit mismatches"
    m = ht & hj
    assert m.sum() > 50
    dv = np.abs(vt[:, m] - vj[:, m]).max(axis=0)
    assert np.percentile(dv, 95) < 0.5 * voxel
    assert dv.max() < 2 * voxel
    dots = np.sum(nt[:, m] * nj[:, m], axis=0)
    assert (dots > 0.99).mean() >= 0.95
    return {"mismatch": int(lost.sum()), "max_dv_vox": dv.max() / voxel,
            "min_dot": dots.min()}


@pytest.fixture(scope="module")
def integrated_volume():
    """A 64^3 / 4.8 m TSDF fused from two synthetic 80x60 frames."""
    dim = (4.8, 4.8, 4.8)
    k = (60.15, 60.0, 40.0, 30.0)
    poses = orbit_trajectory(6, [0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8])
    tsdf, weight = init_volume((64, 64, 64))
    K = JG.get_camera_matrix(jnp.asarray(k, jnp.float32))
    for i in (0, 3):
        mm = render_depth_frame(SyntheticScene(dim=dim), poses[i], k,
                                (80, 60), CPU)
        depth = mm2meters(jnp.asarray(mm), 1)
        tsdf, weight = j_integrate(tsdf, weight, depth,
                                   JG.rigid_inverse(jnp.asarray(poses[i])),
                                   K, 0.1, 100.0, dim)
    return np.asarray(tsdf), dim, k, poses[5]


def test_raycast_integrated_frame_matches_jax(integrated_volume):
    tsdf, dim, k, pose = integrated_volume
    view = np.asarray(JG.mat4mul(jnp.asarray(pose),
                                 JG.get_inverse_camera_matrix(
                                     jnp.asarray(k, jnp.float32))))
    args = (dim, view, (60, 80), 0.4, 4.0, 4.8 / 64, 0.075)
    mip_j = j_min_mip(jnp.asarray(tsdf))
    vj, nj, tj = map(np.asarray, j_raycast(jnp.asarray(tsdf), mip_j, *args))
    mip_t = t_min_mip(T(tsdf))
    np.testing.assert_array_equal(mip_t.numpy(), np.asarray(mip_j))
    vt, nt, tt = (a.numpy() for a in t_raycast(T(tsdf), mip_t, dim, T(view),
                                               *args[2:]))
    spread = _gates(vt, nt, vj, nj, 4.8 / 64)
    assert spread["max_dv_vox"] < 1e-3, spread
    np.testing.assert_allclose(tt, tj, atol=1e-3 * 4.8 / 64)


def _sphere_volume(res=64, dimv=2.0, center=(1.0, 1.0, 1.4), radius=0.3,
                   mu=0.2):
    c = np.linspace(0.5 * dimv / res, dimv - 0.5 * dimv / res, res)
    Z, Y, X = np.meshgrid(c, c, c, indexing="ij")
    d = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2
                + (Z - center[2]) ** 2) - radius
    return np.trunc(np.clip(d / mu, -1, 1) * 32766).astype(np.int16)


def test_raycast_sphere_matches_jax_oracle():
    """The sphere of test_raycast_fast.py against the JAX oracle
    (reference-exact trilinear) march."""
    dim = (2.0, 2.0, 2.0)
    tsdf = _sphere_volume()
    view = np.asarray(JG.mat4mul(JG.translation_pose([1.0, 1.0, 0.2]),
                                 JG.get_inverse_camera_matrix(
                                     jnp.array([60.0, 60.0, 16.0, 12.0]))))
    args = (dim, view, (24, 32), 0.1, 4.0, 2.0 / 64, 0.15)
    vj, nj = map(np.asarray, raycast_maps(jnp.asarray(tsdf), *args))
    vt, nt, _ = (a.numpy() for a in t_raycast(
        T(tsdf), t_min_mip(T(tsdf)), dim, T(view), *args[2:]))
    _gates(vt, nt, vj, nj, 2.0 / 64, oracle=True)


def test_raycast_empty_volume_has_no_hits():
    tsdf = torch.full((32, 32, 32), 32766, dtype=torch.int16)
    view = T(JG.mat4mul(
        JG.translation_pose([1.0, 1.0, 0.2]),
        JG.get_inverse_camera_matrix(jnp.array([60.0, 60.0, 8.0, 8.0]))))
    v, n, t = t_raycast(tsdf, t_min_mip(tsdf), (2.0,) * 3, view, (16, 16),
                        0.1, 4.0, 2.0 / 32, 0.15)
    assert (n[0] == -2).all() and (v == 0).all() and (t == 0).all()
