"""Port parity for the oracle raycast (``slambench_tpu_torch/ops/
raycast.py``: ``masked_march``, ``raycast``, ``raycast_maps``, the
``jnp`` backend): the three cases of test_raycast.py, the oracle maps
against the JAX package's on the sphere, the port's own fast-vs-oracle
gate, and one steady-state frame with ``backend="jnp"`` from a state
shared with the JAX package's ``jnp`` tier.

Spread measured on the CPU (torch 2.13 vs jax 0.9), sphere at 32^3:
the same hit mask, max vertex difference 2.4e-7 m, min normal dot
0.9999998."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu import geometry as JG  # noqa: E402
from slambench_tpu.ops.raycast import raycast_maps as j_raycast_maps  # noqa: E402
from slambench_tpu.pipeline import KFusion as JKFusion  # noqa: E402
from slambench_tpu.pipeline import KFusionState as JState  # noqa: E402

from slambench_tpu_torch import convert  # noqa: E402
from slambench_tpu_torch.io import synthetic as TS  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.ops.raycast import raycast, raycast_maps  # noqa: E402
from slambench_tpu_torch.ops.raycast_fast import (  # noqa: E402
    make_min_mip, raycast_fast_maps,
)
from slambench_tpu_torch.pipeline import KFusion  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
DIM = (2.0, 2.0, 2.0)
K_SPHERE = (60.0, 60.0, 16.0, 12.0)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _sphere_volume(res=32, dim=2.0, center=(1.0, 1.0, 1.4), radius=0.3,
                   mu=0.2):
    c = np.linspace(0.5 * dim / res, dim - 0.5 * dim / res, res)
    Z, Y, X = np.meshgrid(c, c, c, indexing="ij")
    d = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2
                + (Z - center[2]) ** 2) - radius
    sdf = np.clip(d / mu, -1.0, 1.0).astype(np.float32)
    return np.trunc(sdf * 32766.0).astype(np.int16)


def _view(k=K_SPHERE):
    return np.asarray(JG.mat4mul(JG.translation_pose([1.0, 1.0, 0.2]),
                                 JG.get_inverse_camera_matrix(
                                     jnp.array(k, jnp.float32))))


def _maps(tsdf, step=2.0 / 32):
    return [a.numpy() for a in raycast_maps(
        T(tsdf), DIM, T(_view()), (24, 32), near_plane=0.1, far_plane=4.0,
        step=step, large_step=0.15)]


def test_raycast_hits_sphere_at_analytic_distance():
    vertex, normal = _maps(_sphere_volume())
    # Central ray from (1, 1, 0.2) along +z meets the front pole at z = 1.1.
    assert abs(vertex[2, 12, 16] - 1.1) < 0.02, vertex[2, 12, 16]
    assert normal[2, 12, 16] < -0.9, normal[:, 12, 16]


def test_raycast_miss_marks_invalid():
    vertex, normal = _maps(_sphere_volume())
    assert normal[0, 0, 0] == -2.0
    np.testing.assert_allclose(vertex[:, 0, 0], 0.0)


def test_raycast_from_inside_surface_returns_no_hit():
    """Rays that start where the TSDF is <= 0 give no hit
    (reference: cpp/kernels.cpp:708)."""
    tsdf = _sphere_volume(center=(1.0, 1.0, 0.25), radius=0.4)
    _, t_hit = raycast(T(tsdf), DIM, T(_view((60.0, 60.0, 8.0, 8.0))),
                       (8, 8), 0.01, 4.0, 2.0 / 32, 0.15)
    assert float(t_hit[4, 4]) == 0.0


def test_raycast_maps_matches_jax_on_the_sphere():
    """The same hit mask, vertices within 1e-4 m on the hits, normal dot
    > 0.999 there."""
    tsdf = _sphere_volume()
    vt, nt = _maps(tsdf)
    vj, nj = map(np.asarray, j_raycast_maps(
        jnp.asarray(tsdf), DIM, jnp.asarray(_view()), (24, 32),
        near_plane=0.1, far_plane=4.0, step=2.0 / 32, large_step=0.15))
    ht, hj = nt[0] != -2, nj[0] != -2
    np.testing.assert_array_equal(ht, hj)
    assert ht.sum() > 50
    np.testing.assert_allclose(vt[:, ht], vj[:, ht], atol=1e-4)
    np.testing.assert_array_equal(vt[:, ~ht], 0.0)
    assert (np.sum(nt[:, ht] * nj[:, ht], axis=0) > 0.999).all()


def test_fast_raycast_matches_oracle_in_the_port():
    """ROADMAP queue 1 item 7's gate, both marches the port's, on the
    64^3 sphere: at most 2 oracle hits lost, p95 |dt| < 0.5 voxel, max
    < 2 voxels, normal dot > 0.99 on >= 95% of the common hits."""
    tsdf = _sphere_volume(res=64)
    voxel = 2.0 / 64
    args = (DIM, T(_view()), (24, 32), 0.1, 4.0, voxel, 0.15)
    vo, no = (a.numpy() for a in raycast_maps(T(tsdf), *args))
    vf, nf, _ = (a.numpy() for a in raycast_fast_maps(
        T(tsdf), make_min_mip(T(tsdf)), *args))
    ho, hf = no[0] != -2, nf[0] != -2
    assert (ho & ~hf).sum() <= 2
    m = ho & hf
    assert m.sum() > 50
    # Along a ray |dt| * |direction| is the distance between the hits.
    dv = np.linalg.norm(vf[:, m] - vo[:, m], axis=0)
    assert np.percentile(dv, 95) < 0.5 * voxel and dv.max() < 2 * voxel
    dots = np.sum(nf[:, m] * no[:, m], axis=0)
    assert (dots > 0.99).mean() >= 0.95


def test_steady_state_frame_matches_jax_jnp_tier(tmp_path):
    """Bootstrap frames 0-4 in the port with ``backend="jnp"``, hand the
    state to the JAX package, and run frame 5 in both ``jnp`` tiers.
    Gates of test_torch_pipeline.py's steady-state test: pose translation
    within 1e-4 m, the same tracked flag, < 2% of TSDF voxels differ and
    < 1e-4 of them by more than 2 LSB; the reference maps the oracle
    raycast writes (hit masks agree on >= 99.9% of pixels, vertices
    within 1e-3 m on common hits) and ``prev_t_hit`` all zero."""
    man = TS.generate_dataset(str(tmp_path), CPU, n_frames=6,
                              image_size=(160, 120), dim=(4.8, 4.8, 4.8),
                              amp=0.12)
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    args = (man["image_size"], (64,) * 3, man["dim"], init, (10, 5, 4),
            man["camera"])
    rd = RawDepthReader(man["raw"])
    frames = [np.ascontiguousarray(rd.read_next_depth_frame())
              for _ in range(6)]
    kf = KFusion(*args, backend="jnp", device=CPU)
    state = kf.init_state()
    for f in range(5):
        state = kf.process_frame(state, frames[f], f, integration_rate=1)
    assert bool(state.tracked)
    shared = convert.state_to_numpy(state)

    gates = dict(tracking_on=True, integrate_frame=True,
                 force_integrate=False, raycast_on=True)
    js = JKFusion(*args, backend="jnp").compute_frame(
        JState(**{k: jnp.asarray(v) for k, v in shared.items()}),
        jnp.asarray(frames[5]), **gates)
    ts = kf.compute_frame(convert.state_from_numpy(shared, CPU),
                          kf.to_device(frames[5]), **gates)

    np.testing.assert_allclose(ts.pose[:3, 3].numpy(),
                               np.asarray(js.pose[:3, 3]), atol=1e-4)
    assert bool(ts.tracked) == bool(js.tracked) is True
    d = np.abs(ts.tsdf.numpy().astype(np.int32)
               - np.asarray(js.tsdf, np.int32))
    assert (d > 0).mean() < 0.02, f"{(d > 0).mean():.4f} voxels differ"
    assert (d > 2).mean() < 1e-4, f"{(d > 2).sum()} voxels beyond 2 LSB"
    np.testing.assert_array_equal(ts.weight.numpy(), np.asarray(js.weight))
    ht = ts.ref_normal[0].numpy() != -2
    hj = np.asarray(js.ref_normal[0]) != -2
    assert (ht == hj).mean() >= 0.999 and ht.mean() > 0.3
    m = ht & hj
    np.testing.assert_allclose(ts.ref_vertex.numpy()[:, m],
                               np.asarray(js.ref_vertex)[:, m], atol=1e-3)
    assert not ts.prev_t_hit.any() and not np.asarray(js.prev_t_hit).any()
