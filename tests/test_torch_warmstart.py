"""Port parity for the raycast's temporal warm start
(``SLAMBENCH_WARM_START=1``): ``warm_start_bound`` against the JAX
package's, the min-mip march with and without ``t_init``, and one
steady frame's raycast from a state shared with JAX's ``KFusion``, held
to test_raycast_fast.py's fast-vs-oracle gates (<= 2 hit mismatches,
p95 |dv| < 0.5 voxel, max < 2 voxels)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu import geometry as JG  # noqa: E402
from slambench_tpu.ops.raycast_fast import (  # noqa: E402
    warm_start_bound as j_bound,
)
from slambench_tpu.pipeline import KFusion as JKFusion  # noqa: E402
from slambench_tpu.pipeline import KFusionState as JState  # noqa: E402

from slambench_tpu_torch import convert  # noqa: E402
from slambench_tpu_torch.io import synthetic as TS  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.ops.raycast_fast import (  # noqa: E402
    make_min_mip, raycast_fast_maps, warm_start_bound,
)
from slambench_tpu_torch.pipeline import KFusion  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _gates(vt, nt, vj, nj, voxel):
    """test_raycast_fast.py's gates on two [3, H, W] map pairs."""
    ht = nt[0] != -2
    hj = nj[0] != -2
    assert (ht ^ hj).sum() <= 2, f"{(ht ^ hj).sum()} hit mismatches"
    m = ht & hj
    assert m.sum() > 50
    dv = np.abs(vt[:, m] - vj[:, m]).max(axis=0)
    assert np.percentile(dv, 95) < 0.5 * voxel
    assert dv.max() < 2 * voxel
    return dv.max() / voxel


def _random_delta(rng, angle, trans):
    axis = rng.normal(size=3)
    xi = np.concatenate([rng.normal(size=3) * trans,
                         axis / np.linalg.norm(axis) * angle])
    return np.asarray(JG.se3_exp(jnp.asarray(xi, jnp.float32)))


@pytest.mark.parametrize("angle,trans", [(0.0, 0.0), (0.01, 0.02),
                                         (0.3, 0.5), (np.pi, 0.1)])
def test_warm_start_bound_matches_jax(angle, trans):
    """A seeded t map with misses (0) and NaN-free hits in 0.4-4 m; the
    bound equals JAX's within 1e-6 m."""
    rng = np.random.default_rng(11)
    t = rng.uniform(0.4, 4.0, (48, 64)).astype(np.float32)
    t[rng.random(t.shape) < 0.1] = 0.0
    delta = _random_delta(rng, angle, trans)
    want = np.asarray(j_bound(jnp.asarray(t), jnp.asarray(delta), 4.0,
                              0.075))
    got = warm_start_bound(T(t), T(delta), 4.0, 0.075).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[t == 0.0] == 0.0).all()


def test_warm_start_bound_rejects_ragged_shape():
    with pytest.raises(ValueError, match="60x80"):
        warm_start_bound(torch.ones(60, 80), torch.eye(4))


def _sphere_volume(res=64, dimv=2.0, center=(1.0, 1.0, 1.4), radius=0.3,
                   mu=0.2):
    c = np.linspace(0.5 * dimv / res, dimv - 0.5 * dimv / res, res)
    Z, Y, X = np.meshgrid(c, c, c, indexing="ij")
    d = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2
                + (Z - center[2]) ** 2) - radius
    return np.trunc(np.clip(d / mu, -1, 1) * 32766).astype(np.int16)


def test_t_init_keeps_the_sphere_hits():
    """The static sphere of test_raycast_fast.py: the march started at
    the bound of its own previous t map finds the same surface."""
    dim = (2.0, 2.0, 2.0)
    tsdf = T(_sphere_volume())
    mip = make_min_mip(tsdf)
    view = T(JG.mat4mul(JG.translation_pose([1.0, 1.0, 0.2]),
                        JG.get_inverse_camera_matrix(
                            jnp.array([60.0, 60.0, 16.0, 12.0]))))
    args = (dim, view, (24, 32), 0.1, 4.0, 2.0 / 64, 0.15)
    v0, n0, t0 = raycast_fast_maps(tsdf, mip, *args)
    t_init = warm_start_bound(t0, torch.eye(4), 4.0, 0.15)
    assert (t_init > 0).sum() > 50
    v1, n1, t1 = raycast_fast_maps(tsdf, mip, *args, t_init=t_init)
    _gates(v1.numpy(), n1.numpy(), v0.numpy(), n0.numpy(), 2.0 / 64)
    # A bound past every surface leaves nothing to hit.
    _, _, t_far = raycast_fast_maps(tsdf, mip, *args,
                                    t_init=torch.full_like(t0, 10.0))
    assert not bool((t_far > 0).any())


def test_warm_start_env_switch(monkeypatch):
    args = ((16, 8), (16,) * 3, (2.0,) * 3, (1, 1, 0), (2, 2),
            (30.0, 30.0, 8.0, 4.0))
    assert not KFusion(*args, device=CPU).warm_start
    monkeypatch.setenv("SLAMBENCH_WARM_START", "1")
    assert KFusion(*args, device=CPU).warm_start
    assert not KFusion(*args, backend="jnp", device=CPU).warm_start


def test_warm_started_frame_matches_jax(tmp_path, monkeypatch):
    """Frames 0-4 and frame 5's preprocessing, tracking and integration
    in the port with the warm start on; frame 5's raycast from that state
    in both packages, each starting at its own bound."""
    monkeypatch.setenv("SLAMBENCH_WARM_START", "1")
    man = TS.generate_dataset(str(tmp_path), CPU, n_frames=6,
                              image_size=(160, 120), dim=(4.8,) * 3,
                              amp=0.12)
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    args = (man["image_size"], (64,) * 3, man["dim"], init, (10, 5, 4),
            man["camera"])
    rd = RawDepthReader(man["raw"])
    kf = KFusion(*args, device=CPU)
    assert kf.warm_start
    state = kf.init_state()
    for f in range(5):
        state = kf.process_frame(state, rd.read_next_depth_frame(), f,
                                 integration_rate=1)
    assert bool(state.tracked) and bool((state.prev_t_hit > 0).any())
    state = kf.preprocessing(state, kf.to_device(rd.read_next_depth_frame()))
    state = kf.tracking(state)
    state = kf.integration(state, integrate_frame=True,
                           force_integrate=False)
    assert not torch.equal(state.pose, state.raycast_pose)
    shared = convert.state_to_numpy(state)

    jkf = JKFusion(*args, backend="fast")
    js = jkf.raycasting(JState(**{k: jnp.asarray(v)
                                  for k, v in shared.items()}))
    ts = kf.raycasting(convert.state_from_numpy(shared, CPU))
    _gates(ts.ref_vertex.numpy(), ts.ref_normal.numpy(),
           np.asarray(js.ref_vertex), np.asarray(js.ref_normal), 4.8 / 64)
    tt, tj = ts.prev_t_hit.numpy(), np.asarray(js.prev_t_hit)
    both = (tt > 0) & (tj > 0)
    assert np.percentile(np.abs(tt - tj)[both], 95) < 0.5 * 4.8 / 64
