"""Port parity for the render kernels (``slambench_tpu_torch/ops/
render.py``): the four cases of test_render.py, each against the JAX
package's ``ops/render.py`` uint8 for uint8, with inputs that reach the
edges (depth at and past the near and far planes, non-finite depth,
normal components of exactly +-1, INVALID and zero normals), and the
pipeline's render methods against the JAX pipeline's on a shared state.

Measured on the CPU (torch 2.13 vs jax 0.9): every image equal bit for
bit to the JAX functions, ``render_volume`` on both routes included."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu import geometry as JG  # noqa: E402
from slambench_tpu import params as JP  # noqa: E402
from slambench_tpu.ops import render as JR  # noqa: E402
from slambench_tpu.ops.raycast_fast import make_min_mip as j_min_mip  # noqa: E402
from slambench_tpu.pipeline import KFusion as JKFusion  # noqa: E402
from slambench_tpu.pipeline import KFusionState as JState  # noqa: E402

from slambench_tpu_torch import convert  # noqa: E402
from slambench_tpu_torch.io import synthetic as TS  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.ops import render as TR  # noqa: E402
from slambench_tpu_torch.ops.raycast_fast import make_min_mip as t_min_mip  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _same(got: torch.Tensor, want) -> np.ndarray:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _sphere_volume(res=64, dimv=2.0, center=(1.0, 1.0, 1.4), radius=0.3,
                   mu=0.2):
    c = np.linspace(0.5 * dimv / res, dimv - 0.5 * dimv / res, res)
    Z, Y, X = np.meshgrid(c, c, c, indexing="ij")
    d = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2
                + (Z - center[2]) ** 2) - radius
    return np.trunc(np.clip(d / mu, -1, 1) * 32766).astype(np.int16)


def test_render_depth_near_far_clamps():
    """test_render.py's palette contract, and every pixel equal to JAX
    on a ramp across both planes plus their neighbouring floats."""
    near, far = np.float32(0.4), np.float32(4.0)
    edges = [0.1, 2.0, 9.0, near, far, np.nextafter(near, 0),
             np.nextafter(near, 9), np.nextafter(far, 0),
             np.nextafter(far, 9), 0.0, -1.0, np.inf, np.nan]
    ramp = np.linspace(0.0, 5.0, 13 * 40 - len(edges), dtype=np.float32)
    depth = np.concatenate([np.asarray(edges, np.float32),
                            ramp]).reshape(13, 40)
    img = _same(TR.render_depth(T(depth)), JR.render_depth(
        jnp.asarray(depth)))
    assert (img[0, 0, :3] == 255).all()           # near -> white
    assert (img[0, 2, :3] == 0).all()             # far -> black
    mid = img[0, 1, :3]
    assert mid.max() > 0 and not (mid == mid[0]).all()
    assert (img[..., 3] == 0).all()


def test_render_track_code_palette():
    codes = np.array([[1, -1, -2, -3, -4, -5, 7, 0, -6]], np.int32)
    img = _same(TR.render_track(T(codes)), JR.render_track(
        jnp.asarray(codes)))
    expect = [(128, 128, 128), (0, 0, 0), (255, 0, 0), (0, 255, 0),
              (0, 0, 255), (255, 255, 0), (255, 128, 128)]
    for i, rgb in enumerate(expect):
        assert tuple(img[0, i, :3]) == rgb


def test_render_normal_invalid_black():
    """Unit axes (a +1 component gives 256.0, which saturates to 255),
    INVALID and zero normals, and random unit normals."""
    rng = np.random.default_rng(4)
    n = rng.normal(size=(3, 12, 16)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0)
    axes = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
            (0, 0, -1), (-2, 0, 0), (-2, 5, 5), (0, 0, 0), (0.6, 0.8, 0)]
    for i, a in enumerate(axes):
        n[:, 0, i] = a
    n[0, 6, :] = -2.0                               # a row of INVALID
    img = _same(TR.render_normal(T(n)), JR.render_normal(jnp.asarray(n)))
    assert tuple(img[0, 0, :3]) == (255, 128, 128)
    assert tuple(img[0, 4, :3]) == (128, 128, 255)
    assert (img[0, 6:8, :3] == 0).all() and (img[6, :, :3] == 0).all()


@pytest.mark.parametrize("route", ["oracle", "mip"])
def test_render_volume_fast_matches_oracle(route):
    """Each route equal to JAX's on test_render.py's 64^3 sphere, and
    test_render.py's gate between the port's two routes: no more than 2
    oracle hits lost, >= 50 common hits, 90th percentile of the shading
    difference <= 8 grey levels."""
    dim = (2.0, 2.0, 2.0)
    tsdf = _sphere_volume()
    view = np.asarray(JG.mat4mul(JG.translation_pose([1.0, 1.0, 0.2]),
                                 JG.get_inverse_camera_matrix(
                                     jnp.array([60.0, 60.0, 16.0, 12.0]))))
    args = ((24, 32), 0.1, 4.0, 2.0 / 64, 0.15)
    img_o = TR.render_volume(T(tsdf), dim, T(view), *args).numpy()
    img_f = TR.render_volume(T(tsdf), dim, T(view), *args,
                             mip=t_min_mip(T(tsdf))).numpy()
    if route == "oracle":
        want = JR.render_volume(jnp.asarray(tsdf), dim, jnp.asarray(view),
                                *args)
        _same(torch.from_numpy(img_o), want)
    else:
        jt = jnp.asarray(tsdf)
        want = JR.render_volume(jt, dim, jnp.asarray(view), *args,
                                mip=j_min_mip(jt))
        _same(torch.from_numpy(img_f), want)
    h_o = img_o[..., :3].max(axis=-1) > 0
    h_f = img_f[..., :3].max(axis=-1) > 0
    assert (h_o & ~h_f).sum() <= 2
    m = h_o & h_f
    assert m.sum() > 50
    diff = np.abs(img_o[m, :3].astype(int) - img_f[m, :3].astype(int))
    assert np.percentile(diff, 90) <= 8


@pytest.mark.parametrize("backend", ["jnp", "fast"])
def test_kfusion_render_methods_match_jax(tmp_path, backend):
    """The pipeline's three render methods (the CLI's rendering phase:
    twice the far plane, ``0.75 * mu``, the min-mip unless ``jnp``) on a
    state after 5 port frames at 80x60 / 32^3: equal to the JAX render
    functions called with the JAX pipeline's arguments, and within one
    grey level of the JAX pipeline's jitted methods. (XLA's fusion of the
    jitted mip route moves 3 of 19,200 bytes of the volume image by one
    grey level from the same functions run op by op.)"""
    man = TS.generate_dataset(str(tmp_path), CPU, n_frames=5,
                              image_size=(80, 60), dim=(4.8, 4.8, 4.8),
                              amp=0.12)
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    args = (man["image_size"], (32,) * 3, man["dim"], init, (4, 3, 2),
            man["camera"])
    kf = KFusion(*args, backend=backend, device=CPU)
    rd = RawDepthReader(man["raw"])
    state = kf.init_state()
    for f in range(5):
        state = kf.process_frame(state, rd.read_next_depth_frame(), f,
                                 integration_rate=1)
    shared = convert.state_to_numpy(state)
    jkf = JKFusion(*args, backend=backend)
    js = JState(**{k: jnp.asarray(v) for k, v in shared.items()})
    ts = convert.state_from_numpy(shared, CPU)
    _same(kf.render_depth_image(ts), JR.render_depth(js.float_depth))
    _same(kf.render_track_image(ts), JR.render_track(js.track_result))
    view = JG.mat4mul(js.pose, JG.get_inverse_camera_matrix(jkf._k))
    vol = _same(kf.render_volume_image(ts), JR.render_volume(
        js.tsdf, jkf.volume_dimensions, view, (jkf.H, jkf.W),
        JP.NEAR_PLANE, JP.FAR_PLANE * 2.0, jkf.step, 0.75 * jkf.mu,
        mip=None if backend == "jnp" else js.mip))
    assert (vol[..., :3].max(axis=-1) > 0).mean() > 0.1
    for got, want in ((kf.render_depth_image(ts),
                       jkf.render_depth_image(js)),
                      (kf.render_track_image(ts),
                       jkf.render_track_image(js)),
                      (torch.from_numpy(vol), jkf.render_volume_image(js))):
        d = np.abs(got.numpy().astype(int) - np.asarray(want, int))
        assert d.max() <= 1 and (d == 0).mean() >= 0.999


@pytest.mark.parametrize("fused", [False, True])
def test_cli_times_the_rendering_phase(tmp_path, fused):
    """The CLI's rendering column is > 0 on every frame in phased and
    ``--fused`` mode, and ``total >= computation + rendering``."""
    from slambench_tpu_torch.config import parse_args
    from slambench_tpu_torch.eval.check_pos import parse_benchmark_log
    from slambench_tpu_torch.frontend.benchmark import run
    man = TS.generate_dataset(str(tmp_path), CPU, n_frames=6,
                              image_size=(80, 60), dim=(4.8, 4.8, 4.8),
                              amp=0.12)
    log_path = str(tmp_path / "b.log")
    run(parse_args(["-i", man["raw"], "-o", log_path, "-v", "32",
                    "-s", "4.8", "-p", "0.34,0.5,0.24", "-c", "1", "-r", "1",
                    "-z", "2", "-y", "3,2,2", "-k", "60.15,60.0,40,30"]),
        CPU, fused=fused, quiet=True)
    log = parse_benchmark_log(log_path)
    assert len(log["frame"]) == 6 and (log["rendering"] > 0).all()
    assert (log["total"] >= log["computation"] + log["rendering"]).all()
    if fused:
        assert (log["preprocessing"] == 0).all()
