"""The port's frustum-culled block integrate (``ops/integrate.py``:
``block_visibility``, ``integrate_blocks``) and its dispatch
(``SLAMBENCH_INTEGRATE_BLOCKS`` in ``KFusion`` and ``ShardedKFusion``).

* ``block_visibility`` equals JAX's exactly (32^3; grids 8, 4x4, 4x4x2;
  poses that cull part of the volume, all of it, and none; whole volume
  and z-slabs).
* ``integrate_blocks`` against JAX's under JAX's contract
  (``tests/test_ops.py:161``: weights identical, tsdf within 1 LSB on
  < 0.1% of voxels), and against the port's monolithic ``integrate`` bit
  for bit, whole and on z-slabs.
* The environment forms as JAX's ``KFusion`` reads them
  (``tests/test_pipeline_e2e.py:138``), and the frame step with a block
  grid equal to the monolithic one, on one device and at 2 gloo ranks
  (4x2x2 blocks, 2 z-blocks a slab)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu import geometry as JG  # noqa: E402
from slambench_tpu.ops.integrate import (  # noqa: E402
    block_visibility as j_visibility, integrate_blocks as j_blocks,
)
from slambench_tpu.pipeline import KFusion as JKFusion  # noqa: E402

from slambench_tpu_torch.io import synthetic as TS  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.ops.integrate import (  # noqa: E402
    block_visibility, integrate, integrate_blocks,
)
from slambench_tpu_torch.parallel import distributed  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = (4.8, 4.8, 4.8)
GRIDS = [(8, 1, 1), (4, 4, 1), (4, 4, 2)]


def _rot_pose():
    th = 0.7
    rot = np.eye(4, dtype=np.float32)
    rot[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]], np.float32)
    rot[:3, 3] = [1.0, 2.0, 1.0]
    return rot


POSES = {"corner": np.asarray(JG.translation_pose([0.3, 0.3, 0.1])),
         "outside": np.asarray(JG.translation_pose([2.4, 2.4, 6.0])),
         "rotated": _rot_pose()}


@pytest.fixture(scope="module")
def case():
    """tests/test_ops.py:161's inputs at 32^3: random tsdf and weights,
    a random depth with a hole, a 32x24 camera."""
    rng = np.random.default_rng(3)
    tsdf = rng.integers(-32766, 32767, (32,) * 3).astype(np.int16)
    weight = rng.integers(0, 100, (32,) * 3).astype(np.int8)
    depth = (rng.random((24, 32)) * 4).astype(np.float32)
    depth[5:9, 5:9] = 0.0
    k = np.array([30.0, 30.0, 16.0, 12.0], np.float32)
    K = np.asarray(JG.get_camera_matrix(jnp.asarray(k)))
    inv = {n: np.asarray(JG.rigid_inverse(jnp.asarray(p)))
           for n, p in POSES.items()}
    return tsdf, weight, depth, K, inv


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("slab", [None, (16, 32)], ids=["whole", "slab"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_block_visibility_equals_jax(case, grid, slab):
    _, _, depth, K, inv = case
    nz, ny, nx = grid
    z = {} if slab is None else dict(z0_world=slab[0] * 0.15,
                                     z1_world=slab[1] * 0.15)
    seen = {}
    for name, m in inv.items():
        want = np.asarray(j_visibility(nz, ny, DIM, jnp.asarray(m),
                                       jnp.asarray(K), jnp.asarray(depth),
                                       0.1, n_x=nx, **z))
        got = block_visibility(nz, ny, DIM, _t(m), _t(K), _t(depth), 0.1,
                               n_x=nx, **z).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
        seen[name] = int(got.sum())
    assert seen["outside"] == 0
    # Some pose culls part of the blocks.
    assert any(0 < v < nz * ny * nx for v in seen.values()), seen


@pytest.mark.parametrize("grid", GRIDS + [(8, 8, 2)],
                         ids=lambda g: "x".join(map(str, g)))
def test_integrate_blocks_matches_jax_and_monolithic(case, grid):
    tsdf, weight, depth, K, inv = case
    nz, ny, nx = grid
    for name, m in inv.items():
        args = (_t(depth), _t(m), _t(K), 0.1, 100.0, DIM)
        t1, w1 = integrate(_t(tsdf), _t(weight), *args)
        t2, w2 = integrate_blocks(_t(tsdf), _t(weight), *args, n_z=nz,
                                  n_y=ny, n_x=nx)
        assert torch.equal(t1, t2) and torch.equal(w1, w2), name
        tj, wj = map(np.asarray, j_blocks(
            jnp.asarray(tsdf), jnp.asarray(weight), jnp.asarray(depth),
            jnp.asarray(m), jnp.asarray(K), 0.1, 100.0, DIM, n_z=nz, n_y=ny,
            n_x=nx))
        np.testing.assert_array_equal(w2.numpy(), wj, err_msg=name)
        d = np.abs(t2.numpy().astype(np.int32) - tj.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, name
        if name == "outside":
            assert torch.equal(t2, _t(tsdf))
        else:
            assert not torch.equal(w2, _t(weight))


@pytest.mark.parametrize("z0", [0, 8, 16])
def test_integrate_blocks_on_a_slab_equals_whole_volume(case, z0):
    """A 16-plane slab (z_offset / z_total) with 2x4x2 blocks: the whole
    volume's planes bit for bit."""
    tsdf, weight, depth, K, inv = case
    args = (_t(depth), _t(inv["rotated"]), _t(K), 0.1, 100.0, DIM)
    whole = integrate(_t(tsdf), _t(weight), *args)
    z = slice(z0, z0 + 16)
    part = integrate_blocks(_t(tsdf[z]), _t(weight[z]), *args, n_z=2,
                            n_y=4, n_x=2, z_offset=z0, z_total=32)
    assert torch.equal(part[0], whole[0][z])
    assert torch.equal(part[1], whole[1][z])


def test_integrate_blocks_refuses_a_grid_that_does_not_divide(case):
    tsdf, weight, depth, K, inv = case
    with pytest.raises(ValueError, match="not divisible"):
        integrate_blocks(_t(tsdf), _t(weight), _t(depth), _t(inv["corner"]),
                         _t(K), 0.1, n_z=3)
    with pytest.raises(ValueError, match="not divisible"):
        j_blocks(jnp.asarray(tsdf), jnp.asarray(weight), jnp.asarray(depth),
                 jnp.asarray(inv["corner"]), jnp.asarray(K), 0.1, n_z=3)


ARGS = ((16, 12), (16,) * 3, (2.0,) * 3, (1, 1, 0), (2, 2),
        (30.0, 30.0, 8.0, 6.0))


@pytest.mark.parametrize("value,want", [
    ("8", (8, 1, 1)), ("8x4", (8, 4, 1)), ("8x4x2", (8, 4, 2)),
    ("0", (1, 1, 1)), ("auto", (1, 1, 1)), ("3x1x1", (1, 1, 1))])
def test_kfusion_env_forms_as_jax(monkeypatch, value, want):
    """JAX's forms (tests/test_pipeline_e2e.py:138); "auto" is 1x1x1
    off a TPU in both; a grid that does not divide the volume is 1x1x1."""
    monkeypatch.setenv("SLAMBENCH_INTEGRATE_BLOCKS", value)
    assert KFusion(*ARGS, device=CPU).integrate_block_grid == want
    assert JKFusion(*ARGS).integrate_block_grid == want


@pytest.mark.parametrize("value", ["8x4x2x1", "x", "8xa", "0x2"])
def test_kfusion_malformed_env_raises(monkeypatch, value):
    monkeypatch.setenv("SLAMBENCH_INTEGRATE_BLOCKS", value)
    with pytest.raises(ValueError, match="INTEGRATE_BLOCKS"):
        KFusion(*ARGS, device=CPU)
    if value == "8x4x2x1":                  # JAX's own case
        with pytest.raises(ValueError, match="INTEGRATE_BLOCKS"):
            JKFusion(*ARGS)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("blocks")
    man = TS.generate_dataset(str(tmp), CPU, n_frames=6,
                              image_size=(160, 120), dim=DIM, amp=0.15,
                              period=60)
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    args = [list(man["image_size"]), [64] * 3, list(man["dim"]), init,
            [3, 2, 2], list(man["camera"])]
    return man, args, str(tmp)


def test_frame_step_with_blocks_equals_monolithic(clip, monkeypatch):
    """Six frames of the 64^3 clip through ``KFusion.process_frame`` with
    8x8x2 blocks: every frame's pose and the final volume bit for bit
    the monolithic route's."""
    man, args, _ = clip
    runs = {}
    for value in ("0", "8x8x2"):
        monkeypatch.setenv("SLAMBENCH_INTEGRATE_BLOCKS", value)
        kf = KFusion(*args, device=CPU)
        rd = RawDepthReader(man["raw"])
        s, poses = kf.init_state(), []
        for f in range(6):
            s = kf.process_frame(s, rd.read_next_depth_frame(), f)
            poses.append(s.pose)
        runs[value] = (torch.stack(poses), s.tsdf, s.weight, s.mip)
    assert kf.integrate_block_grid == (8, 8, 2)
    for a, b in zip(runs["0"], runs["8x8x2"]):
        assert torch.equal(a, b)
    assert (runs["0"][2] > 0).any()


WORKER = r'''
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from slambench_tpu_torch.io.readers import RawDepthReader
from slambench_tpu_torch.parallel import distributed
from slambench_tpu_torch.parallel.step import ShardedKFusion

job = json.loads(sys.argv[1])
mesh = distributed.initialize(0, "cpu")
out = {}
for value in ("0", "4x2x2"):
    os.environ["SLAMBENCH_INTEGRATE_BLOCKS"] = value
    kf = ShardedKFusion(*job["args"], mesh=mesh)
    rd = RawDepthReader(job["raw"])
    s, pos = kf.init_state(), []
    for f in range(job["frames"]):
        s = kf.process_frame(s, rd.read_next_depth_frame(), f)
        pos.append(s.pose.numpy())
    full = kf.full_state(s)
    out[f"pos_{value}"] = np.stack(pos)
    out[f"tsdf_{value}"] = full.tsdf.numpy()
    out[f"weight_{value}"] = full.weight.numpy()
    out[f"grid_{value}"] = np.asarray(kf.integrate_block_grid)
if mesh.rank == 0:
    np.savez(job["out"], **out)
mesh.close()
'''


def test_sharded_step_with_blocks_equals_monolithic(clip):
    """``ShardedKFusion`` at 2 gloo ranks with 4x2x2 blocks (2 z-blocks in
    each 32-plane slab): after 6 frames the same poses and volume, bit
    for bit, as without blocks."""
    man, args, tmp = clip
    out = os.path.join(tmp, "ranks.npz")
    job = {"args": args, "raw": man["raw"], "frames": 6, "out": out}
    for rc, _, err in distributed.launch(
            2, ["-c", WORKER, json.dumps(job)], cwd=REPO, timeout=400):
        assert rc == 0, err[-3000:]
    got = dict(np.load(out))
    assert list(got["grid_4x2x2"]) == [4, 2, 2]
    for key in ("pos", "tsdf", "weight"):
        np.testing.assert_array_equal(got[f"{key}_0"], got[f"{key}_4x2x2"])
    assert (got["weight_0"] > 0).any()
