"""The port's sharded step (``parallel/step.py``) on gloo ranks on the
CPU: the counterparts of the JAX package's ``tests/test_sharded.py``.

Ranks are subprocesses started once per module (``parallel/
distributed.launch``), one thread each; rank 0 writes what it measured to
an ``.npz`` the tests read. The comparisons are against the port's
single-device route, and, for the 8-rank raycast, against JAX's slab
raycast with each neighbour's adjacent planes as its halo (see
``test_slab_raycast_matches_single_device``)."""

import concurrent.futures
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from slambench_tpu_torch.io import synthetic as TS  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.ops.raycast_fast import (  # noqa: E402
    make_min_mip, raycast_fast_maps,
)
from slambench_tpu_torch import geometry as G  # noqa: E402
from slambench_tpu_torch.parallel import distributed  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 16

# One rank's jobs (argv[1]: JSON); rank 0 saves the results to job["out"].
WORKER = r'''
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from slambench_tpu_torch import geometry as G
from slambench_tpu_torch.io.readers import RawDepthReader
from slambench_tpu_torch.parallel import distributed
from slambench_tpu_torch.parallel.step import ShardedKFusion

job = json.loads(sys.argv[1])
mesh = distributed.initialize(0, "cpu")
out = {}
if "run" in job:
    r = job["run"]
    kf = ShardedKFusion(*r["args"], mesh=mesh)
    rd = RawDepthReader(r["raw"])
    frames = [rd.read_next_depth_frame() for _ in range(r["frames"])]
    s = kf.init_state()
    pos = []
    for f, d in enumerate(frames):
        s = kf.process_frame(s, d, f)
        pos.append(s.pose[:3, 3].numpy())
        if f == 0:
            out["float_depth0"] = s.float_depth.numpy()
            out["scaled_depth0"] = s.scaled_depth0.numpy()
    out["pos"] = np.stack(pos)
    out["tracked"] = bool(s.tracked)
    # The slab raycast of the final volume from the final pose.
    view = G.mat4mul(s.pose, G.get_inverse_camera_matrix(kf._k))
    v, n = kf._slab_raycast(s.tsdf, view)
    out["clip_vertex"], out["clip_normal"] = v.numpy(), n.numpy()
    out["clip_tsdf"] = kf.full_state(s).tsdf.numpy()
    out["clip_pose"] = s.pose.numpy()
if "scan" in job:
    r = job["scan"]
    rd = RawDepthReader(r["raw"])
    frames = [rd.read_next_depth_frame() for _ in range(12)]
    def boot(kf):
        s = kf.init_state()
        for f in range(5):
            s = kf.process_frame(s, frames[f], f, integration_rate=1)
        return s
    kf1 = ShardedKFusion(*r["args"], mesh=mesh)
    s1 = boot(kf1)
    pos1 = []
    for f in range(5, 12):
        s1 = kf1.process_frame(s1, frames[f], f, integration_rate=1)
        pos1.append(s1.pose[:3, 3].numpy())
    kf2 = ShardedKFusion(*r["args"], mesh=mesh)
    s2, outs = kf2.compute_frames_scan(boot(kf2), np.stack(frames[5:12]))
    out["scan_pos_frame"] = np.stack(pos1)
    out["scan_pos_scan"] = outs["pos"].numpy()
    out["scan_tsdf_frame"] = kf1.full_state(s1).tsdf.numpy()
    out["scan_tsdf_scan"] = kf2.full_state(s2).tsdf.numpy()
    out["scan_slab_shape"] = np.asarray(s2.tsdf.shape)
if "ray" in job:
    r = job["ray"]
    tsdf = torch.from_numpy(np.load(r["tsdf"]))
    kf = ShardedKFusion((32, 24), (64, 64, 64), (2.0,) * 3,
                        [1.0, 1.0, 0.2], (3, 2, 2),
                        [60.0, 60.0, 16.0, 12.0], mu=0.2, mesh=mesh)
    pose = G.translation_pose([1.0, 1.0, 0.2], torch.device("cpu"))
    view = G.mat4mul(pose, G.get_inverse_camera_matrix(kf._k))
    v, n = kf._slab_raycast(tsdf[kf.z0:kf.z0 + kf.slab_z].contiguous(),
                            view)
    out["ray_vertex"], out["ray_normal"] = v.numpy(), n.numpy()
if mesh.rank == 0:
    np.savez(job["out"], **out)
mesh.close()
'''


def _launch(n, job):
    outs = distributed.launch(n, ["-c", WORKER, json.dumps(job)], cwd=REPO,
                              timeout=400)
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return dict(np.load(job["out"]))


def _sphere():
    """JAX's slab-raycast test volume: a 0.3 m sphere in a 2 m, 64^3 box."""
    res, dimv = 64, 2.0
    c = np.linspace(0.5 * dimv / res, dimv - 0.5 * dimv / res, res)
    Z, Y, X = np.meshgrid(c, c, c, indexing="ij")
    d = np.sqrt((X - 1.0) ** 2 + (Y - 1.0) ** 2 + (Z - 1.4) ** 2) - 0.3
    return np.trunc(np.clip(d / 0.2, -1, 1).astype(np.float32)
                    * 32766).astype(np.int16)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The clip (16 frames, 160x120, amp 0.15), the single-device fast
    route over it, and the rank jobs, started together: the trajectory
    at 1, 2 and 4 ranks (4 also the scan), the sphere raycast at 4 and
    8 ranks."""
    tmp = tmp_path_factory.mktemp("sharded")
    man = TS.generate_dataset(str(tmp), CPU, n_frames=FRAMES,
                              image_size=(160, 120), dim=(4.8, 4.8, 4.8),
                              amp=0.15, period=60)
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    args = [list(man["image_size"]), [64] * 3, list(man["dim"]), init,
            [10, 5, 4], list(man["camera"])]
    sphere = str(tmp / "sphere.npy")
    np.save(sphere, _sphere())
    jobs = {1: {"run": {"args": args, "raw": man["raw"], "frames": FRAMES}},
            2: {"run": {"args": args, "raw": man["raw"], "frames": FRAMES}},
            4: {"run": {"args": args, "raw": man["raw"], "frames": FRAMES},
                "scan": {"args": args, "raw": man["raw"]},
                "ray": {"tsdf": sphere}},
            8: {"ray": {"tsdf": sphere}}}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futs = {n: pool.submit(_launch, n, dict(job, out=str(tmp / f"{n}.npz")))
                for n, job in jobs.items()}
        # The single-device route meanwhile, in this process.
        kf = KFusion(*args, backend="fast", device=CPU)
        rd = RawDepthReader(man["raw"])
        state = kf.init_state()
        pos = []
        for f in range(FRAMES):
            state = kf.process_frame(state, rd.read_next_depth_frame(), f)
            pos.append(state.pose[:3, 3].numpy())
        got = {n: f.result() for n, f in futs.items()}
    return man, args, np.stack(pos), bool(state.tracked), got


def test_shard_count_invariance(runs):
    """The 16-frame clip at 1, 2 and 4 ranks and on the single-device
    fast route (JAX's test_shard_count_invariance): every run tracked,
    ATE mean < 0.06 m, and each trajectory within voxel/4 of the 1-rank
    one."""
    man, _, pos_fast, tracked_fast, got = runs
    gt = man["poses"][:FRAMES, :3, 3]
    assert tracked_fast and all(bool(got[n]["tracked"]) for n in (1, 2, 4))
    for pos in (pos_fast, got[1]["pos"], got[2]["pos"], got[4]["pos"]):
        assert np.linalg.norm(pos - gt, axis=1).mean() < 0.06
    voxel = man["dim"][2] / 64
    for name, pos in (("2 ranks", got[2]["pos"]), ("4 ranks", got[4]["pos"]),
                      ("fast", pos_fast)):
        d = np.linalg.norm(pos - got[1]["pos"], axis=1)
        assert d.max() < voxel / 4, f"{name}: divergence {d.max():.4f} m"


def test_sharded_preprocessing_matches_replicated(runs):
    """K1's plain twin on 4 bands of 30 rows with the uint-wrap aprons,
    gathered, equals the replicated filter exactly (frame 0)."""
    man, args, _, _, got = runs
    kf = KFusion(*args, device=CPU)
    d = RawDepthReader(man["raw"]).read_next_depth_frame()
    ref = kf.preprocessing(kf.init_state(), kf.to_device(d))
    np.testing.assert_array_equal(got[4]["float_depth0"],
                                  ref.float_depth.numpy())
    np.testing.assert_array_equal(got[4]["scaled_depth0"],
                                  ref.scaled_depth0.numpy())


def test_sharded_scan_matches_per_frame(runs):
    """compute_frames_scan at 4 ranks (a loop of scan_step on the CPU)
    against per-frame dispatch from the same 5-frame boot: JAX's
    contract (positions within 1e-4 m, < 2% of voxels differ, < 1e-4 by
    more than 2 LSB); the volume stays in slabs."""
    _, _, _, _, got = runs
    g = got[4]
    np.testing.assert_allclose(g["scan_pos_scan"], g["scan_pos_frame"],
                               atol=1e-4)
    d = np.abs(g["scan_tsdf_scan"].astype(np.int32)
               - g["scan_tsdf_frame"].astype(np.int32))
    assert (d > 0).mean() < 0.02, f"{(d > 0).mean():.4f} voxels differ"
    assert (d > 2).mean() < 1e-4, f"{(d > 2).sum()} voxels beyond 2 LSB"
    assert tuple(g["scan_slab_shape"]) == (16, 64, 64)


def _jax_slab_raycast(tsdf, n_shards, image=(32, 24), dim=(2.0,) * 3,
                      camera=(60.0, 60.0, 16.0, 12.0), mu=0.2,
                      pose=None):
    """JAX's slab raycast of a volume (by default the sphere's case)
    with the halo each slab's neighbours hold next to it (their last /
    first planes), as the step's docstring describes it; the rest is
    JAX's code."""
    from slambench_tpu import geometry as JG
    from slambench_tpu.parallel.mesh import make_mesh
    from slambench_tpu.parallel.step import ShardedKFusion as JSharded

    class Neighbours(JSharded):
        def _halo_exchange(self, slab):
            h, n = self.halo, self.n_shards
            down = [(i, (i + 1) % n) for i in range(n)]
            up = [(i, (i - 1) % n) for i in range(n)]
            top = jax.lax.ppermute(slab[-h:], self.axis, down)
            bottom = jax.lax.ppermute(slab[:h], self.axis, up)
            return jnp.concatenate([top, slab, bottom], axis=0)

    mesh = make_mesh(n_shards)
    sz, sy, sx = tsdf.shape
    kf = Neighbours(tuple(image), (sx, sy, sz), tuple(dim), [0.0, 0.0, 0.0],
                    (1,), list(camera), mu=mu, mesh=mesh)
    pose = JG.translation_pose([1.0, 1.0, 0.2]) if pose is None \
        else jnp.asarray(pose)
    view = JG.mat4mul(pose, JG.get_inverse_camera_matrix(
        jnp.asarray(camera, jnp.float32)))
    fn = jax.jit(jax.shard_map(
        lambda ts, vw: kf._slab_raycast(ts, vw), mesh=mesh,
        in_specs=(P("z"), P()), out_specs=(P(), P()), check_vma=False))
    ts = jax.device_put(jnp.asarray(tsdf), jax.NamedSharding(mesh, P("z")))
    return tuple(map(np.asarray, fn(ts, view)))


def _compare(ref_v, ref_n, v2, n2):
    """Hit mismatch share, |dv| on common hits, their normals' dots."""
    h1, h2 = ref_n[0] != -2, n2[0] != -2
    m = h1 & h2
    dv = np.abs(ref_v[:, m] - v2[:, m]).max(axis=0)
    dot = np.sum(ref_n[:, m] * n2[:, m], axis=0)
    return (h1 != h2).mean(), dv, dot


def test_slab_raycast_matches_single_device(runs):
    """JAX's test_slab_raycast_matches_single_device on the port. At 4
    ranks the exact branch: hit mismatches < 1%, max |dv| < 1e-5 m,
    normal dot > 0.99 on > 99% of hits. At 8 ranks (8-plane slabs) the
    march enters each slab one large step early at an arbitrary phase,
    and JAX's loose branch holds: mismatches < 1%, < 8% of hits beyond
    voxel/10, agreeing hits' normal dot > 0.95, > 90% of dots > 0.99.

    JAX's bound of max |dv| < voxel at 8 shards was measured with JAX's
    halo, which permutes each slab's first planes forward and its last
    back, so that a halo holds planes a slab away. With the neighbours'
    adjacent planes, JAX's own slab raycast reads 1.004 voxels there
    (8 of 690 hits, 1.16% beyond voxel/10). The port is held instead to
    that raycast, to float ULP (the exact branch's bounds)."""
    _, _, _, _, got = runs
    tsdf = _sphere()
    view = G.mat4mul(G.translation_pose([1.0, 1.0, 0.2], CPU),
                     G.get_inverse_camera_matrix(
                         torch.tensor([60.0, 60.0, 16.0, 12.0])))
    t = torch.from_numpy(tsdf)
    v1, n1, _ = raycast_fast_maps(t, make_min_mip(t), (2.0,) * 3, view,
                                  (24, 32), 0.1, 4.0, 2.0 / 64, 0.15)
    v1, n1 = v1.numpy(), n1.numpy()
    hits1 = n1[0] != -2
    voxel = 2.0 / 64

    def compare(v2, n2, ref_v=v1, ref_n=n1):
        return _compare(ref_v, ref_n, v2, n2)

    mis, dv, dot = compare(got[4]["ray_vertex"], got[4]["ray_normal"])
    assert mis < 0.01 and hits1.sum() > 600
    assert dv.max() < 1e-5, f"4-rank max dev {dv.max():.2e} m"
    assert (dot > 0.99).mean() > 0.99

    v8, n8 = got[8]["ray_vertex"], got[8]["ray_normal"]
    mis, dv, dot = compare(v8, n8)
    assert mis < 0.01
    assert (dv > voxel / 10).mean() < 0.08, \
        f"{(dv > voxel / 10).mean():.4%} of hits deviate"
    agree = dv <= voxel / 10
    assert dot[agree].min() > 0.95
    assert (dot > 0.99).mean() > 0.9
    jv, jn = _jax_slab_raycast(tsdf, 8)
    mis, dv, dot = compare(v8, n8, jv, jn)
    assert mis < 0.01
    assert dv.max() < 1e-5, f"8 ranks vs JAX's slab raycast {dv.max():.2e}"
    assert (dot > 0.99).mean() > 0.99


@pytest.mark.parametrize("ranks", [2, 4])
def test_slab_raycast_of_clip_volume_matches_jax(runs, ranks):
    """A real scene's volume: the clip's final 64^3 volume at 2 and 4
    ranks, the port's slab raycast from the final pose against JAX's
    slab raycast of the same volume (each neighbour's adjacent planes as
    its halo) at the exact branch's bounds: hit mismatches < 1%, max
    |dv| < 1e-5 m, normal dot > 0.99 on > 99% of common hits. Where the
    slab raycast of such a volume departs from the single device's, it
    is then the slab design's, which JAX's raycast shares."""
    man, _, _, _, got = runs
    g = got[ranks]
    jv, jn = _jax_slab_raycast(g["clip_tsdf"], ranks,
                               image=man["image_size"], dim=man["dim"],
                               camera=man["camera"], mu=0.1,
                               pose=g["clip_pose"])
    assert (jn[0] != -2).sum() > 0.5 * jn[0].size
    mis, dv, dot = _compare(jv, jn, g["clip_vertex"], g["clip_normal"])
    assert mis < 0.01, f"{mis:.4%} hits differ"
    assert dv.max() < 1e-5, f"{ranks} ranks vs JAX's slab raycast " \
        f"{dv.max():.2e} m"
    assert (dot > 0.99).mean() > 0.99


def test_sharded_rejects_bad_meshes():
    """z must divide by the ranks; the device must be the rank's."""
    from slambench_tpu_torch.parallel import distributed as D
    from slambench_tpu_torch.parallel.step import ShardedKFusion

    mesh = D.initialize(1, "cpu")
    try:
        args = ((16, 12), (16, 16, 15), (2.0,) * 3, (1, 1, 0), (2, 2),
                (30.0, 30.0, 8.0, 6.0))
        mesh.size = 2          # as a 2-rank mesh would report
        with pytest.raises(ValueError, match="divide"):
            ShardedKFusion(*args, mesh=mesh)
        mesh.size = 1
        with pytest.raises(ValueError, match="rank's"):
            ShardedKFusion(*args, mesh=mesh, device="meta")
        kf = ShardedKFusion(*args, mesh=mesh)
        assert kf.halo == min(int(np.ceil(0.75 * 0.1 / (2.0 / 15))) + 2, 15)
        assert kf.init_state().tsdf.shape == (15, 16, 16)
    finally:
        mesh.close()


def test_slab_integrate_matches_whole_volume_and_jax():
    """integrate() on z-slabs (z_offset / z_total) gives the whole
    volume's planes bit for bit, z_offset 0 changes nothing, and a slab
    matches JAX's integrate with the same arguments (weights equal, tsdf
    within 1 LSB)."""
    from slambench_tpu.ops.integrate import integrate as jintegrate
    from slambench_tpu_torch.ops.integrate import integrate
    from slambench_tpu_torch.volume import init_volume

    rng = np.random.default_rng(3)
    depth = (1.5 + 0.3 * rng.random((24, 32))).astype(np.float32)
    depth[rng.random(depth.shape) < 0.05] = 0.0
    inv = np.linalg.inv(G.translation_pose([1.0, 1.0, -0.5], CPU).numpy())
    K = G.get_camera_matrix(torch.tensor([30.0, 30.0, 16.0, 12.0])).numpy()
    tsdf, weight = init_volume((16, 16, 32), CPU)
    args = (torch.from_numpy(depth), torch.from_numpy(inv),
            torch.from_numpy(K), 0.1, 100.0, (2.0, 2.0, 2.0))
    whole = integrate(tsdf, weight, *args)
    same = integrate(tsdf, weight, *args, z_offset=0, z_total=32)
    assert all(torch.equal(a, b) for a, b in zip(whole, same))
    for z0 in (0, 8, 24):
        part = integrate(tsdf[z0:z0 + 8], weight[z0:z0 + 8], *args,
                         z_offset=z0, z_total=32)
        assert torch.equal(part[0], whole[0][z0:z0 + 8])
        assert torch.equal(part[1], whole[1][z0:z0 + 8])
        jt, jw = jintegrate(jnp.asarray(tsdf[z0:z0 + 8].numpy()),
                            jnp.asarray(weight[z0:z0 + 8].numpy()),
                            jnp.asarray(depth), jnp.asarray(inv),
                            jnp.asarray(K), 0.1, 100.0, (2.0, 2.0, 2.0),
                            z_offset=z0, z_total=32)
        np.testing.assert_array_equal(part[1].numpy(), np.asarray(jw))
        d = np.abs(part[0].numpy().astype(np.int32) - np.asarray(jt, np.int32))
        assert d.max() <= 1
    assert (whole[1] > 0).any()
