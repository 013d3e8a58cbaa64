"""The port's multi-process layer on gloo ranks on the CPU: the
collectives (``tools/distributed_probe.py``, JAX's test_distributed.py),
the CLI's ``--mesh`` at 1 rank and at 2 under ``torchrun``, and the
grouped pose graph and bundle adjustment (JAX's ``axis_name`` variants,
test_ba.py:99). The sharded step against JAX's is in
test_torch_sharded_jax.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch.config import parse_args  # noqa: E402
from slambench_tpu_torch.eval.check_pos import (  # noqa: E402
    compute_ate, load_gt_trajectory, parse_benchmark_log,
)
from slambench_tpu_torch.frontend.benchmark import main, run  # noqa: E402
from slambench_tpu_torch.geometry import se3_exp  # noqa: E402
from slambench_tpu_torch.io import synthetic as TS  # noqa: E402
from slambench_tpu_torch.models import ba as PB  # noqa: E402
from slambench_tpu_torch.models import posegraph as PP  # noqa: E402
from slambench_tpu_torch.parallel import distributed  # noqa: E402
from slambench_tpu_torch.utils.checkpoint import load_state  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["-v", "64", "-s", "4.8", "-p", "0.34,0.5,0.24", "-c", "1",
         "-r", "1", "-k", "120.3,120.0,80,60"]

# One rank's jobs (argv[1]: JSON); rank 0 saves the results to job["out"].
WORKER = r'''
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from slambench_tpu_torch.parallel import distributed
job = json.loads(sys.argv[1])
mesh = distributed.initialize(0, "cpu")
out = {}
if "ba" in job:
    from slambench_tpu_torch.models import ba, posegraph
    z = np.load(job["ba"])
    mine = np.arange(len(z["cam"])) % mesh.size == mesh.rank
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    p, l, r2 = ba.bundle_adjust(t(z["p0"]), t(z["l0"]), t(z["cam"][mine]),
                                t(z["lm"][mine]), t(z["z"][mine]),
                                t(z["w"][mine]), n_iters=4,
                                group=mesh)
    out.update(ba_poses=p.numpy(), ba_landmarks=l.numpy(), ba_r2=r2.numpy())
    mine = np.arange(len(z["ij"])) % mesh.size == mesh.rank
    p, r2 = posegraph.optimize_pose_graph(
        t(z["poses"]), t(z["ij"][mine]), t(z["T"][mine]), t(z["ew"][mine]),
        group=mesh)
    out.update(pg_poses=p.numpy(), pg_r2=r2.numpy())
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


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_clip"))
    return TS.generate_dataset(out, CPU, n_frames=10, image_size=(160, 120),
                               dim=(4.8, 4.8, 4.8), amp=0.12)


# --- collectives (tools/distributed_probe.py) --------------------------

# The probe's ranks with the halo sent by all_gather, the route the mesh
# picks for gloo with CUDA tensors (two ranks sharing one card), forced
# here on CPU tensors so that the CPU covers it too.
GATHER_PROBE = r'''
import sys
from slambench_tpu_torch.parallel import distributed
from slambench_tpu_torch.tools import distributed_probe
make = distributed.initialize
def initialize(*args, **kwargs):
    mesh = make(*args, **kwargs)
    mesh.halo_by_gather = True
    return mesh
distributed.initialize = initialize
sys.exit(distributed_probe.rank_main("cpu", True))
'''


@pytest.mark.parametrize("gather", [False, True],
                         ids=["isend_irecv", "all_gather"])
def test_two_process_collectives(gather):
    """psum and the ring halo across 2 ranks by either halo route, and
    one full sharded step at tiny shapes (JAX's test_two_process_
    collectives and test_two_process_full_sharded_step)."""
    if gather:
        outs = distributed.launch(2, ["-c", GATHER_PROBE], cwd=REPO,
                                  timeout=300)
        for rc, _, err in outs:
            assert rc == 0, err[-3000:]
        lines = [out.strip().splitlines()[-1] for _, out, _ in outs]
    else:
        out = subprocess.run(
            [sys.executable, "-m",
             "slambench_tpu_torch.tools.distributed_probe", "--launch", "2",
             "--device", "cpu", "--full-step"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        lines = out.stdout.strip().splitlines()
    recs = [json.loads(ln) for ln in lines]
    assert sorted(r["rank"] for r in recs) == [0, 1]
    for r in recs:
        assert r["ranks"] == 2 and r["backend"] == "gloo"
        assert r["halo_by_gather"] is gather
        assert r["psum"] == r["psum_want"] == 1.0
        assert r["ring_ok"] is True and r["ring"] == r["ring_want"]
        assert r["full_step_pose_finite"] is True


# --- the CLI's --mesh ---------------------------------------------------

def _check_log(log_path, man, frames):
    log = parse_benchmark_log(log_path)
    assert len(log["frame"]) == frames
    ate = compute_ate(log, load_gt_trajectory(man["gt"]))["ATE"]
    assert ate.mean() < 0.06, f"mean ATE {ate.mean():.4f} m"
    assert log["tracked"][4:].all()
    return np.stack([log["X"], log["Y"], log["Z"]], 1)


def test_cli_mesh_one_rank_and_two_under_torchrun(dataset, tmp_path):
    """--mesh z:1 in this process and --mesh z:2 under torchrun
    --nproc-per-node 2: both logs pass check_pos's gates (ATE mean
    < 0.06 m at 64^3, tracked from frame 4); at 2 ranks the poses were
    checked equal bit for bit after every frame and the tally of a frame
    equals parallel/comm.py's account."""
    man = dataset
    one = str(tmp_path / "one.log")
    summary = run(parse_args(["-i", man["raw"], "-o", one, *FLAGS,
                              "--mesh", "z:1"]), CPU, quiet=True)
    assert summary["frames"] == 10 and summary["mesh"]["ranks"] == 1
    assert summary["mesh"]["backend"] == "gloo"
    pos1 = _check_log(one, man, 10)

    two = str(tmp_path / "two.log")
    ckpt, dump = str(tmp_path / "two.npz"), str(tmp_path / "two.vol")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "slambench_tpu_torch.frontend.benchmark", "--device", "cpu",
         "-i", man["raw"], "-o", two, *FLAGS, "--mesh", "z:2",
         "--checkpoint", ckpt, "-d", dump],
        cwd=REPO, capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stderr.splitlines()
             if ln.startswith("mesh summary: ")]
    assert len(lines) == 1, out.stderr[-3000:]
    sm = json.loads(lines[0][len("mesh summary: "):])
    assert sm["ranks"] == 2 and sm["replication_checks"] == 10
    assert sm["analytic_mismatch"] == []
    assert "mesh z:2, rank 0, gloo on cpu" in out.stderr
    pos2 = _check_log(two, man, 10)
    voxel = 4.8 / 64
    assert np.abs(pos2 - pos1).max() < voxel / 4
    # The checkpoint and the volume dump hold the whole volume (the two
    # slabs gathered), and the checkpoint loads on one device.
    state, frame = load_state(ckpt, CPU)
    assert frame == 10 and tuple(state.tsdf.shape) == (64, 64, 64)
    np.testing.assert_array_equal(
        np.fromfile(dump, "<i2").reshape(64, 64, 64), state.tsdf.numpy())
    assert (state.weight.numpy() > 0).any() and bool(state.tracked)


def test_cli_mesh_refusals(dataset, capsys):
    """--keyframes with --mesh is refused (as in JAX); --mesh z:2 without
    a launcher exits 2 and says to use torchrun."""
    man = dataset
    with pytest.raises(SystemExit, match="--keyframes"):
        run(parse_args(["-i", man["raw"], *FLAGS, "--mesh", "z:1"]), CPU,
            keyframes=True)
    assert main(["--device", "cpu", "-i", man["raw"], *FLAGS,
                 "--mesh", "z:2"]) == 2
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().err


# --- grouped pose graph and bundle adjustment ---------------------------

def _exp(x) -> np.ndarray:
    return se3_exp(torch.as_tensor(np.asarray(x, np.float32))).numpy()


def test_grouped_ba_and_pose_graph_match_single_rank(tmp_path):
    """Observations (and edges) dealt out over 2 ranks, the normal
    equations all-reduced over the group: the result equals one rank
    with all of them (JAX's test_ba_sharded_matches_single, 1e-4)."""
    rng = np.random.default_rng(7)
    gt_p = np.stack([_exp([0.5 * i, 0.1 * np.sin(i), 0, 0, 0.05 * i, 0])
                     for i in range(4)])
    gt_l = rng.uniform(-1, 1, size=(16, 3)).astype(np.float32)
    gt_l[:, 2] += 3.0
    cam, lm, z, w = PB.make_observations(gt_p, gt_l, noise=0.01, rng=rng)
    p0 = np.stack([gt_p[0]] + [gt_p[i] @ _exp(0.05 * rng.normal(size=6))
                               for i in range(1, 4)]).astype(np.float32)
    l0 = (gt_l + 0.05 * rng.normal(size=gt_l.shape)).astype(np.float32)
    # An 8-pose circle with noisy odometry and two loop edges.
    gt = [_exp([np.cos(a), np.sin(a), 0, 0, 0, a])
          for a in 2 * np.pi * np.arange(8) / 8]
    est, ij, T = [gt[0]], [], []
    for i in range(7):
        m = np.linalg.inv(gt[i]) @ gt[i + 1] @ _exp(
            0.02 * rng.normal(size=6))
        est.append(est[-1] @ m)
        ij.append((i, i + 1))
        T.append(m)
    for i, j in ((7, 0), (6, 1)):
        ij.append((i, j))
        T.append(np.linalg.inv(gt[i]) @ gt[j])
    ew = np.ones(len(ij), np.float32)
    path = str(tmp_path / "problem.npz")
    np.savez(path, p0=p0, l0=l0, cam=cam, lm=lm, z=z, w=w,
             poses=np.stack(est).astype(np.float32),
             ij=np.asarray(ij, np.int64), T=np.stack(T).astype(np.float32),
             ew=ew)
    got = _launch(2, {"ba": path, "out": str(tmp_path / "out.npz")})

    t = torch.from_numpy
    sp, sl, sr2 = PB.bundle_adjust(t(p0), t(l0), t(cam), t(lm), t(z), t(w),
                                   n_iters=4)
    np.testing.assert_allclose(got["ba_poses"], sp.numpy(), atol=1e-4)
    np.testing.assert_allclose(got["ba_landmarks"], sl.numpy(), atol=1e-4)
    np.testing.assert_allclose(got["ba_r2"], sr2.numpy(), rtol=1e-3,
                               atol=1e-6)
    pp, pr2 = PP.optimize_pose_graph(
        t(np.stack(est).astype(np.float32)), t(np.asarray(ij, np.int64)),
        t(np.stack(T).astype(np.float32)), t(ew))
    np.testing.assert_allclose(got["pg_poses"], pp.numpy(), atol=1e-4)
    np.testing.assert_allclose(got["pg_r2"], pr2.numpy(), rtol=1e-3,
                               atol=1e-6)
