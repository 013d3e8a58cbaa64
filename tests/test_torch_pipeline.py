"""Port parity for the whole frame step: state conversion, the synthetic
generator, one steady-state frame from a state shared with the JAX
package, a port-only end-to-end run through the port's CLI, and the
rule that the port never imports JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from slambench_tpu.io import synthetic as JS  # noqa: E402
from slambench_tpu.pipeline import KFusion as JKFusion  # noqa: E402
from slambench_tpu.pipeline import KFusionState as JState  # noqa: E402

from slambench_tpu_torch import convert  # noqa: E402
from slambench_tpu_torch.config import parse_args  # noqa: E402
from slambench_tpu_torch.eval.check_pos import (  # noqa: E402
    compute_ate, load_gt_trajectory, parse_benchmark_log,
)
from slambench_tpu_torch.frontend.benchmark import HEADER, run  # noqa: E402
from slambench_tpu_torch.io import synthetic as TS  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion, KFusionState  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """test_pipeline_e2e.py's clip (30 frames, 160x120, amp 0.12),
    rendered by the port's generator."""
    out = str(tmp_path_factory.mktemp("synth_torch"))
    return TS.generate_dataset(out, CPU, n_frames=30, image_size=(160, 120),
                               dim=(4.8, 4.8, 4.8), amp=0.12)


def _kf_args(man, res=64):
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    return (man["image_size"], (res,) * 3, man["dim"], init, (10, 5, 4),
            man["camera"])


def test_state_round_trip_matches_jax_leaves():
    args = ((16, 12), (16,) * 3, (2.0,) * 3, (1.0, 1.0, 0.0), (2, 2),
            (30.0, 30.0, 8.0, 6.0))
    jstate = JKFusion(*args).init_state()
    jleaves = {f.name: np.asarray(getattr(jstate, f.name))
               for f in dataclasses.fields(JState)}
    assert convert.LEAVES == tuple(jleaves)
    port = convert.state_from_numpy(jleaves, CPU)
    back = convert.state_to_numpy(port)
    fresh = convert.state_to_numpy(KFusion(*args, device=CPU).init_state())
    for name, want in jleaves.items():
        for got in (back[name], fresh[name]):
            assert got.dtype == want.dtype, name
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(ValueError, match="missing"):
        convert.state_from_numpy({k: v for k, v in jleaves.items()
                                  if k != "mip"}, CPU)


def test_synthetic_generator_matches_jax():
    init = (0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8)
    poses_t = TS.orbit_trajectory(40, init)
    np.testing.assert_array_equal(poses_t, JS.orbit_trajectory(40, init))
    scene_j = JS.SyntheticScene()
    k = (60.15, 60.0, 40.0, 30.0)
    render = jax.jit(lambda p: JS.render_depth_frame(scene_j, p, k, (80, 60)))
    for i in (0, 39):
        got = TS.render_depth_frame(TS.SyntheticScene(), poses_t[i], k,
                                    (80, 60), CPU)
        want = np.asarray(render(jnp.asarray(poses_t[i])))
        assert got.dtype == np.uint16 and got.shape == (60, 80)
        close = np.abs(got.astype(np.int32) - want.astype(np.int32)) <= 1
        assert close.mean() >= 0.999, f"frame {i}: {close.mean():.5f}"


def test_steady_state_frame_matches_jax(dataset):
    """Bootstrap frames 0-4 in the port, hand the state to the JAX
    package, and run frame 5 in both (one JAX gate variant compiled).
    Gates of test_pipeline_e2e.py:129-135: pose translation within
    1e-4 m, the same tracked flag, < 2% of TSDF voxels differ and < 1e-4
    of them by more than 2 LSB."""
    man = dataset
    rd = RawDepthReader(man["raw"])
    frames = [np.ascontiguousarray(rd.read_next_depth_frame())
              for _ in range(6)]
    kf = KFusion(*_kf_args(man), device=CPU)
    state = kf.init_state()
    for f in range(5):
        state = kf.process_frame(state, frames[f], f, integration_rate=1)
    assert bool(state.tracked)
    shared = convert.state_to_numpy(state)

    gates = dict(tracking_on=True, integrate_frame=True,
                 force_integrate=False, raycast_on=True)
    jkf = JKFusion(*_kf_args(man), backend="fast")
    js = jkf.compute_frame(JState(**{k: jnp.asarray(v)
                                     for k, v in shared.items()}),
                           jnp.asarray(frames[5]), **gates)
    ts = kf.compute_frame(convert.state_from_numpy(shared, CPU),
                          kf.to_device(frames[5]), **gates)

    np.testing.assert_allclose(ts.pose[:3, 3].numpy(),
                               np.asarray(js.pose[:3, 3]), atol=1e-4)
    assert bool(ts.tracked) == bool(js.tracked) is True
    assert bool(ts.integrated) and bool(js.integrated)
    d = np.abs(ts.tsdf.numpy().astype(np.int32)
               - np.asarray(js.tsdf, np.int32))
    assert (d > 0).mean() < 0.02, f"{(d > 0).mean():.4f} voxels differ"
    assert (d > 2).mean() < 1e-4, f"{(d > 2).sum()} voxels beyond 2 LSB"
    np.testing.assert_array_equal(ts.weight.numpy(), np.asarray(js.weight))
    # The ICP products the frame carries: level-0 result codes and the
    # final packed reduction.
    same = ts.track_result.numpy() == np.asarray(js.track_result)
    assert same.mean() > 0.999, f"{same.mean():.5f} of result codes agree"
    np.testing.assert_allclose(ts.reduction.numpy(),
                               np.asarray(js.reduction), rtol=1e-3, atol=1e-2)


def test_icp_freeze_keeps_the_converging_update(dataset):
    """A level that converges freezes from the converging iteration on,
    keeping that iteration's update (the JAX while_loop applies the
    update of the step that reports convergence, then stops). With an
    ICP threshold every step meets, a (3,3,3) budget must equal a
    (1,1,1) budget bit for bit: pose, reduction and result codes."""
    man = dataset
    rd = RawDepthReader(man["raw"])
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]

    def make(pyramid, thr):
        return KFusion(man["image_size"], (32,) * 3, man["dim"], init,
                       pyramid, man["camera"], icp_threshold=thr, device=CPU)

    kf = make((1, 1, 1), 1e-5)
    state = kf.init_state()
    for f in range(5):
        state = kf.process_frame(state, rd.read_next_depth_frame(), f,
                                 integration_rate=1)
    state = kf.preprocessing(state, kf.to_device(rd.read_next_depth_frame()))
    one = kf.tracking(state)
    frozen = make((3, 3, 3), 1e9).tracking(state)
    assert bool(one.tracked)
    for name in ("pose", "reduction", "track_result", "tracked"):
        assert torch.equal(getattr(one, name), getattr(frozen, name)), name
    more = make((3, 3, 3), 1e-5).tracking(state)
    assert not torch.equal(one.pose, more.pose)


def test_cli_e2e_trajectory_ate(dataset, tmp_path):
    """The port's CLI over the 30-frame clip at 64^3 (7.5 cm voxels):
    check_pos accepts the 14-column log; test_synthetic_trajectory_ate's
    gates (ATE mean < 0.06 m, max < 0.15 m, tracked from frame 4)."""
    man = dataset
    log_path = str(tmp_path / "benchmark.log")
    cfg = parse_args(["-i", man["raw"], "-o", log_path, "-v", "64",
                      "-s", "4.8", "-p", "0.34,0.5,0.24", "-c", "1",
                      "-r", "2", "-z", "4", "-k", "120.3,120.0,80,60"])
    summary = run(cfg, CPU, quiet=True)
    assert summary["frames"] == 30
    with open(log_path) as f:
        assert f.readline().rstrip("\n") == HEADER
    log = parse_benchmark_log(log_path)
    assert len(log["frame"]) == 30 and (log["rendering"] > 0).all()
    ate = compute_ate(log, load_gt_trajectory(man["gt"]))["ATE"]
    assert ate.mean() < 0.06, f"mean ATE {ate.mean():.4f} m"
    assert ate.max() < 0.15, f"max ATE {ate.max():.4f} m"
    assert not log["tracked"][0]
    assert log["tracked"][4:].all(), "lost tracking mid-sequence"
    assert log["integrated"][:4].all()


def test_backend_names_and_unported_paths(dataset, tmp_path):
    args = ((16, 12), (16,) * 3, (2.0,) * 3, (1, 1, 0), (2, 2),
            (30.0, 30.0, 8.0, 6.0))
    for name in ("jnp", "fast", "pallas", "auto"):
        assert KFusion(*args, backend=name, device=CPU).backend == name
    assert KFusion(*args, motion_model="cv", device=CPU).motion_model == "cv"
    with pytest.raises(ValueError):
        KFusion(*args, backend="palas", device=CPU)
    with pytest.raises(ValueError):
        KFusion(*args, motion_model="constant", device=CPU)
    from slambench_tpu_torch.frontend.benchmark import (
        NOT_PORTED_FLAGS, main,
    )
    assert NOT_PORTED_FLAGS == ()
    # The keyframe flags and --scan-chunk N are accepted and consumed: the
    # command line then fails only on the missing input (exit 1), not as
    # refused (2) or as an unknown option (0).
    for flags in (["--keyframes"], ["--ba"], ["--keyframes", "--ba"],
                  ["--fused", "--scan-chunk", "4"]):
        with pytest.raises(SystemExit) as exc:
            main(["--device", "cpu", *flags, "-i", "x.raw"])
        assert exc.value.code == 1, flags
    # --mesh z:1 runs the sharded step on one gloo rank on the CPU, and
    # check_pos reads its log (8 frames at 64^3: the CLI test's gates).
    log_path = str(tmp_path / "mesh.log")
    summary = run(parse_args(["-i", dataset["raw"], "-o", log_path,
                              "-v", "64", "-s", "4.8", "-p", "0.34,0.5,0.24",
                              "-c", "1", "-r", "1", "-k", "120.3,120.0,80,60",
                              "--mesh", "z:1"]), CPU, quiet=True,
                  max_frames=8)
    assert summary["frames"] == 8 and summary["mesh"]["ranks"] == 1
    log = parse_benchmark_log(log_path)
    ate = compute_ate(log, load_gt_trajectory(dataset["gt"]))["ATE"]
    assert len(log["frame"]) == 8 and log["tracked"][4:].all()
    assert ate.mean() < 0.06, f"mean ATE {ate.mean():.4f} m"


def test_port_never_imports_jax():
    """Import every module of the port (and chip_smoke.py) in a fresh
    interpreter: jax must stay out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import slambench_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'slambench_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")
