"""Port parity for the constant-velocity warm start and checkpoints:
``pipeline.cv_predict`` against the JAX package's, one ``cv`` frame from
a shared state, the ``.npz`` in both directions between the packages,
resume identity over 12 frames, and the CLI's ``--checkpoint`` /
``--resume``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu import geometry as JG  # noqa: E402
from slambench_tpu.pipeline import KFusion as JKFusion  # noqa: E402
from slambench_tpu.pipeline import KFusionState as JState  # noqa: E402
from slambench_tpu.pipeline import cv_predict as j_cv_predict  # noqa: E402
from slambench_tpu.utils import checkpoint as JC  # noqa: E402

from slambench_tpu_torch import convert  # noqa: E402
from slambench_tpu_torch.config import parse_args  # noqa: E402
from slambench_tpu_torch.eval.check_pos import parse_benchmark_log  # noqa: E402
from slambench_tpu_torch.frontend.benchmark import run  # noqa: E402
from slambench_tpu_torch.io import synthetic as TS  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion, cv_predict  # noqa: E402
from slambench_tpu_torch.utils import checkpoint as TC  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """12 frames of test_pipeline_e2e.py's clip (160x120, amp 0.12)."""
    out = str(tmp_path_factory.mktemp("synth_resume"))
    return TS.generate_dataset(out, CPU, n_frames=12, image_size=(160, 120),
                               dim=(4.8, 4.8, 4.8), amp=0.12)


@pytest.fixture(scope="module")
def frames(dataset):
    rd = RawDepthReader(dataset["raw"])
    return [np.ascontiguousarray(rd.read_next_depth_frame())
            for _ in range(12)]


def _args(man, res, pyramid=(10, 5, 4)):
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    return (man["image_size"], (res,) * 3, man["dim"], init, pyramid,
            man["camera"])


def test_cv_predict_matches_jax():
    """Random pose pairs, from a tiny step to one past the 0.04 cap and
    the identity motion: rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(7)
    for scale in (1e-4, 1e-2, 0.2, 0.0):
        old = np.array(JG.se3_exp(jnp.asarray(
            rng.normal(size=6).astype(np.float32))))
        step = np.array(JG.se3_exp(jnp.asarray(
            (scale * rng.normal(size=6)).astype(np.float32))))
        pose = (old @ step).astype(np.float32)
        want = np.asarray(j_cv_predict(jnp.asarray(pose), jnp.asarray(old)))
        got = cv_predict(torch.from_numpy(pose), torch.from_numpy(old))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_cv_frame_matches_jax(dataset, frames):
    """Frames 0-5 in the port with ``motion_model="cv"`` (frame 5 is
    tracked, so the state carries a real motion), then frame 6 in both
    packages from that state: pose within 1e-4 m, same tracked flag."""
    args = _args(dataset, 64)
    kf = KFusion(*args, motion_model="cv", device=CPU)
    state = kf.init_state()
    for f in range(6):
        state = kf.process_frame(state, frames[f], f, integration_rate=1)
    assert bool(state.tracked)
    assert not torch.equal(state.pose, state.old_pose)
    shared = convert.state_to_numpy(state)
    gates = dict(tracking_on=True, integrate_frame=True,
                 force_integrate=False, raycast_on=True)
    js = JKFusion(*args, motion_model="cv").compute_frame(
        JState(**{k: jnp.asarray(v) for k, v in shared.items()}),
        jnp.asarray(frames[6]), **gates)
    ts = kf.compute_frame(convert.state_from_numpy(shared, CPU),
                          kf.to_device(frames[6]), **gates)
    np.testing.assert_allclose(ts.pose[:3, 3].numpy(),
                               np.asarray(js.pose[:3, 3]), atol=1e-4)
    assert bool(ts.tracked) == bool(js.tracked) is True


@pytest.fixture(scope="module")
def port_run(dataset, frames):
    """12 frames in the port at 32^3 with pyramid (4, 3, 3), as
    test_pipeline_e2e.py's resume test runs; the state after frame 5
    and the final pose."""
    kf = KFusion(*_args(dataset, 32, (4, 3, 3)), device=CPU)
    state = kf.init_state()
    saved = None
    for f in range(12):
        state = kf.process_frame(state, frames[f], f)
        if f == 5:
            saved = convert.state_to_numpy(state)
    return kf, saved, state.pose.numpy()


def test_checkpoint_files_cross_load(dataset, port_run, tmp_path):
    """A JAX ``save_state`` file loads in the port, and a port
    ``save_state`` file loads in the JAX package: every leaf equal bit for
    bit, dtype and shape included, and the frame count kept."""
    _, saved, _ = port_run
    port_path = str(tmp_path / "port.npz")
    jax_path = str(tmp_path / "jax.npz")
    TC.save_state(port_path, convert.state_from_numpy(saved, CPU), 6)
    JC.save_state(jax_path, JState(**{k: jnp.asarray(v)
                                      for k, v in saved.items()}), 6)
    js, jframe = JC.load_state(port_path)
    ts, tframe = TC.load_state(jax_path, CPU)
    assert jframe == tframe == 6
    for f in dataclasses.fields(JState):
        want = saved[f.name]
        for got in (np.asarray(getattr(js, f.name)),
                    getattr(ts, f.name).numpy()):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f.name)


def test_resume_reproduces_the_trajectory(frames, port_run, tmp_path):
    """Saving after frame 5 and resuming through frame 11 gives the
    uninterrupted final pose within 1e-6 (test_pipeline_e2e.py:183)."""
    kf, saved, final_pose = port_run
    path = str(tmp_path / "ck.npz")
    TC.save_state(path, convert.state_from_numpy(saved, CPU), 6)
    state, start = TC.load_state(path, CPU)
    assert start == 6
    for f in range(start, 12):
        state = kf.process_frame(state, frames[f], f)
    np.testing.assert_allclose(state.pose.numpy(), final_pose, atol=1e-6)


def test_cli_checkpoint_and_resume(dataset, tmp_path):
    """The CLI over frames 0-11 in one run, and as frames 0-5 with
    ``--checkpoint`` then ``--resume`` to the end: the resumed log starts
    at frame 6 and its poses equal the full run's within 1e-6 m."""
    flags = ["-i", dataset["raw"], "-v", "32", "-s", "4.8",
             "-p", "0.34,0.5,0.24", "-c", "1", "-r", "2", "-z", "4",
             "-y", "4,3,3", "-k", "120.3,120.0,80,60"]
    ck = str(tmp_path / "ck.npz")
    full_log, first_log, rest_log = (str(tmp_path / n) for n in
                                     ("full.log", "first.log", "rest.log"))
    run(parse_args(flags + ["-o", full_log]), CPU, quiet=True)
    run(parse_args(flags + ["-o", first_log, "--checkpoint", ck]), CPU,
        max_frames=6, quiet=True)
    summary = run(parse_args(flags + ["-o", rest_log, "--resume", ck]), CPU,
                  quiet=True)
    assert summary["frames"] == 6
    full, first, rest = map(parse_benchmark_log,
                            (full_log, first_log, rest_log))
    np.testing.assert_array_equal(first["frame"], np.arange(6))
    np.testing.assert_array_equal(rest["frame"], np.arange(6, 12))
    for col in ("X", "Y", "Z"):
        np.testing.assert_allclose(
            np.concatenate([first[col], rest[col]]), full[col], atol=1e-6)
    np.testing.assert_array_equal(
        np.concatenate([first["tracked"], rest["tracked"]]), full["tracked"])
