"""Port parity for the batched frame routes: ``KFusion.scan_step``,
``compute_frames_scan`` and ``compute_frames_scan_rated`` (JAX's
``lax.scan`` routes, slambench_tpu/pipeline.py:423-497) on the CPU, where
they loop ``scan_step`` without a CUDA graph.

* the port's steady-state scan against JAX's, in JAX's contract
  (tests/test_pipeline_e2e.py:88-137): positions within 1e-4 m, tracked
  and integrated equal, under 2% of voxels differ at all and under 1e-4
  by more than 2 LSB (the rated route's JAX comparison is
  test_torch_scan_rated.py: its compile alone takes most of a minute);
* both routes equal to the port's per-frame ``compute_frame`` bit for
  bit, in 3- and 4-frame chunks, also on the oracle march with the cv
  start;
* the full-budget marches (min-mip and oracle) equal to the early-exit
  ones bit for bit;
* the device-gated integrate leaves the TSDF, the weights and the
  min-mip unchanged when the gate is off, and equals the host-gated one
  when it is on;
* ``scan_step`` makes no host read.

Sizes: JAX's contract numbers, the shape cut to 32^3, 80x60, pyramid
3,2,2 and 5 boot frames."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu.pipeline import KFusion as JKFusion  # noqa: E402
from slambench_tpu.pipeline import KFusionState as JState  # noqa: E402

from slambench_tpu_torch import convert, params  # noqa: E402
from slambench_tpu_torch.geometry import get_inverse_camera_matrix, mat4mul  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.io.synthetic import generate_dataset  # noqa: E402
from slambench_tpu_torch.ops import raycast as oracle  # noqa: E402
from slambench_tpu_torch.ops import raycast_fast as fast  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion, frame_gates  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
BOOT = 5


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """13 frames of the port's synthetic orbit at 80x60 and the state
    after 5 boot frames (-r 1 gates), as numpy leaves."""
    out = str(tmp_path_factory.mktemp("synth_scan"))
    man = generate_dataset(out, CPU, n_frames=13, image_size=(80, 60),
                           dim=(4.8,) * 3, amp=0.12)
    rd = RawDepthReader(man["raw"])
    frames = np.stack([np.ascontiguousarray(rd.read_next_depth_frame())
                       for _ in range(13)])
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    args = (man["image_size"], (32,) * 3, man["dim"], init, (3, 2, 2),
            man["camera"])
    kf = KFusion(*args, device=CPU)
    state = kf.init_state()
    for f in range(BOOT):
        state = kf.compute_frame(state, kf.to_device(frames[f]),
                                 **frame_gates(f, 1, 1))
    assert bool(state.tracked)
    return {"args": args, "frames": frames,
            "boot": convert.state_to_numpy(state)}


def _port(clip, **kw):
    kf = KFusion(*clip["args"], device=CPU, **kw)
    return kf, convert.state_from_numpy(clip["boot"], CPU)


def _per_frame(kf, state, frames, first, rate=1):
    """``compute_frame`` from frame ``first`` on with the steady gates of
    ``-r rate`` (no forced integrate past the boot)."""
    rows = []
    for i, depth in enumerate(frames):
        state = kf.compute_frame(state, kf.to_device(depth),
                                 **frame_gates(first + i, 1, rate))
        rows.append((state.pose[:3, 3].clone(), bool(state.tracked),
                     bool(state.integrated)))
    return state, rows


def _tsdf_contract(got: np.ndarray, want: np.ndarray) -> None:
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (d > 0).mean() < 0.02, f"{(d > 0).mean():.4f} voxels differ"
    assert (d > 2).mean() < 1e-4, f"{(d > 2).sum()} voxels beyond 2 LSB"


def test_scan_matches_jax_scan(clip):
    frames = clip["frames"][BOOT:BOOT + 4]
    jkf = JKFusion(*clip["args"], backend="fast")
    js, jouts = jkf.compute_frames_scan(
        JState(**{k: jnp.asarray(v) for k, v in clip["boot"].items()}),
        jnp.asarray(frames))
    kf, state = _port(clip)
    ts, touts = kf.compute_frames_scan(state, frames)
    assert set(touts) == {"pos", "tracked", "integrated"}
    assert touts["pos"].shape == (4, 3) and touts["tracked"].dtype \
        == torch.bool
    np.testing.assert_allclose(touts["pos"].numpy(),
                               np.asarray(jouts["pos"]), atol=1e-4)
    np.testing.assert_array_equal(touts["tracked"].numpy(),
                                  np.asarray(jouts["tracked"]))
    np.testing.assert_array_equal(touts["integrated"].numpy(),
                                  np.asarray(jouts["integrated"]))
    assert touts["tracked"].all() and touts["integrated"].all()
    _tsdf_contract(ts.tsdf.numpy(), np.asarray(js.tsdf))
    np.testing.assert_allclose(ts.pose.numpy(), np.asarray(js.pose),
                               atol=1e-4)


@pytest.mark.parametrize("rate,chunk,kw", [
    (1, 3, {}), (2, 4, {}),
    (1, 3, {"backend": "jnp", "motion_model": "cv"})])
def test_scan_equals_per_frame_route(clip, rate, chunk, kw):
    """Two chunks through the batched route against the same frames one
    ``compute_frame`` at a time: every leaf and every output equal, on
    the min-mip march and on the oracle march with the cv start."""
    frames = clip["frames"][BOOT:BOOT + 2 * chunk]
    kf, state = _port(clip, **kw)
    want_state, want = _per_frame(kf, state, frames, BOOT, rate)
    kf2, got_state = _port(clip, **kw)
    outs = []
    for c in range(2):
        block = frames[c * chunk:(c + 1) * chunk]
        if rate == 1:
            got_state, o = kf2.compute_frames_scan(got_state, block)
        else:
            got_state, o = kf2.compute_frames_scan_rated(
                got_state, block.reshape(-1, rate, *block.shape[1:]),
                tracking_rate=1, integration_rate=rate,
                phase=(BOOT + c * chunk) % rate)
        outs.append(o)
    pos = torch.cat([o["pos"] for o in outs])
    for i, (p, tracked, integrated) in enumerate(want):
        assert torch.equal(pos[i], p), i
        assert bool(torch.cat([o["tracked"] for o in outs])[i]) == tracked
        assert bool(torch.cat([o["integrated"] for o in outs])[i]) \
            == integrated
    if rate == 2:
        assert [w[2] for w in want] == [(BOOT + i) % 2 == 0
                                        for i in range(len(want))]
    for field in dataclasses.fields(want_state):
        assert torch.equal(getattr(got_state, field.name),
                           getattr(want_state, field.name)), field.name


@pytest.mark.parametrize("march", ["mip", "oracle"])
def test_full_budget_march_equals_early_exit(clip, march):
    """The march with no host read runs its whole budget; a done ray is
    frozen by its masks, so the maps equal the early-exit march's bit
    for bit. (At 32^3 the oracle's 26-iteration budget is what its
    longest ray needs; the min-mip march stops well short of its
    budget, which the substep counter shows.)"""
    kf, state = _port(clip)
    view = mat4mul(state.pose, get_inverse_camera_matrix(kf._k))
    common = (kf.volume_dimensions, view, (kf.H, kf.W), params.NEAR_PLANE,
              params.FAR_PLANE, kf.step, 0.75 * kf.mu)
    maps, substeps = {}, {}
    for early in (True, False):
        before = fast.march_substeps
        if march == "mip":
            maps[early] = fast.raycast_fast_maps(
                state.tsdf, state.mip, *common, early_exit=early)
        else:
            maps[early] = oracle.raycast_maps(state.tsdf, *common,
                                              early_exit=early)
        substeps[early] = fast.march_substeps - before
    for got, want in zip(maps[False], maps[True]):
        assert torch.equal(got, want)
    if march == "mip":
        assert 0 < substeps[True] < substeps[False], substeps
    assert (maps[True][0].abs().sum(0) > 0).any(), "no ray hit"


@pytest.mark.parametrize("case", ["rate_off", "rejected", "on"])
def test_device_gated_integrate(clip, case):
    """``integration(on_device=True)``: the gate is a 0-d bool tensor;
    with it off (the rate gate, or a pose that checkPose rejects) no
    voxel, weight or min-mip cell changes; with it on the result is the
    host-gated route's."""
    kf, state = _port(clip)
    state = kf.tracking(kf.preprocessing(
        state, kf.to_device(clip["frames"][BOOT])))
    integrate_frame = case != "rate_off"
    if case == "rejected":
        state = dataclasses.replace(state,
                                    reduction=torch.zeros_like(
                                        state.reduction))
    got = kf.integration(state, integrate_frame=integrate_frame,
                         force_integrate=False, on_device=True)
    want = kf.integration(state, integrate_frame=integrate_frame,
                          force_integrate=False)
    assert got.integrated.dim() == 0 and got.integrated.dtype == torch.bool
    assert bool(got.integrated) == bool(want.integrated) == (case == "on")
    for name in ("tsdf", "weight", "mip", "pose"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        if case != "on" and name != "pose":
            assert torch.equal(getattr(got, name), getattr(state, name))
    if case == "on":
        assert not torch.equal(got.tsdf, state.tsdf)


def test_scan_step_makes_no_host_read(clip, monkeypatch):
    """Every way a tensor reaches the host raises inside ``scan_step``:
    the CPU's stand-in for the card's sync-debug check."""
    kf, state = _port(clip)
    depth = kf.to_device(clip["frames"][BOOT])

    def host_read(*_a, **_k):
        raise AssertionError("host read in scan_step")

    for name in ("__bool__", "item", "tolist", "cpu", "numpy",
                 "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    for gates in ({}, {"integrate_frame": False}, {"tracking_on": False}):
        state = kf.scan_step(state, depth, **gates)
    monkeypatch.undo()
    assert bool(state.tracked) is False
