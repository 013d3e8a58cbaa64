"""Port parity for the ICP census: ``KFusion.tracking(census=True)``'s
executed iteration counts and convergence flags against JAX's
``_tracking(with_census=True)`` (one step from a shared checkpoint, and
frame by frame over a short clip), and ``tools/icp_census.py``."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from slambench_tpu.pipeline import KFusion as JKFusion  # noqa: E402
from slambench_tpu.utils.checkpoint import load_state as jload  # noqa: E402

from slambench_tpu_torch.io import synthetic as TS  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion  # noqa: E402
from slambench_tpu_torch.tools import icp_census  # noqa: E402
from slambench_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_state, save_state,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")
FRAMES = 8


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """8 frames at 160x120 (amp 0.15) and the kfusion arguments at 64^3."""
    out = str(tmp_path_factory.mktemp("census"))
    man = TS.generate_dataset(out, CPU, n_frames=FRAMES,
                              image_size=(160, 120), dim=(4.8, 4.8, 4.8),
                              amp=0.15)
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    args = (man["image_size"], (64,) * 3, man["dim"], init, (10, 5, 4),
            man["camera"])
    rd = RawDepthReader(man["raw"])
    depths = [np.ascontiguousarray(rd.read_next_depth_frame())
              for _ in range(FRAMES)]
    return man, args, depths


@pytest.fixture(scope="module")
def jax_census(clip):
    """JAX's pipeline at the clip's settings and its census tracking,
    compiled once for the module."""
    _, args, _ = clip
    jkf = JKFusion(*args, backend="fast")
    return jkf, jax.jit(lambda s: jkf._tracking(s, with_census=True))


def _jax_census(jkf, counted, depths):
    """JAX's census per steady-state frame (the loop of JAX's tool)."""
    state = jkf.init_state()
    rows = []
    for frame, d in enumerate(depths):
        state = jkf.preprocessing(state, jnp.asarray(d))
        state, counts, convs = counted(state)
        if frame > 3:
            rows.append((frame, np.asarray(counts), np.asarray(convs)))
        state = jkf.integration(state, integrate_frame=True,
                                force_integrate=(frame <= 3))
        if frame > 2:
            state = jkf.raycasting(state)
    return rows


def test_census_one_step_matches_jax(clip, jax_census, tmp_path):
    """From one checkpoint (written by the port, read by both packages)
    one tracking step each: per level the same executed count and the
    same convergence flag, coarsest first."""
    man, args, depths = clip
    kf = KFusion(*args, device=CPU)
    state = kf.init_state()
    for f in range(5):
        state = kf.process_frame(state, depths[f], f, integration_rate=1)
    state = kf.preprocessing(state, kf.to_device(depths[5]))
    path = str(tmp_path / "state.npz")
    save_state(path, state, 5)

    tstate, _ = load_state(path, CPU)
    _, counts, convs = kf.tracking(tstate, census=True)
    jstate, _ = jload(path)
    _, jcounts, jconvs = jax_census[1](jstate)
    assert counts.dtype == torch.int32 and convs.dtype == torch.bool
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(convs.numpy(), np.asarray(jconvs))
    # The census leaves the step alone: the same state as without it.
    plain = kf.tracking(tstate)
    counted, _, _ = kf.tracking(tstate, census=True)
    for name in ("pose", "reduction", "track_result", "tracked"):
        assert torch.equal(getattr(plain, name), getattr(counted, name))


def test_census_over_clip_within_one_iteration(clip, jax_census):
    """Frame by frame over the clip, each package running its own
    pipeline: every level's count within one iteration of JAX's (the
    +-1 FMA margin JAX's tool names)."""
    man, args, depths = clip
    rows = icp_census.census(KFusion(*args, device=CPU), depths)
    jrows = _jax_census(*jax_census, depths)
    assert [r[0] for r in rows] == [r[0] for r in jrows] == [4, 5, 6, 7]
    for (frame, c, _), (_, jc, _) in zip(rows, jrows):
        assert np.abs(c.astype(int) - jc.astype(int)).max() <= 1, \
            (frame, c, jc)
        assert (c >= 1).all() and (c <= np.array([4, 5, 10])).all()


def test_census_summary_counts_frozen_launches():
    rows = [(4, np.array([4, 3, 6]), np.array([False, True, True])),
            (5, np.array([2, 5, 10]), np.array([True, False, False]))]
    res = icp_census.summarize(rows, (10, 5, 4), (320, 240), 0.5)
    assert res["iterations_budget"] == [4, 5, 10]
    assert res["per_frame"] == {4: [4, 3, 6], 5: [2, 5, 10]}
    assert res["total_iters_mean"] == 15.0
    assert res["k2f_launches_per_frame"] == 19
    assert res["frozen_k2f_per_frame_mean"] == 4.0
    assert res["per_level"]["L2"]["budget_exhausted_pct"] == 50.0
    assert res["per_level"]["L0"]["mean"] == 8.0
    elems = 6 * (4 * 4800 + 3 * 19200 + 6 * 76800
                 + 2 * 4800 + 5 * 19200 + 10 * 76800) / 2
    assert res["gathered_elems_per_frame_mean"] == int(elems)
    assert res["tracking_floor_ms_at_rate"] == pytest.approx(
        elems * 0.5e-6)
    assert icp_census.G1_NS_PER_LOOKUP == pytest.approx(17.473e3 / 2 ** 21)


def test_icp_census_tool_on_cpu(clip, tmp_path, capsys):
    """The tool's entry point on the CPU over a clip it is given."""
    man, _, _ = clip
    out = str(tmp_path / "census.json")
    big = TS.generate_dataset(str(tmp_path / "clip"), CPU, n_frames=5,
                              image_size=(640, 480), dim=(4.8,) * 3,
                              amp=0.25, period=60)
    assert icp_census.main(["--device", "cpu", "--volume", "32",
                            "--frames", "5", "--raw", big["raw"],
                            "--json", out]) == 0
    with open(out) as f:
        res = json.load(f)
    assert res["device"] == "cpu" and res["frames"] == 1
    assert res["k2f_launches_per_frame"] == 19
    assert json.loads(capsys.readouterr().out) == res
    with pytest.raises(SystemExit):
        icp_census.main(["--device", "cpu", "--frames", "4"])
