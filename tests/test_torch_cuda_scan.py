"""The batched frame routes on a CUDA card: ``KFusion.compute_frames_scan``
as replays of a CUDA graph of one gate period (``graphs.py``).

* at 64^3 the replays equal the eager ``scan_step`` bit for bit over 10
  frames (every state leaf and every output), and the graph's launch
  tally is K1F once and K2F 19 times a frame; also over 4 frames on the
  oracle march with the cv start and with the warm start;
* K2F's ticket is back at 0 after 50 replays, whose state still equals
  the eager steps';
* one eager ``scan_step`` makes no host read (``set_sync_debug_mode``);
* KERNEL_TIMINGS spans are refused, and a capture that fails raises (no
  quiet eager fallback; in a process of its own).

Imports torch and the port only, so it runs on the card's machine with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_scan.py -m cuda

Without a card every test skips."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.io.synthetic import generate_dataset  # noqa: E402
from slambench_tpu_torch.ops.hopper import reduce  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion, frame_gates  # noqa: E402
from slambench_tpu_torch.policy import apply_precision_policy  # noqa: E402

pytestmark = pytest.mark.cuda
PYRAMID = (10, 5, 4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    apply_precision_policy()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def clip(dev, tmp_path_factory):
    """The 160x120 orbit at 64^3: the state after 5 boot frames and the
    next 10 frames as one int32 tensor on the card."""
    out = str(tmp_path_factory.mktemp("synth_cuda_scan"))
    man = generate_dataset(out, dev, n_frames=15, image_size=(160, 120),
                           amp=0.12)
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    args = (man["image_size"], (64,) * 3, man["dim"], init, PYRAMID,
            man["camera"])
    rd = RawDepthReader(man["raw"])
    frames = [rd.read_next_depth_frame() for _ in range(15)]
    kf = KFusion(*args, device=dev)
    state = kf.init_state()
    for f in range(5):
        state = kf.compute_frame(state, kf.to_device(frames[f]),
                                 **frame_gates(f, 1, 1))
    assert bool(state.tracked)
    return {"args": args, "boot": state,
            "frames": kf.to_device(np.stack(frames[5:]))}


def _eager(kf, state, frames):
    rows = []
    for depth in frames:
        state = kf.scan_step(state, depth)
        rows.append(torch.cat([state.pose[:3, 3],
                               state.tracked.float().reshape(1),
                               state.integrated.float().reshape(1)]))
    return state, torch.stack(rows)


def _assert_states_equal(got, want):
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), field.name


def test_replays_equal_eager_scan_step(clip, dev):
    frames = clip["frames"]
    want_state, want_rows = _eager(KFusion(*clip["args"], device=dev),
                                   clip["boot"], frames)
    kf = KFusion(*clip["args"], device=dev)
    got_state, outs = kf.compute_frames_scan(clip["boot"], frames)
    torch.cuda.synchronize()
    _assert_states_equal(got_state, want_state)
    assert torch.equal(outs["pos"].view(torch.int32),
                       want_rows[:, :3].contiguous().view(torch.int32))
    assert torch.equal(outs["tracked"], want_rows[:, 3] != 0)
    assert torch.equal(outs["integrated"], want_rows[:, 4] != 0)
    assert outs["tracked"].all()
    n = frames.shape[0]
    assert kf.graphs.launches == {"K1F": n, "K2F": sum(PYRAMID) * n}
    (capture,) = kf.graphs.captures
    assert capture["launches"] == {"K1F": 1, "K2F": sum(PYRAMID)}
    # The caller's state is not the graph's: a second batch from the
    # same boot state replays to the same result.
    again, _ = kf.compute_frames_scan(clip["boot"], frames)
    _assert_states_equal(again, want_state)


@pytest.mark.parametrize("kw,warm", [
    ({"backend": "jnp", "motion_model": "cv"}, "0"), ({}, "1")])
def test_replays_equal_eager_on_other_routes(clip, dev, monkeypatch, kw,
                                             warm):
    """The oracle march with the cv start, and the min-mip march with
    the warm start (``SLAMBENCH_WARM_START=1``), replayed over 4 frames."""
    monkeypatch.setenv("SLAMBENCH_WARM_START", warm)
    frames = clip["frames"][:4]
    kf = KFusion(*clip["args"], device=dev, **kw)
    assert kf.warm_start == (warm == "1")
    want_state, want_rows = _eager(kf, clip["boot"], frames)
    got_state, outs = kf.compute_frames_scan(clip["boot"], frames)
    torch.cuda.synchronize()
    _assert_states_equal(got_state, want_state)
    assert torch.equal(outs["pos"], want_rows[:, :3])
    assert kf.graphs.launches == {"K1F": 4, "K2F": sum(PYRAMID) * 4}


def test_k2f_ticket_resets_across_50_replays(clip, dev):
    frames = clip["frames"].repeat(5, 1, 1)            # 50 frames
    kf = KFusion(*clip["args"], device=dev)
    got_state, _ = kf.compute_frames_scan(clip["boot"], frames)
    torch.cuda.synchronize()
    partials, ticket = reduce._scratch[(frames.device,
                                        kf.graphs._stream.cuda_stream)]
    assert int(ticket.item()) == 0
    assert kf.graphs.launches["K2F"] == 50 * sum(PYRAMID)
    want_state, _ = _eager(KFusion(*clip["args"], device=dev), clip["boot"],
                           frames)
    _assert_states_equal(got_state, want_state)


def test_scan_step_makes_no_host_read(clip, dev):
    kf = KFusion(*clip["args"], device=dev)
    state = kf.scan_step(clip["boot"], clip["frames"][0])     # warm caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for gates in ({}, {"integrate_frame": False}):
            state = kf.scan_step(state, clip["frames"][1], **gates)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(state.pose).all())


def test_spans_are_refused(clip, dev):
    kf = KFusion(*clip["args"], device=dev)
    kf.timings.enabled = True
    with pytest.raises(RuntimeError, match="KERNEL_TIMINGS"):
        kf.compute_frames_scan(clip["boot"], clip["frames"][:1])


# A step that reads the host is fine eagerly (the warm-up) but not under
# capture. Run in a process of its own: a failed capture leaves
# PyTorch's CUDA generator registered with the dead graph, and a later
# torch.rand on the card in the same process then raises.
FAILED_CAPTURE = """
import torch
from slambench_tpu_torch.pipeline import KFusion
dev = torch.device("cuda", 0)
kf = KFusion((160, 120), (64,) * 3, (4.8,) * 3, (1.6, 2.4, 1.2), (10, 5, 4),
             (120.3, 120.0, 80.0, 60.0), device=dev)
step = kf.scan_step

def reading_step(state, depth, **gates):
    state = step(state, depth, **gates)
    bool(state.tracked)
    return state

kf.scan_step = reading_step
depths = torch.full((2, 120, 160), 1500, dtype=torch.int32, device=dev)
try:
    kf.compute_frames_scan(kf.init_state(), depths)
except RuntimeError as exc:
    assert kf.graphs.launches == {"K1F": 0, "K2F": 0}
    print("raised:", str(exc).splitlines()[0])
else:
    print("no error")
"""


def test_failed_capture_raises(dev):
    """The route raises and does not fall back to the eager step."""
    out = subprocess.run([sys.executable, "-c", FAILED_CAPTURE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised: CUDA graph capture of the frame "
                                 "step failed"), out.stdout
