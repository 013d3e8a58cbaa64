"""Port parity for the rate-gated batched route: the port's
``compute_frames_scan_rated`` against JAX's at ``-r 2`` (gate period 2),
in JAX's contract (tests/test_pipeline_e2e.py:214-258): positions within
1e-4 m, ``integrated`` alternating exactly as JAX's, under 2% of voxels
differ at all and under 1e-4 by more than 2 LSB. A file of its own: the
JAX route's trace and compile take most of a minute on the CPU.

Sizes as in test_torch_scan.py (32^3, 80x60, 5 boot frames, then two
2-frame periods starting at frame 5, phase 1) but for the pyramid: two
levels (3, 2), since JAX traces and compiles each level's ICP loop once
per frame of the period, and at 3,2,2 this file took 72 s on one CPU
worker against 46 s at 3,2."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slambench_tpu.pipeline import KFusion as JKFusion  # noqa: E402
from slambench_tpu.pipeline import KFusionState as JState  # noqa: E402

from slambench_tpu_torch import convert  # noqa: E402
from slambench_tpu_torch.io.readers import RawDepthReader  # noqa: E402
from slambench_tpu_torch.io.synthetic import generate_dataset  # noqa: E402
from slambench_tpu_torch.pipeline import KFusion, frame_gates  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
BOOT = 5


def test_rated_scan_matches_jax_rated_scan(tmp_path):
    man = generate_dataset(str(tmp_path), CPU, n_frames=BOOT + 4,
                           image_size=(80, 60), dim=(4.8,) * 3, amp=0.12)
    rd = RawDepthReader(man["raw"])
    frames = np.stack([np.ascontiguousarray(rd.read_next_depth_frame())
                       for _ in range(BOOT + 4)])
    init = [f * d for f, d in zip(man["init_pos_factor"], man["dim"])]
    args = (man["image_size"], (32,) * 3, man["dim"], init, (3, 2),
            man["camera"])
    kf = KFusion(*args, device=CPU)
    state = kf.init_state()
    for f in range(BOOT):
        state = kf.compute_frame(state, kf.to_device(frames[f]),
                                 **frame_gates(f, 1, 2))
    boot = convert.state_to_numpy(state)
    blocks = frames[BOOT:].reshape(2, 2, *frames.shape[1:])
    rates = dict(tracking_rate=1, integration_rate=2, phase=BOOT % 2)

    jkf = JKFusion(*args, backend="fast")
    js, jouts = jkf.compute_frames_scan_rated(
        JState(**{k: jnp.asarray(v) for k, v in boot.items()}),
        jnp.asarray(blocks), **rates)
    ts, touts = kf.compute_frames_scan_rated(
        convert.state_from_numpy(boot, CPU), blocks, **rates)

    assert touts["pos"].shape == (4, 3)
    np.testing.assert_allclose(touts["pos"].numpy(),
                               np.asarray(jouts["pos"]), atol=1e-4)
    integrated = touts["integrated"].numpy()
    np.testing.assert_array_equal(integrated, np.asarray(jouts["integrated"]))
    np.testing.assert_array_equal(integrated, [False, True, False, True])
    np.testing.assert_array_equal(touts["tracked"].numpy(),
                                  np.asarray(jouts["tracked"]))
    d = np.abs(ts.tsdf.numpy().astype(np.int32)
               - np.asarray(js.tsdf, np.int32))
    assert (d > 0).mean() < 0.02, f"{(d > 0).mean():.4f} voxels differ"
    assert (d > 2).mean() < 1e-4, f"{(d > 2).sum()} voxels beyond 2 LSB"
    with pytest.raises(ValueError, match="gate period 2"):
        kf.compute_frames_scan_rated(ts, blocks[:, :1], **rates)
