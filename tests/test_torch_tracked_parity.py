"""The phased CLI's ``tracked`` column with ``-t 2``: the port's against
JAX's on the same input.

JAX's phased CLI leaves the state alone on a frame that the tracking
rate skips (``slambench_tpu/frontend/benchmark.py``), so that frame's row
repeats the ``tracked`` of the frame before it. The port's must log the
same column, and ``--break-on-untracked`` must then stop (or not) where
JAX's column says: on this clip every frame past the bootstrap is
tracked, so the run goes through all 10 frames. The JAX run is the slow
part (~30 s on the CPU), so it runs once per module."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu.config import parse_args as j_parse_args  # noqa: E402
from slambench_tpu.eval.check_pos import (  # noqa: E402
    parse_benchmark_log as j_parse_log,
)
from slambench_tpu.frontend.benchmark import run as j_run  # noqa: E402

from slambench_tpu_torch.config import parse_args  # noqa: E402
from slambench_tpu_torch.eval.check_pos import parse_benchmark_log  # noqa: E402
from slambench_tpu_torch.frontend.benchmark import run  # noqa: E402
from slambench_tpu_torch.io.synthetic import generate_dataset  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
FRAMES = 10


def _argv(raw: str, log: str):
    return ["-i", raw, "-o", log, "-v", "64", "-s", "4.8",
            "-p", "0.34,0.5,0.24", "-c", "1", "-r", "1", "-t", "2",
            "-z", "8", "-k", "120.3,120.0,80,60"]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """One port-generated clip (160x120, 10 frames) through JAX's phased
    CLI; returns the clip's path, the work directory and JAX's column."""
    work = tmp_path_factory.mktemp("tracked_parity")
    man = generate_dataset(str(work), CPU, n_frames=FRAMES,
                           image_size=(160, 120), dim=(4.8,) * 3, amp=0.12)
    log = str(work / "jax.log")
    summary = j_run(j_parse_args(_argv(man["raw"], log)),
                    max_frames=FRAMES, quiet=True)
    assert summary["frames"] == FRAMES
    return man["raw"], work, j_parse_log(log)["tracked"].astype(int)


def test_tracked_column_equals_jax(clip):
    raw, work, want = clip
    log = str(work / "port.log")
    run(parse_args(_argv(raw, log)), CPU, max_frames=FRAMES, quiet=True)
    got = parse_benchmark_log(log)["tracked"].astype(int)
    np.testing.assert_array_equal(got, want)
    # A skipped (odd) frame repeats the even frame before it.
    np.testing.assert_array_equal(got[1::2], got[0::2])


def test_break_on_untracked_stops_where_jax_column_says(clip):
    raw, work, want = clip
    past_boot = np.flatnonzero((np.arange(FRAMES) > 3) & (want == 0))
    frames = int(past_boot[0]) + 1 if past_boot.size else FRAMES
    assert frames == FRAMES, want        # this clip tracks throughout
    log = str(work / "port_break.log")
    summary = run(parse_args(_argv(raw, log)), CPU, max_frames=FRAMES,
                  quiet=True, break_on_untracked=True)
    assert summary["frames"] == frames
    assert len(parse_benchmark_log(log)["tracked"]) == frames
