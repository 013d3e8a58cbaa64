"""The port's CLI keyframe routes on the CPU: ``--keyframes``,
``--keyframes --ba`` and ``--ba`` (which implies ``--keyframes``) write
the raw and corrected TUM trajectories next to the log
(test_keyframes_e2e.py::test_frontend_keyframes_flag and
test_ba_frontend.py::test_frontend_ba_flag on the port), and a resumed
run starts with an empty graph."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch.eval.trajectory import read_tum  # noqa: E402
from slambench_tpu_torch.frontend import benchmark  # noqa: E402
from slambench_tpu_torch.io.synthetic import generate_dataset  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def short_clip(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("kf_cli")), CPU,
                            n_frames=14, image_size=(160, 120),
                            dim=(4.8,) * 3, amp=0.3, period=12)


@pytest.mark.parametrize("flags", [["--keyframes"], ["--keyframes", "--ba"],
                                   ["--ba"]])
def test_cli_keyframe_routes(short_clip, tmp_path, flags, capsys,
                             monkeypatch):
    """``main`` with the keyframe flags on 14 frames at 32^3: both TUM
    files written with a row a frame and read back, the graph line on
    stderr, and the summary's wrapper on the flags' backend."""
    summaries = []

    def keep(*args, **kwargs):
        summaries.append(run(*args, **kwargs))
        return summaries[-1]

    run = benchmark.run
    monkeypatch.setattr(benchmark, "run", keep)
    log = str(tmp_path / "kf.log")
    args = ["-i", short_clip["raw"], "-o", log, "-v", "32", "-s", "4.8",
            "-p", "0.34,0.5,0.24", "-y", "4,3,3", "-k", "120.3,120.0,80,60"]
    assert benchmark.main(["--device", "cpu", *flags, *args]) == 0
    assert "keyframes: " in capsys.readouterr().err
    summary, = summaries
    assert summary["frames"] == 14
    pg = summary["posegraph"]
    assert pg.backend == ("posegraph" if flags == ["--keyframes"] else "ba")
    assert len(pg.store.keyframes) >= 1
    raw = read_tum(log + ".kf_raw.tum")
    corr = read_tum(log + ".kf_corrected.tum")
    assert raw.shape == corr.shape == (14, 3)
    # Corrections are rigid adjustments of a working odometry: the two
    # exports stay within centimetres of each other on a short clip.
    assert np.abs(raw - corr).max() < 0.2


def test_resume_starts_an_empty_graph(short_clip, tmp_path):
    """``--checkpoint`` saves the frame state and not the graph: the
    resumed ``--keyframes`` run builds its graph from its own frames and
    writes a row for each of them."""
    args = ["-i", short_clip["raw"], "-v", "32", "-s", "4.8",
            "-p", "0.34,0.5,0.24", "-y", "4,3,3", "-k", "120.3,120.0,80,60"]
    ck = str(tmp_path / "s.npz")
    first = benchmark.run(benchmark.parse_args(
        [*args, "-o", str(tmp_path / "a.log"), "--checkpoint", ck]), CPU,
        max_frames=8, quiet=True, keyframes=True)
    log = str(tmp_path / "b.log")
    rest = benchmark.run(benchmark.parse_args([*args, "-o", log,
                                               "--resume", ck]),
                         CPU, quiet=True, keyframes=True)
    assert first["frames"] == 8 and rest["frames"] == 6
    pg = rest["posegraph"]
    assert len(pg._trajectory) == 6
    assert {kf.frame for kf in pg.store.keyframes} <= set(range(8, 14))
    assert read_tum(log + ".kf_raw.tum").shape == (6, 3)


def test_keyframe_demo_prints_one_json_line(tmp_path, capsys):
    """``tools/keyframe_demo.py`` on the CPU at a tiny size: one JSON
    line with both ATE-RMSE values and the graph's counts."""
    import json
    from slambench_tpu_torch.tools import keyframe_demo
    assert keyframe_demo.main(["--device", "cpu", "--frames", "8",
                               "--volume", "32", "--out",
                               str(tmp_path / "demo")]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == 8 and line["device"] == "cpu"
    assert line["keyframes"] >= 1 and line["ate_rmse_raw_m"] > 0
    assert np.isfinite(line["ate_rmse_corrected_m"])


def test_keyframe_demo_default_out_is_a_new_temp_dir(tmp_path, capsys,
                                                     monkeypatch):
    """Without ``--out`` the demo writes into a new directory under the
    temporary directory (``$TMPDIR``) and names it in the JSON line."""
    import json
    import tempfile
    from slambench_tpu_torch.tools import keyframe_demo
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert keyframe_demo.main(["--device", "cpu", "--frames", "6",
                               "--volume", "32"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["out"].startswith(str(tmp_path / "slambench_kf_demo_"))
    assert line["log"] == str(tmp_path / line["out"] / "kf_demo.log")
    assert (tmp_path / line["out"] / "kf_demo.log.kf_raw.tum").is_file()


def test_keyframe_spans_under_kernel_timings(tmp_path, capsys, monkeypatch):
    """With KERNEL_TIMINGS set, ``--keyframes --ba`` logs one
    ``loopClosureAlign`` span a verified candidate, and one ``poseGraph``
    and one ``bundleAdjust`` span an optimization (every 5 keyframes);
    the check_kernels aggregator reads them beside the frame's rows. Two
    laps of 12 frames give loop candidates and two optimizations."""
    from slambench_tpu_torch.eval.check_kernels import aggregate_kernel_log
    clip = generate_dataset(str(tmp_path / "laps"), CPU, n_frames=24,
                            image_size=(160, 120), dim=(4.8,) * 3, amp=0.3,
                            period=12)
    summaries = []

    def keep(*args, **kwargs):
        summaries.append(run(*args, **kwargs))
        return summaries[-1]

    run = benchmark.run
    monkeypatch.setattr(benchmark, "run", keep)
    monkeypatch.setenv("KERNEL_TIMINGS", "1")
    args = ["-i", clip["raw"], "-o", str(tmp_path / "t.log"), "-v",
            "32", "-s", "4.8", "-p", "0.34,0.5,0.24", "-y", "4,3,3", "-k",
            "120.3,120.0,80,60", "--keyframes", "--ba"]
    assert benchmark.main(["--device", "cpu", *args]) == 0
    agg = aggregate_kernel_log(capsys.readouterr().err.splitlines())
    pg = summaries[0]["posegraph"]
    n_opt = len(pg.store.keyframes) // pg.optimize_every
    assert n_opt >= 1 and pg.alignments >= 1
    assert len(agg.get("loopClosureAlign", ())) == pg.alignments
    assert len(agg.get("poseGraph", ())) == n_opt
    assert len(agg.get("bundleAdjust", ())) == n_opt
    assert "track+reduce" in agg and "integrate" in agg
    for name in ("loopClosureAlign", "poseGraph", "bundleAdjust"):
        assert (agg.get(name, np.ones(1)) > 0).all()
