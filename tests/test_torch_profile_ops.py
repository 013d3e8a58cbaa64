"""``tools/profile_frame.py``'s per-op rows on the CPU at 32^3 and
80x60: JAX's row names (``slambench_tpu/tools/profile_frame.py:
121-455``), JAX's byte accounts at that size, the tool's earlier keys
kept, null times ("not measured"), and the ``--trace`` directory."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch.tools import profile_frame  # noqa: E402

torch.set_num_threads(2)
V, W, H = 32, 80, 60
NPIX = W * H
GRID = "4x4x2"

# JAX's rows and their byte accounts (its frame is 640x480 uint16: here
# the frame's own size, read at ratio 1).
JAX_BYTES = {
    "mm2meters": H * W * 2 + NPIX * 4,
    "bilateral_filter": NPIX * 4 * 2,
    "track_reduce_L0": NPIX * 4 * 3 * 4,
    "tracking_phase": NPIX * 4 * 3 * 4 * 19,
    **{f"icp_gather6_L{lv}_per_iter": 6 * (H >> lv) * (W >> lv) * 4
       for lv in (0, 1, 2)},
    "tracking_prep_only": NPIX * 4 * 3 * 4,
    "update_pose_solve_per_iter": 0,
    "icp_full_iter_L0": 6 * NPIX * 4,
    "integrate": V ** 3 * 3 * 2,
    "integrate_plus_mip_fused": V ** 3 * 3 * 2,
    "make_min_mip": V ** 3 * 2 + (V // 8) * V * V * 2,
    "raycast_cold": 0,
    "raycast_warm": 0,
    "compute_frame_fused": 0,
    "gather_vol_random_76800": 0,
    "gather_vol_coherent_76800": 0,
    "gather_small_76800": 0,
    "gather_2m_session": 0,
    "gather_2m_coherent": 0,
}
JAX_SCALARS = ("session_gather_ns_per_elem",
               "session_gather_coherent_ns_per_elem", "device_eff_gbps")


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    """One run of the tool's main on the CPU, with a block grid (the
    per-frame integrate then differs from the graph route's) and
    ``--trace``."""
    tmp = tmp_path_factory.mktemp("profile_ops")
    out, trace_dir = str(tmp / "p.json"), str(tmp / "trace")
    mp = pytest.MonkeyPatch()
    mp.setenv("SLAMBENCH_INTEGRATE_BLOCKS", GRID)
    try:
        rc = profile_frame.main([
            "--device", "cpu", "--volume", str(V), "--image", f"{W}x{H}",
            "--ratio", "1", "--warmup", "4", "--frames", "1", "--reps", "1",
            "--trace", trace_dir, "--out", out])
    finally:
        mp.undo()
    assert rc == 0
    with open(out) as f:
        return json.load(f), trace_dir


def test_every_jax_row_is_present(result):
    r, _ = result
    missing = [k for k in (*JAX_BYTES, *JAX_SCALARS,
                           f"integrate_blocks_{GRID}_plus_mip",
                           "integrate_population", "trace_dir")
               if k not in r]
    assert not missing
    assert r["backend"] == "cpu" and r["volume"] == V
    assert r["mm2meters_bilateral"]["bytes"] == H * W * 2 + NPIX * 8
    assert (r["icp_full_iter_L0"]["reps"],
            r["update_pose_solve_per_iter"]["reps"]) == (16, 64)


@pytest.mark.parametrize("name", sorted(JAX_BYTES))
def test_jax_byte_accounts(result, name):
    row = result[0][name]
    assert row["bytes"] == JAX_BYTES[name]
    assert row["mb"] == round(JAX_BYTES[name] / 1e6, 1)


def test_times_are_null_on_the_cpu(result):
    r, _ = result
    for name in (*JAX_BYTES, "mm2meters_bilateral"):
        row = r[name]
        assert (row["ms"], row["gbps"], row["eager_ms"],
                row["host_bound"]) == (None, None, None, None), name
        assert row["reps"] >= 1 and row["route"]
    for key in JAX_SCALARS:
        assert r[key] is None
    assert r["hbm_peak_gbps"] == pytest.approx(3350.0)


def test_routes_name_the_split_dispatches(result):
    """Where the per-frame route reads the host, ``ms`` is the graph
    route's dispatch and ``eager_ms`` the per-frame one."""
    r, _ = result
    assert f"integrate_blocks {GRID}" in r["integrate"]["route"]
    assert "device gate" in r["integrate"]["route"]
    assert "early_exit=False" in r["raycast_cold"]["route"]
    assert "scan_step" in r["compute_frame_fused"]["route"]
    assert "compute_frame" in r["compute_frame_fused"]["route"]
    assert r["raycast_warm"]["warm_pool"] == 4     # 60 rows: no 8 pool


def test_earlier_keys_are_kept(result):
    r, _ = result
    for key in ("device", "volume", "compute_size", "frames", "tracked",
                "phase_ms", "device_busy_ms", "device_idle_share",
                "kernel_launches_per_frame", "htod_copies_per_frame",
                "hand_kernels_ms", "top_kernels_ms", "integrate_block_grid",
                "integrate_plus_mip"):
        assert key in r, key
    assert r["integrate_block_grid"] == [4, 4, 2]


def test_trace_writes_its_directory(result):
    r, trace_dir = result
    assert r["trace_dir"] == trace_dir
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0
