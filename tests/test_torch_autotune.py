"""The port's tuning and measurement tools on the CPU:
``tools/autotune.py`` (each sweep at toy sizes, its lines read by
``eval/check_kernels.py``), ``tools/march_census.py`` (per-ray counts
against the JAX tool's march logic on the same 64^3 volume),
``tools/probe_integrate.py`` (the "full" variant is ``integrate`` bit for
bit), and the integrate rows of ``tools/profile_frame.py`` as
``tools/scaling_report.py`` reads them."""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from slambench_tpu import geometry as JG  # noqa: E402
from slambench_tpu import params as jparams  # noqa: E402
from slambench_tpu import volume as JV  # noqa: E402
from slambench_tpu.ops import raycast_fast as jrf  # noqa: E402
from slambench_tpu.ops.integrate import integrate as j_integrate  # noqa: E402
from slambench_tpu.ops.preprocess import mm2meters  # noqa: E402
from slambench_tpu.ops.raycast import camera_rays as j_rays  # noqa: E402
from slambench_tpu.ops.raycast import ray_box_clip as j_clip  # noqa: E402
from slambench_tpu.volume import init_volume  # noqa: E402

from slambench_tpu_torch import geometry as G  # noqa: E402
from slambench_tpu_torch import params  # noqa: E402
from slambench_tpu_torch.eval.check_kernels import (  # noqa: E402
    aggregate_kernel_log,
)
from slambench_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticScene, orbit_trajectory, render_depth_frame,
)
from slambench_tpu_torch.ops import raycast_fast as rf  # noqa: E402
from slambench_tpu_torch.ops.integrate import integrate  # noqa: E402
from slambench_tpu_torch.tools import autotune, march_census  # noqa: E402
from slambench_tpu_torch.tools import (  # noqa: E402
    probe_integrate, scaling_report,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.mark.parametrize("sweep,values,want", [
    ("reduce", [128, 256], ["track_reduce[threads=128,plain,cpu]",
                            "track_reduce[threads=256,plain,cpu]"]),
    ("mip", [8, 16], ["raycast[mip_block=8,cpu]",
                      "raycast[mip_block=16,cpu]"]),
    ("refine", ["4:2", "2:2"], ["raycast[nscan=4,fp=2,cpu]",
                                "raycast[nscan=2,fp=2,cpu]"]),
    ("blocks", ["1x1x1", "8x8x2", "3x1x1"],
     ["integrate[blocks=1x1x1,cpu]", "integrate[blocks=8x8x2,cpu]"]),
])
def test_autotune_sweeps_print_check_kernels_lines(sweep, values, want):
    """Each sweep at a toy size (32^3, 10x320 pixels, one timed call):
    one ``name ns size`` line a value that divides the volume, read by
    ``eval/check_kernels.py``; the refine sweep's error is in voxels
    against its (10, 5) reference, the blocks sweep's visible share
    below 1 for 8x8x2."""
    out = io.StringIO()
    fn = getattr(autotune, f"sweep_{sweep}")
    size = 3200 if sweep == "reduce" else 32
    rows = fn(values, size, 1, CPU, out=out)
    agg = aggregate_kernel_log(out.getvalue().splitlines())
    assert sorted(agg) == sorted(want)
    assert all(v.size == 1 and v[0] > 0 for v in agg.values())
    assert len(rows) == len(want)
    if sweep == "refine":
        assert all(0 <= r[2] < 0.5 for r in rows)
    if sweep == "blocks":
        assert rows[0][2] == 1 and 0 < rows[1][2] < 1


def test_autotune_main_reports_the_best(capsys):
    assert autotune.main(["blocks", "--device", "cpu", "--resolution", "32",
                          "--iters", "1", "--values", "1x1x1,4x4"]) == 0
    captured = capsys.readouterr()
    assert captured.out.count("integrate[blocks=") == 2
    assert "# best: blocks=(" in captured.err and "cpu" in captured.err


@pytest.fixture(scope="module")
def volume():
    """A 64^3 / 4.8 m TSDF fused by JAX from two synthetic 80x60 frames
    (tests/test_torch_raycast.py's volume) and the view of a third."""
    dim = (4.8, 4.8, 4.8)
    k = (60.15, 60.0, 40.0, 30.0)
    poses = orbit_trajectory(6, [0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8])
    tsdf, weight = init_volume((64, 64, 64))
    K = JG.get_camera_matrix(jnp.asarray(k, jnp.float32))
    for i in (0, 3):
        mm = render_depth_frame(SyntheticScene(dim=dim), poses[i], k,
                                (80, 60), CPU)
        tsdf, weight = j_integrate(tsdf, weight, mm2meters(jnp.asarray(mm),
                                                           1),
                                   JG.rigid_inverse(jnp.asarray(poses[i])),
                                   K, 0.1, 100.0, dim)
    view = np.asarray(JG.mat4mul(jnp.asarray(poses[5]),
                                 JG.get_inverse_camera_matrix(
                                     jnp.asarray(k, jnp.float32))))
    return np.asarray(tsdf), dim, view, (60, 80)


def _jax_census(tsdf, mip, dim, view, image, step, large_step):
    """The per-ray counting march of slambench_tpu/tools/march_census.py
    (its ``march_count``), on JAX's own functions."""
    origin, direction = j_rays(view, image)
    tnear, tfar = j_clip(origin, direction, dim, jparams.NEAR_PLANE,
                         jparams.FAR_PLANE)
    sz, sy, sx = tsdf.shape
    o = origin.reshape(3, 1, 1)
    voxel = jnp.array([dim[0] / sx, dim[1] / sy, dim[2] / sz],
                      jnp.float32).reshape(3, 1, 1)
    flat_vol = tsdf.reshape(-1)
    flat_skip = jrf.make_skip_mip(mip).reshape(-1)
    mzb, myb, mxb = mip.shape
    limit = jnp.array([sx - 1, sy - 1, sz - 1], jnp.int32).reshape(3, 1, 1)
    m = jrf.MIP_BLOCK

    def voxel_idx(pos):
        return jnp.clip((pos / voxel).astype(jnp.int32), 0, limit)

    def nearest_t(t):
        idx = voxel_idx(o + direction * t[None])
        flat = (idx[2] * sy + idx[1]) * sx + idx[0]
        return JV.take_flat(flat_vol, flat).astype(jnp.float32) \
            * jparams.TSDF_INV_SCALE

    def dist_t(t):
        idx = voxel_idx(o + direction * t[None])
        b = idx // m
        return JV.take_flat(
            flat_skip, (jnp.clip(b[2], 0, mzb - 1) * myb
                        + jnp.clip(b[1], 0, myb - 1)) * mxb
            + jnp.clip(b[0], 0, mxb - 1)).astype(jnp.int32)

    def ball_exit(t, dv):
        pos = o + direction * t[None]
        b = (voxel_idx(pos) // m).astype(jnp.float32)
        r = (dv - 1).astype(jnp.float32)
        lo = (b - r) * (m * voxel)
        hi = (b + r + 1.0) * (m * voxel)
        dd = jnp.where(direction == 0, 1e-20, direction)
        ta = jnp.where(dd > 0, (hi - pos) / dd, (lo - pos) / dd)
        return t + jnp.maximum(jnp.minimum(jnp.minimum(ta[0], ta[1]), ta[2]),
                               0.0) + 0.25 * step

    @jax.jit
    def march_count():
        f0 = nearest_t(tnear)
        z = jnp.zeros(tnear.shape, jnp.int32)
        s = dict(t=tnear, stepsize=jnp.full_like(tnear, large_step),
                 done=~((tnear < tfar) & (f0 > 0)),
                 hit=jnp.zeros(tnear.shape, bool), iters=jnp.int32(0),
                 count=z, empty=z, fine=z, large=z)

        def body(s):
            live = ~s["done"]
            f_tt = nearest_t(s["t"])
            dv = dist_t(s["t"])
            empty = dv >= 1
            is_hit = live & ~empty & (f_tt < 0.0)
            new_step = jnp.where(f_tt < 0.8, step, s["stepsize"])
            t_step = s["t"] + new_step
            t_next = jnp.where(empty, jnp.maximum(ball_exit(s["t"], dv),
                                                  t_step), t_step)
            cont = live & ~is_hit
            t = jnp.where(cont, t_next, s["t"])
            return dict(
                t=t, stepsize=jnp.where(cont & ~empty, new_step,
                                        s["stepsize"]),
                done=s["done"] | is_hit | (cont & (t >= tfar)),
                hit=s["hit"] | is_hit, iters=s["iters"] + 1,
                count=s["count"] + live.astype(jnp.int32),
                empty=s["empty"] + (live & empty).astype(jnp.int32),
                fine=s["fine"] + (live & ~empty & (f_tt < 0.8))
                .astype(jnp.int32),
                large=s["large"] + (live & ~empty & (f_tt >= 0.8))
                .astype(jnp.int32))

        return jax.lax.while_loop(
            lambda s: jnp.any(~s["done"]) & (s["iters"] < 2000), body, s)

    return {k: np.asarray(v) for k, v in march_count().items()}


def test_march_census_counts_equal_jax(volume):
    """Per-ray counts (total and by step class) and hits equal the JAX
    tool's on the same volume and view, except on at most 2 rays (the
    hit-mismatch bound between the port's and JAX's fast raycast);
    ``raycast_fast``'s single-phase march runs the longest ray's count
    rounded up to whole unroll groups."""
    tsdf, dim, view, image = volume
    step, large_step = min(dim) / 64, 0.075
    want = _jax_census(jnp.asarray(tsdf), jrf.make_min_mip(jnp.asarray(tsdf)),
                       dim, jnp.asarray(view), image, step, large_step)
    t = torch.from_numpy(tsdf)
    mip = rf.make_min_mip(t)
    got = march_census.march_census(t, mip, dim, torch.from_numpy(view),
                                    image, step, large_step)
    got = {k: v.numpy() for k, v in got.items()}
    differ = np.zeros(got["count"].shape, bool)
    for key in ("count", "empty", "fine", "large", "hit"):
        differ |= got[key] != want[key]
    assert differ.sum() <= 2
    assert got["hit"].sum() > 100 and got["count"].max() > 10
    rf.reset_counters()
    rf.raycast_fast(t, mip, dim, torch.from_numpy(view), image,
                    params.NEAR_PLANE, params.FAR_PLANE, step, large_step,
                    compact=False)
    assert rf.march_substeps == -(-int(got["count"].max()) // 4) * 4
    res = march_census.summarize(got, image[0] * image[1],
                                 rf.march_budgets(dim, t.shape, step,
                                                  large_step,
                                                  params.NEAR_PLANE,
                                                  params.FAR_PLANE), 8)
    assert res["max"] == got["count"].max()
    assert res["live_after_phase1"] == int((got["count"] > 24).sum())
    assert res["slots"] == 512                  # 4800 rays / 8, in 128s
    assert sum(res["class_pct"].values()) == pytest.approx(100, abs=0.2)


def test_probe_integrate_full_variant_is_integrate():
    tsdf, w8, depth, M, K = probe_integrate.inputs(32, 24, 32, 0, CPU)
    # A camera inside the volume, so that voxels are updated.
    M = G.rigid_inverse(G.translation_pose([2.4, 2.4, 0.2], CPU))
    got = probe_integrate.integ(tsdf, w8, depth, M, K)
    want = integrate(tsdf, w8, depth, M, K, probe_integrate.MU,
                     params.MAX_WEIGHT, probe_integrate.DIM)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[1] > 0).sum() > 10
    for name, fn in probe_integrate.VARIANTS.items():
        t, w = fn(tsdf, w8, depth, M, K)
        assert t.shape == tsdf.shape and w.shape == w8.shape, name
    ms = probe_integrate.probe(16, 12, 16, 1, 0, CPU)
    assert sorted(ms) == sorted(probe_integrate.VARIANTS)


def test_scaling_report_prefers_the_block_row():
    profile = {"phase_ms": {"preprocessing": 1.0, "tracking": 10.0,
                            "integration": 8.0, "raycasting": 4.0},
               "integrate_plus_mip": {"ms": 6.0},
               "integrate_blocks_8x8x2_plus_mip": {"ms": 2.0}}
    assert scaling_report.integration_ms(profile) == 2.0
    rows = scaling_report.project_scaling(profile, ns=(1,))
    assert rows[0]["t_frame_ms"] == pytest.approx(1.0 + 10.0 + 2.0 + 4.0)
    profile["integrate_blocks_8x8x2_plus_mip"] = {"ms": None}   # CPU run
    assert scaling_report.integration_ms(profile) == 8.0


def test_profile_frame_integrate_rows(monkeypatch, tmp_path):
    """With a block grid, ``tools/profile_frame.py:op_rows`` adds JAX's
    ``integrate_blocks_<grid>_plus_mip`` row and the live-voxel count
    beside the monolithic row; their times are null on the CPU."""
    from slambench_tpu_torch.tools.profile_frame import clip_state, op_rows
    monkeypatch.setenv("SLAMBENCH_INTEGRATE_BLOCKS", "4x4x2")
    kf, state, depths, _ = clip_state(CPU, 32, (32, 24), 1, 2, 0,
                                      str(tmp_path))
    rows = op_rows(kf, state, depths[1], 1)
    assert rows["integrate_plus_mip"] == {"ms": None}
    assert rows["integrate_blocks_4x4x2_plus_mip"] == {"ms": None}
    pop = rows["integrate_population"]
    assert pop["total_blocks"] == 32 and pop["total_voxels"] == 32 ** 3
    assert pop["live_voxels"] == pop["live_blocks"] * 32 ** 3 // 32
