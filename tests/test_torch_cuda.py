"""The port on a CUDA card: kernels K1, K1F (mm2meters fused into K1),
K2 and K2F (track fused into K2, both at every threads-a-block count)
against their plain twins at the main path's shapes, one ICP level with no host read, mm2meters as IEEE
division, G1-G4 against their twins at the gather probes' shapes and on
the edge cases of the redesigned kernels (out-of-range indices as the
Pallas bodies treat them, G4's two routes), and short end-to-end runs
through the CLI (production, and the KERNEL_TIMINGS route with K1 and
K2).

Imports torch and the port only (no JAX), so it runs on the card's
machine, where JAX is absent, with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Without a card every test skips."""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slambench_tpu_torch import geometry as G  # noqa: E402
from slambench_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticScene, generate_dataset, orbit_trajectory, render_depth_frame,
)
from slambench_tpu_torch.ops.hopper import bilateral, build, gather, reduce  # noqa: E402
from slambench_tpu_torch.ops.preprocess import (  # noqa: E402
    half_sample_robust, make_gaussian, mm2meters,
)
from slambench_tpu_torch.ops import render  # noqa: E402
from slambench_tpu_torch.ops.raycast_fast import make_min_mip  # noqa: E402
from slambench_tpu_torch.ops.solve import update_pose  # noqa: E402
from slambench_tpu_torch.pipeline import cv_predict  # noqa: E402
from slambench_tpu_torch.ops.track import track  # noqa: E402
from slambench_tpu_torch.ops.vertex import depth2vertex, vertex2normal  # noqa: E402
from slambench_tpu_torch.policy import apply_precision_policy  # noqa: E402
from slambench_tpu_torch.tools.gather_probe import equal_nan  # noqa: E402
from slambench_tpu_torch.tools.mosaic_probe import K1_TOL  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    apply_precision_policy()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def frame_mm(dev):
    """A synthetic 640x480 int32 millimetre frame."""
    poses = orbit_trajectory(12, [0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8])
    mm = render_depth_frame(SyntheticScene(), poses[11],
                            (481.2, 480.0, 320.0, 240.0), (640, 480), dev)
    return torch.from_numpy(mm.astype(np.int32)).to(dev)


@pytest.fixture(scope="module")
def frame(frame_mm):
    """The frame at compute-size ratio 2: 240x320 metres."""
    return mm2meters(frame_mm, 2).contiguous()


def test_bilateral_kernel_matches_plain(frame):
    g = make_gaussian()
    before = bilateral.launches
    got = bilateral.bilateral_filter_cuda(frame, g)
    assert bilateral.launches == before + 1
    torch.testing.assert_close(got, bilateral.plain(frame, g),
                               equal_nan=True, **K1_TOL)


def _ieee_metres(mm: torch.Tensor, ratio: int) -> np.ndarray:
    return mm.cpu().numpy()[::ratio, ::ratio].astype(np.float32) \
        / np.float32(1000)


def _check_k1f(mm: torch.Tensor, ratio: int):
    """K1F on ``mm``: one launch; metres bit for bit numpy's division;
    the filtered depth within K1_TOL of the twin; two calls bit for bit."""
    g = make_gaussian()
    before = bilateral.fused_launches
    fd, sd = bilateral.mm2m_bilateral_cuda(mm, ratio, g)
    assert bilateral.fused_launches == before + 1
    want = _ieee_metres(mm, ratio)
    assert fd.shape == sd.shape == want.shape
    np.testing.assert_array_equal(fd.cpu().numpy().view(np.uint32),
                                  want.view(np.uint32))
    want_fd, want_sd = bilateral.mm2m_bilateral_plain(mm, ratio, g)
    assert torch.equal(fd, want_fd)
    torch.testing.assert_close(sd, want_sd, equal_nan=True, **K1_TOL)
    fd2, sd2 = bilateral.mm2m_bilateral_cuda(mm, ratio, g)
    assert torch.equal(fd, fd2)
    assert np.array_equal(sd.cpu().numpy().view(np.uint32),
                          sd2.cpu().numpy().view(np.uint32))


def test_k1f_matches_twin_on_the_frame(frame_mm, frame):
    """240x320 from the 640x480 frame, the main path's shape."""
    _check_k1f(frame_mm, 2)
    fd, _ = bilateral.mm2m_bilateral_cuda(frame_mm, 2, make_gaussian())
    assert torch.equal(fd, frame)


@pytest.mark.parametrize("ratio", [1, 2, 4])
@pytest.mark.parametrize("out_shape", [(1, 1), (13, 17), (241, 321),
                                       (8, 32), (9, 33)])
def test_k1f_ragged_outputs(dev, out_shape, ratio):
    """Ragged output sizes (a single pixel, odd, one past a tile, exactly
    one 8x32 tile and one past it) from inputs that ratio does not
    divide, with zero holes and values up to 65,535."""
    h, w = out_shape
    rng = np.random.default_rng(h * 1000 + w * 10 + ratio)
    shape = (h * ratio - ratio // 2, w * ratio - ratio // 2)
    mm = rng.integers(300, 5000, shape)
    mm[rng.random(shape) < 0.1] = 0
    mm[rng.random(shape) < 0.02] = 65535
    _check_k1f(torch.from_numpy(mm.astype(np.int32)).to(dev), ratio)


def test_k1f_every_uint16_value(dev):
    mm = torch.arange(65536, dtype=torch.int32, device=dev).reshape(256, 256)
    _check_k1f(mm, 1)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_reduce_kernel_matches_plain(frame, dev, level):
    data = track(*_level_maps(frame, dev, level))
    before = reduce.launches
    got = reduce.reduce_track_cuda(data)
    assert reduce.launches == before + 1
    torch.testing.assert_close(got, reduce.plain(data), rtol=1e-4, atol=1e-3)
    assert int(got[28]) > 0


def test_reduce_kernel_ragged_and_random_codes(dev):
    rng = np.random.default_rng(0)
    for h, w in ((13, 17), (240, 320)):
        data = {"result": rng.choice([1, -1, -2, -3, -4, -5], size=(h, w))
                .astype(np.int32),
                "error": rng.standard_normal((h, w)).astype(np.float32),
                "J": rng.standard_normal((6, h, w)).astype(np.float32)}
        data = {k: torch.from_numpy(a).to(dev) for k, a in data.items()}
        got = reduce.reduce_track_cuda(data)
        torch.testing.assert_close(got, reduce.plain(data), rtol=1e-4,
                                   atol=1e-3)
        # One launch, partials summed in block order: the same bits.
        assert torch.equal(got, reduce.reduce_track_cuda(data))


def _level_maps(frame, dev, level):
    """(level vertex, level normal, reference vertex, reference normal,
    pose, view): a pyramid level against the full-size maps of the same
    frame under a small pose offset, as the ICP loop sees them."""
    k = torch.tensor([240.6, 240.0, 160.0, 120.0], device=dev)
    d = bilateral.plain(frame, make_gaussian())
    pyr = [d]
    for _ in range(level):
        pyr.append(half_sample_robust(pyr[-1], 0.3, 1))
    ref_v = depth2vertex(d, G.get_inverse_camera_matrix(k))
    v = depth2vertex(pyr[-1], G.get_inverse_camera_matrix(k / (1 << level)))
    pose = G.se3_exp(torch.tensor([0.01, -0.005, 0.008, 0.004, -0.003,
                                   0.002], device=dev))
    return [v, vertex2normal(v), ref_v, vertex2normal(ref_v), pose,
            G.get_camera_matrix(k)]


@pytest.mark.parametrize("level", [0, 1, 2, "ragged", "holes"])
def test_fused_kernel_matches_twin(frame, dev, level):
    """240x320, 120x160, 60x80, a 13x17 cut of level 0, and level 0 with
    stripes of no input (-1) and no reference normal (-3): the same
    result codes, the reduction within K2's tolerance, and two calls
    bit for bit."""
    args = _level_maps(frame, dev, level if isinstance(level, int) else 0)
    if level == "ragged":
        args[:2] = [a[:, 100:113, 150:167].contiguous() for a in args[:2]]
    if level == "holes":
        args[1], args[3] = args[1].clone(), args[3].clone()
        args[1][0, 40:60] = -2.0
        args[3][0, 120:140] = -2.0
    before = reduce.fused_launches
    got, res = reduce.track_reduce_cuda(*args)
    assert reduce.fused_launches == before + 1
    want, want_res = reduce.track_reduce_plain(*args)
    assert torch.equal(res, want_res)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    got2, res2 = reduce.track_reduce_cuda(*args)
    assert torch.equal(got, got2) and torch.equal(res, res2)
    assert int(got[28]) > 0


@pytest.mark.parametrize("threads", [128, 256, 512, 1024])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_k2_and_k2f_at_every_threads_count(frame, dev, level, threads):
    """K2F and K2 instantiated at 128-1024 threads a block: the twin's
    result codes, the reductions within K2's tolerance (another grid
    sums in another order), two calls bit for bit; at 256 the default
    launch's bits."""
    args = _level_maps(frame, dev, level)
    got, res = reduce.track_reduce_cuda(*args, threads=threads)
    want, want_res = reduce.track_reduce_plain(*args)
    assert torch.equal(res, want_res)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    got2, res2 = reduce.track_reduce_cuda(*args, threads=threads)
    assert torch.equal(got, got2) and torch.equal(res, res2)
    data = track(*args)
    red = reduce.reduce_track_cuda(data, threads=threads)
    torch.testing.assert_close(red, reduce.plain(data), rtol=1e-4,
                               atol=1e-3)
    if threads == 256:
        assert torch.equal(got, reduce.track_reduce_cuda(*args)[0])
        assert torch.equal(red, reduce.reduce_track_cuda(data))


def test_k2f_refuses_other_threads_counts(frame, dev):
    args = _level_maps(frame, dev, 2)
    with pytest.raises(ValueError, match="threads"):
        reduce.track_reduce_cuda(*args, threads=64)


def test_fused_kernel_no_input_level(frame, dev):
    v, n, rv, rn, pose, view = _level_maps(frame, dev, 2)
    got, res = reduce.track_reduce_cuda(v, torch.full_like(n, -2.0), rv, rn,
                                        pose, view)
    want = torch.zeros(32, device=dev)
    want[31] = res.numel()
    assert (res == -1).all() and torch.equal(got, want)


def _icp_level_under_sync_error(frame, dev, motion_model="none"):
    """One level of KFusion.tracking's ICP loop (fused data term, pose
    update, freeze on convergence), five iterations, under sync debug
    mode "error": a host read or a synchronising copy there raises. With
    ``motion_model="cv"`` the level starts from ``cv_predict`` of the
    pose and a previous pose 2 cm and 0.01 rad behind it, computed in the
    same mode."""
    v, n, rv, rn, pose, view = _level_maps(frame, dev, 1)
    old_pose = G.mat4mul(pose, G.se3_exp(torch.tensor(
        [-0.02, 0.01, 0.0, 0.0, 0.01, 0.0], device=dev)))
    red, _ = reduce.track_reduce_cuda(v, n, rv, rn, pose, view)
    update_pose(pose, red, 1e-5)          # warm-up: build, scratch, constants
    cv_predict(pose, old_pose)
    torch.cuda.synchronize()
    done = torch.zeros((), dtype=torch.bool, device=dev)
    reduction = torch.zeros(32, device=dev)
    level_result = torch.zeros(v.shape[1:], dtype=torch.int32, device=dev)
    before = reduce.fused_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        if motion_model == "cv":
            pose = cv_predict(pose, old_pose)
        for _ in range(5):
            red, res = reduce.track_reduce_cuda(v, n, rv, rn, pose, view)
            new_pose, conv = update_pose(pose, red, 1e-5)
            pose = torch.where(done, pose, new_pose)
            reduction = torch.where(done, reduction, red)
            level_result = torch.where(done, level_result, res)
            done = done | conv
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert reduce.fused_launches == before + 5
    return pose, reduction


def test_icp_level_makes_no_host_read(frame, dev):
    """The level makes no host read, and a second run of it finds every
    constant it asks ``geometry.constant`` for in the cache."""
    pose, reduction = _icp_level_under_sync_error(frame, dev)
    assert torch.isfinite(pose).all() and int(reduction[28]) > 0
    cached = {k: id(v) for k, v in G._constants.items()}
    _icp_level_under_sync_error(frame, dev)
    assert {k: id(v) for k, v in G._constants.items()} == cached


def test_icp_level_with_cv_start_makes_no_host_read(frame, dev):
    """The cv warm start (``pipeline.cv_predict``: SE(3) log, the norm,
    its clamp, the exp) adds no host read in front of the level."""
    pose, reduction = _icp_level_under_sync_error(frame, dev, "cv")
    assert torch.isfinite(pose).all() and int(reduction[28]) > 0


def test_sync_check_sees_an_uncached_constant(frame, dev, monkeypatch):
    """The check above fails when ``geometry.constant`` uploads on every
    call: the pageable copy synchronises and sync debug mode raises."""
    monkeypatch.setattr(G, "constant", lambda values, dtype, device:
                        torch.tensor(values, dtype=dtype, device=device))
    with pytest.raises(RuntimeError, match="synchroniz"):
        _icp_level_under_sync_error(frame, dev)


def test_mm2meters_on_card_is_ieee_division_for_every_uint16(dev):
    mm = torch.arange(65536, dtype=torch.int32, device=dev).reshape(256, 256)
    got = mm2meters(mm, 1).cpu().numpy()
    want = np.arange(65536).astype(np.float32).reshape(256, 256) \
        / np.float32(1000)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_cli_on_card(dev, tmp_path):
    """12 frames of the 160x120 clip at 64^3 through the CLI on the card:
    tracked from frame 4, one K1F launch per frame and no metre-in K1,
    19 K2F per frame and no unfused K2."""
    from slambench_tpu_torch.config import parse_args
    from slambench_tpu_torch.eval.check_pos import (
        compute_ate, load_gt_trajectory, parse_benchmark_log,
    )
    from slambench_tpu_torch.frontend.benchmark import run
    man = generate_dataset(str(tmp_path), dev, n_frames=12,
                           image_size=(160, 120), amp=0.12)
    log_path = str(tmp_path / "b.log")
    cfg = parse_args(["-i", man["raw"], "-o", log_path, "-v", "64",
                      "-s", "4.8", "-p", "0.34,0.5,0.24", "-c", "1", "-r", "1",
                      "-k", "120.3,120.0,80,60"])
    bilateral.launches = bilateral.fused_launches = 0
    reduce.launches = reduce.fused_launches = 0
    run(cfg, dev, quiet=True)
    assert bilateral.fused_launches == 12 and bilateral.launches == 0
    assert reduce.fused_launches == 12 * 19 and reduce.launches == 0
    log = parse_benchmark_log(log_path)
    assert log["tracked"][4:].all()
    assert compute_ate(log, load_gt_trajectory(man["gt"]))["ATE"].mean() < 0.06


def test_timed_route_on_card(dev, tmp_path, monkeypatch):
    """The phased CLI with KERNEL_TIMINGS=1 takes frontend/timed.py: 10
    frames of the 160x120 clip at 64^3 with K1 once a frame and K2 once
    a ``reduce`` row, K1F and K2F never; tracked from frame 4."""
    import contextlib
    from slambench_tpu_torch.config import parse_args
    from slambench_tpu_torch.eval.check_kernels import aggregate_kernel_log
    from slambench_tpu_torch.eval.check_pos import (
        compute_ate, load_gt_trajectory, parse_benchmark_log,
    )
    from slambench_tpu_torch.frontend.benchmark import run
    man = generate_dataset(str(tmp_path), dev, n_frames=10,
                           image_size=(160, 120), amp=0.12)
    log_path = str(tmp_path / "b.log")
    cfg = parse_args(["-i", man["raw"], "-o", log_path, "-v", "64",
                      "-s", "4.8", "-p", "0.34,0.5,0.24", "-c", "1", "-r", "1",
                      "-k", "120.3,120.0,80,60", "--backend", "fast"])
    monkeypatch.setenv("KERNEL_TIMINGS", "1")
    bilateral.launches = bilateral.fused_launches = 0
    reduce.launches = reduce.fused_launches = 0
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        run(cfg, dev, quiet=True)
    agg = aggregate_kernel_log(err.getvalue().splitlines())
    assert bilateral.launches == len(agg["bilateralFilter"]) == 10
    assert reduce.launches == len(agg["reduce"]) == len(agg["track"]) > 0
    assert bilateral.fused_launches == reduce.fused_launches == 0
    log = parse_benchmark_log(log_path)
    assert log["tracked"][4:].all()
    assert compute_ate(log, load_gt_trajectory(man["gt"]))["ATE"].mean() < 0.06


def test_spans_wrap_only_the_launch(frame_mm, frame, dev, monkeypatch):
    """A KERNEL_TIMINGS span passed to K1F and K2F records one event pair
    around the launch; the outputs equal an untimed call's."""
    from slambench_tpu_torch.utils.timers import KernelTimings
    monkeypatch.setenv("KERNEL_TIMINGS", "1")
    t = KernelTimings(dev)
    g = make_gaussian()
    fd, sd = bilateral.mm2m_bilateral_cuda(frame_mm, 2, g,
                                           span=t.span("mm2m_bilateral"))
    args = _level_maps(frame, dev, 0)
    red, res = reduce.track_reduce_cuda(*args, span=t.span("track_reduce"))
    torch.cuda.synchronize()
    fd2, sd2 = bilateral.mm2m_bilateral_cuda(frame_mm, 2, g)
    red2, res2 = reduce.track_reduce_cuda(*args)
    assert torch.equal(fd, fd2) and torch.equal(sd, sd2)
    assert torch.equal(red, red2) and torch.equal(res, res2)
    spans = t.flush(io.StringIO())
    assert [name for name, _, _ in spans] == ["mm2m_bilateral",
                                              "track_reduce"]
    assert all(ns > 0 for _, ns, _ in spans)


def test_warm_start_on_card_equals_cpu(dev):
    """The warm-start bound and the warm-started march on the card
    against the same calls on the CPU: the bound within 1e-6 m, the
    hits within test_raycast_fast.py's gates."""
    from slambench_tpu_torch.ops.raycast_fast import (
        raycast_fast_maps, warm_start_bound,
    )
    c = np.linspace(2.0 / 128, 2.0 - 2.0 / 128, 64)
    Z, Y, X = np.meshgrid(c, c, c, indexing="ij")
    d = np.sqrt((X - 1.0) ** 2 + (Y - 1.0) ** 2 + (Z - 1.4) ** 2) - 0.3
    tsdf = torch.from_numpy(np.trunc(np.clip(d / 0.2, -1, 1) * 32766)
                            .astype(np.int16))
    view = G.mat4mul(G.translation_pose([1.0, 1.0, 0.2], torch.device("cpu")),
                     G.get_inverse_camera_matrix(
                         torch.tensor([60.0, 60.0, 16.0, 12.0])))
    args = ((2.0,) * 3, view, (24, 32), 0.1, 4.0, 2.0 / 64, 0.15)
    out = {}
    for where in (torch.device("cpu"), dev):
        vol = tsdf.to(where)
        mip = make_min_mip(vol)
        a = (args[0], args[1].to(where)) + args[2:]
        _, _, t0 = raycast_fast_maps(vol, mip, *a)
        bound = warm_start_bound(t0, torch.eye(4, device=where), 4.0, 0.15)
        v, n, t = raycast_fast_maps(vol, mip, *a, t_init=bound)
        out[where.type] = [x.cpu() for x in (bound, v, n, t)]
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-6)
    hc, hg = out["cpu"][2][0] != -2, out["cuda"][2][0] != -2
    assert int((hc ^ hg).sum()) <= 2 and int((hc & hg).sum()) > 50
    dv = (out["cuda"][1] - out["cpu"][1]).abs().amax(0)[hc & hg]
    assert float(dv.max()) < 2 * 2.0 / 64


def _grey_levels_agree(name, got, want):
    """Two uint8 images within one grey level on >= 99.9% of pixels."""
    assert got.dtype == want.dtype == torch.uint8
    assert got.shape == want.shape
    d = (got.cpu().to(torch.int32) - want.to(torch.int32)).abs()
    share = float((d.amax(dim=-1) <= 1).float().mean())
    assert share >= 0.999, f"{name}: {share:.5f} of pixels within 1"


def test_render_helpers_on_card_equal_cpu(dev, frame):
    """render_depth, render_track, render_normal and both render_volume
    routes on the card against the same calls on CPU copies."""
    cpu = torch.device("cpu")
    v, n, rv, rn, pose, view = _level_maps(frame, dev, 0)
    _, res = reduce.track_reduce_cuda(v, n, rv, rn, pose, view)
    _grey_levels_agree("render_depth", render.render_depth(frame),
                       render.render_depth(frame.cpu()))
    _grey_levels_agree("render_track", render.render_track(res),
                       render.render_track(res.cpu()))
    _grey_levels_agree("render_normal", render.render_normal(n),
                       render.render_normal(n.cpu()))
    c = torch.linspace(1 / 64, 2 - 1 / 64, 64, device=dev)
    Z, Y, X = torch.meshgrid(c, c, c, indexing="ij")
    d = torch.sqrt((X - 1.0) ** 2 + (Y - 1.0) ** 2 + (Z - 1.4) ** 2) - 0.3
    tsdf = torch.trunc(torch.clamp(d / 0.2, -1, 1) * 32766).to(torch.int16)
    k = torch.tensor([240.0, 240.0, 64.0, 48.0], device=dev)
    vv = G.mat4mul(G.translation_pose([1.0, 1.0, 0.2], dev),
                   G.get_inverse_camera_matrix(k))
    args = ((2.0,) * 3, vv, (96, 128), 0.1, 4.0, 2.0 / 64, 0.15)
    cargs = (args[0], vv.cpu()) + args[2:]
    for mip in (None, make_min_mip(tsdf)):
        got = render.render_volume(tsdf, *args, mip=mip)
        want = render.render_volume(tsdf.cpu(), *cargs,
                                    mip=None if mip is None else mip.cpu())
        assert int((got[..., :3].amax(-1) > 0).sum()) > 800
        _grey_levels_agree("render_volume", got, want)


# ------------------------------ G1-G4 -------------------------------- #

def _ri(dev, lo, hi, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=torch.int32)


@pytest.fixture(scope="module")
def tables(dev):
    rng = np.random.default_rng(5)
    mm = torch.from_numpy(rng.integers(0, 5000, (240, 320))
                          .astype(np.uint16)).to(dev)
    return {"p1": torch.from_numpy(rng.random((256, 128)).astype(np.float32))
            .to(dev),
            "mm": mm, "depth": gather.mm_to_meters(mm),
            "vol": torch.from_numpy(rng.integers(-32766, 32767, 256 ** 3)
                                    .astype(np.int16)).to(dev)}


def _launch_once(name, fn):
    before = gather.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert gather.launches[name] == before + 1
    return out


@pytest.mark.parametrize("mode,hi", [("flat", 256 * 128), ("lane", 128),
                                     ("sublane", 256)])
def test_g2_shared_memory_gathers_equal_twin(dev, tables, mode, hi):
    """P1's table (128 KB, above the 48 KB a block gets without the
    dynamic shared-memory attribute) in every mode."""
    t = tables["p1"]
    i = _ri(dev, 0, hi, (256, 128), seed=hi)
    got = _launch_once("gather_axis_smem",
                       lambda: gather.gather_axis_smem(t, i, mode))
    assert torch.equal(got, gather.gather_axis_plain(t, i, mode))


@pytest.mark.parametrize("table,n,mode", [
    ("p1", 256 * 128, None), ("depth", 2 * 1024 * 1024, None),
    ("mm", 2 * 1024 * 1024, None), ("vol", 76_800, None),
    ("vol", 256 ** 3, None), ("vol", 256 ** 3, "clip"),
    ("depth", 76_800, "clip"), ("vol", 256 ** 3, "fill"),
    ("depth", 2 * 1024 * 1024, "fill")])
def test_g1_flat_gather_equals_twin(dev, tables, table, n, mode):
    t = tables[table]
    lo, hi = (-1000, t.numel() + 1000) if mode else (0, t.numel())
    i = _ri(dev, lo, hi, (n,), seed=n)
    got = _launch_once("gather_flat",
                       lambda: gather.gather_flat(t, i, mode=mode))
    assert equal_nan(got, gather.gather_flat_plain(t, i, mode=mode))


def test_g3_u16_shared_memory_equals_g1_bit_for_bit(dev, tables):
    i = _ri(dev, 0, 240 * 320, (1024, 2048), seed=3)
    got = _launch_once("gather_smem_u16",
                       lambda: gather.gather_smem_u16(tables["mm"], i))
    assert torch.equal(got, gather.gather_u16_plain(tables["mm"], i))
    assert torch.equal(got, gather.gather_flat(tables["depth"], i,
                                               mode="fill"))


def test_mm_to_meters_on_card_is_ieee_division(tables):
    """The f32 image G3 is held to: the same bits as the CPU's division."""
    assert torch.equal(gather.mm_to_meters(tables["mm"]).cpu(),
                       gather.mm_to_meters(tables["mm"].cpu()))


@pytest.mark.parametrize("shape,route", [((240, 320), "gather_2d_staged"),
                                         ((720, 1280), "gather_2d_device")])
def test_g4_2d_gather_equals_twin(dev, shape, route):
    """P3's image on the staged route (76% of it in every block), and a
    720x1280 image (of which a block would hold 6%) from device memory."""
    t = torch.rand(shape, device=dev)
    vi = _ri(dev, 0, shape[0], (1024, 2048), seed=4)
    ui = _ri(dev, 0, shape[1], (1024, 2048), seed=5)
    got = _launch_once(route, lambda: gather.gather_2d(t, vi, ui))
    assert torch.equal(got, gather.gather_2d_plain(t, vi, ui))


def test_g1_g2_edge_cases_equal_twins(dev):
    """The redesigned kernels' own edge cases (tools/gather_probe.py:
    edge_cases), G1-G4: misaligned indices, 1, 3 and 4k+3 lookups,
    indices below -n, in [-n, 0), in range, at or above n and at the
    int32 extremes, G2 tables that do not divide its bands or its
    cluster's split, the full 232,448 bytes in two rows, G3 tables at
    its cap and of no multiple of 16 bytes, G4 tables on both routes,
    and G1's all-scalar way through the C entry. NaN must stand where
    the twin has NaN."""
    from slambench_tpu_torch.tools.gather_probe import edge_cases
    before = dict(gather.launches)
    differ = []
    for name, kernel, twin in edge_cases(dev):
        got, want = kernel(), twin()
        torch.cuda.synchronize()
        if not equal_nan(got, want):
            differ.append(name)
    assert not differ
    assert all(gather.launches[k] > before[k] for k in gather.launches)


def test_g2_flat_back_to_back_launches_equal_twin(dev, tables):
    """50 G2 flat launches queued back to back: each sets up its own
    mbarrier and cluster barriers, so none leaks into the next."""
    t = tables["p1"]
    i = _ri(dev, 0, t.numel(), (256, 128), seed=50)
    want = gather.gather_axis_plain(t, i, "flat")
    before = gather.launches["gather_axis_smem"]
    outs = [gather.gather_axis_smem(t, i, "flat") for _ in range(50)]
    torch.cuda.synchronize()
    assert gather.launches["gather_axis_smem"] == before + 50
    assert all(torch.equal(o, want) for o in outs)


def test_refused_shared_memory_launch_returns_its_error(dev):
    """A table past the 232,448 bytes a block may use: the kernel is not
    launched, the C call returns a non-zero cudaError_t, and build.check
    raises."""
    t = torch.zeros((240, 320), device=dev)
    i = torch.zeros((240, 320), dtype=torch.int32, device=dev)
    out = torch.empty_like(t)
    status = build.load().slb_gather_axis_smem_f32(
        t.data_ptr(), i.data_ptr(), out.data_ptr(), 240, 320, 240, 320, 0,
        132, torch.cuda.current_stream().cuda_stream)
    assert status != 0
    with pytest.raises(RuntimeError, match="cudaError_t"):
        build.check(status, "gather_axis_smem kernel")
    # The refusal leaves no error behind for the next launch.
    t2 = torch.rand((256, 128), device=dev)
    i2 = torch.zeros((256, 128), dtype=torch.int32, device=dev)
    assert torch.equal(gather.gather_axis_smem(t2, i2, "flat"),
                       gather.gather_axis_plain(t2, i2, "flat"))
