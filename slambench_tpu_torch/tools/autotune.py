"""Kernel-parameter tuning harness (port of
``slambench_tpu/tools/autotune.py``).

The counterpart of the reference's OpenCL work-group tuning route
(reference: kfusion/thirdparty/OCLWrapper.cpp:77-132: the LD_PRELOAD
wrapper relaunches a chosen kernel with ls0..2/gs0..2 overrides and
reports nanoseconds a launch). The port's tunables:

* ``reduce`` -- threads a block of K2F, the fused track + reduce kernel
  (``ops/hopper/reduce.py``; env ``SLAMBENCH_REDUCE_THREADS``), the
  port's stand-in for JAX's Pallas tile height ``SLAMBENCH_TILE_ROWS``;
* ``mip`` -- min-mip cell edge of the min-mip raycast
  (``ops/raycast_fast.py``; env ``SLAMBENCH_MIP_BLOCK``);
* ``refine`` -- the raycast's (rescan steps, false-position iterations)
  (env ``SLAMBENCH_RAYCAST_NSCAN`` / ``SLAMBENCH_RAYCAST_REFINE``), with
  the largest hit difference from a (10, 5) reference in voxels;
* ``blocks`` -- the frustum-culled integrate's block grid
  (``ops/integrate.py``; env ``SLAMBENCH_INTEGRATE_BLOCKS``), with the
  visible blocks.

Each point prints one ``name duration_ns size [extra]`` line on stdout,
the stream ``eval/check_kernels.py`` reads; ``main`` prints the best
value on stderr.

Timing: ``tools/timing.py:call_ms``; on the card ``per_launch_ms``
(CUDA events around back-to-back calls behind a spin kernel, the median
of three runs). The raycast and integrate sweeps chain each call's input on the
last output as JAX does (the view nudged by the hits, the volume fed
back); K2F's sweep times the kernel alone, since a chaining op would be
a launch of its own beside a ~6 us kernel. On the CPU the calls are
timed by the host clock and the lines say ``cpu``; the reduce sweep runs
K2F's plain twin there (threads has no meaning on the CPU) and says
``plain``.

CLI (``python -m slambench_tpu_torch.tools.autotune``):
  autotune reduce [--values 128,256,512,1024] [--pixels 76800]
  autotune mip    [--values 4,8,16,32]
  autotune refine [--values 8:4,6:3,4:3,4:2,3:2,2:2]
  autotune blocks [--values 1x1x1,8x8x1,8x8x2,...]
      [--device cuda] [--iters 8] [--resolution 256]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from slambench_tpu_torch import geometry as G
from slambench_tpu_torch import params
from slambench_tpu_torch.policy import apply_precision_policy, resolve_device
from slambench_tpu_torch.tools.timing import call_ms

DIM = (4.8, 4.8, 4.8)
K_320 = (240.6, 240.0, 160.0, 120.0)      # the 320x240 computation camera


def _tag(device: torch.device) -> str:
    return "" if device.type == "cuda" else ",cpu"


def _view(device: torch.device) -> torch.Tensor:
    """view = pose @ inv(K): a camera at (2.4, 2.4, 0.2) looking down
    +z, inside the volume (JAX's sweep scenes)."""
    K = np.array([[K_320[0], 0, K_320[2], 0], [0, K_320[1], K_320[3], 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (2.4, 2.4, 0.2)
    return torch.from_numpy(pose @ np.linalg.inv(K)).to(device)


def _chained(rc, view0: torch.Tensor):
    """A call of the raycast ``rc(view) -> t_hit`` chained as JAX chains
    it: each call nudges the view by the last hits' largest t (x 1e-30),
    so no call repeats its predecessor's input."""
    chain = {"view": view0.clone()}

    def call():
        t_hit = rc(chain["view"])
        chain["view"] = chain["view"] + torch.nn.functional.pad(
            (t_hit.max() * 1e-30).reshape(1, 1), (3, 0, 0, 3))

    return call


def _wall_volume(n: int, device: torch.device,
                 undulating: bool = False) -> torch.Tensor:
    """JAX's sweep scenes: a wall at z = 2.4 m (or undulating around it,
    ``0.3 sin(2.1 x) cos(1.7 y)``), TSDF positive in front of it."""
    from slambench_tpu_torch.volume import pack_tsdf
    c = (np.arange(n, dtype=np.float32) + 0.5) * (DIM[2] / n)
    if undulating:
        Z, Y, X = np.meshgrid(c, c, c, indexing="ij")
        wall = 2.4 + 0.3 * np.sin(X * 2.1) * np.cos(Y * 1.7)
        sdf = np.clip((wall - Z) / 0.1, -1.0, 1.0).astype(np.float32)
    else:
        sdf = np.broadcast_to(np.clip((2.4 - c) / 0.1, -1.0, 1.0)
                              .astype(np.float32)[:, None, None], (n,) * 3)
    return pack_tsdf(torch.from_numpy(np.ascontiguousarray(sdf)).to(device))


def _icp_inputs(pixels: int, device: torch.device):
    """K2F's arguments at ``pixels // 320`` x 320: the level maps of a
    synthetic frame of the traj2-like scene against the same maps under
    a small pose offset."""
    from slambench_tpu_torch.io.synthetic import (
        SyntheticScene, orbit_trajectory, render_depth_frame,
    )
    from slambench_tpu_torch.ops.vertex import depth2vertex, vertex2normal
    H, W = max(1, pixels // 320), 320
    k = torch.tensor((*K_320[:3], H / 2), device=device)
    pose0 = orbit_trajectory(1, [0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8])[0]
    mm = render_depth_frame(SyntheticScene(dim=DIM), pose0,
                            tuple(float(v) for v in k), (W, H), device)
    depth = torch.from_numpy(mm.astype(np.float32) / 1000.0).to(device)
    v = depth2vertex(depth, G.get_inverse_camera_matrix(k))
    n = vertex2normal(v)
    pose = G.se3_exp(torch.tensor([0.01, -0.005, 0.008, 0.004, -0.003,
                                   0.002], device=device))
    return v, n, v, n, pose, G.get_camera_matrix(k)


def sweep_reduce(values, pixels: int, iters: int, device: torch.device,
                 out=None):
    """K2F a launch at each threads-a-block value; on the card each
    result is held to the plain twin (result codes equal, the sums
    within ``K2_TOL``) before it is timed."""
    out = out or sys.stdout
    from slambench_tpu_torch.ops.hopper import reduce
    from slambench_tpu_torch.tools.mosaic_probe import K2_TOL
    args = _icp_inputs(pixels, device)
    n = args[0].shape[1] * args[0].shape[2]
    want, want_res = reduce.track_reduce_plain(*args)
    rows = []
    for threads in values:
        got, res = reduce.track_reduce_cuda(*args, threads=int(threads))
        if not torch.equal(res, want_res):
            raise RuntimeError(f"K2F threads={threads}: result codes differ "
                               "from the twin's")
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   err_msg=f"K2F threads={threads}",
                                   **K2_TOL)
        ns = 1e6 * call_ms(lambda: reduce.track_reduce_cuda(
            *args, threads=int(threads)), iters, device)
        label = "" if device.type == "cuda" else ",plain,cpu"
        print(f"track_reduce[threads={threads}{label}] {ns:.0f} {n}",
              file=out)
        rows.append((int(threads), ns, float(got[28])))
    return rows


def sweep_mip(values, resolution: int, iters: int, device: torch.device,
              out=None):
    """The min-mip raycast a call at each cell edge (its min-mip built
    once, outside the timing), on JAX's flat-wall scene (>= half the
    rays must hit)."""
    out = out or sys.stdout
    from slambench_tpu_torch.ops.raycast_fast import make_min_mip, raycast_fast
    n = resolution
    tsdf = _wall_volume(n, device)
    view0 = _view(device)
    step = min(DIM) / n
    rows = []
    for m in values:
        m = int(m)
        mip = make_min_mip(tsdf, m)

        def rc(view, m=m, mip=mip):
            return raycast_fast(tsdf, mip, DIM, view,
                                (240, 320), params.NEAR_PLANE,
                                params.FAR_PLANE, step, 0.075, m=m)[1]

        hit_frac = float((rc(view0) > 0).float().mean())
        if hit_frac < 0.5:
            raise RuntimeError(
                f"mip sweep scene degenerate: only {hit_frac:.0%} of rays "
                "hit the wall; the timing would measure an empty march")
        ns = 1e6 * call_ms(_chained(rc, view0), iters, device)
        print(f"raycast[mip_block={m}{_tag(device)}] {ns:.0f} {240 * 320}",
              file=out)
        rows.append((m, ns, hit_frac))
    return rows


def sweep_refine(values, resolution: int, iters: int, device: torch.device,
                 out=None):
    """The raycast a call at each ``nscan:fp_iters`` budget, and its
    largest hit difference (voxels) from a (10, 5) reference, on JAX's
    undulating-wall scene."""
    out = out or sys.stdout
    from slambench_tpu_torch.ops.raycast_fast import make_min_mip, raycast_fast
    n = resolution
    tsdf = _wall_volume(n, device, undulating=True)
    mip = make_min_mip(tsdf)
    view0 = _view(device)
    step = min(DIM) / n

    def rc(view, nscan, fp):
        return raycast_fast(tsdf, mip, DIM, view, (240, 320),
                            params.NEAR_PLANE, params.FAR_PLANE, step, 0.075,
                            nscan=nscan, fp_iters=fp)[1]

    t_ref = rc(view0, 10, 5).cpu().numpy()
    rows = []
    for spec in values:
        nscan, fp = (int(x) for x in str(spec).split(":"))
        t = rc(view0, nscan, fp).cpu().numpy()
        both = (t_ref > 0) & (t > 0)
        err_vox = float(np.abs(t[both] - t_ref[both]).max() / step) \
            if both.any() else float("inf")
        ns = 1e6 * call_ms(_chained(lambda v, a=nscan, b=fp: rc(v, a, b),
                                    view0), iters, device)
        print(f"raycast[nscan={nscan},fp={fp}{_tag(device)}] {ns:.0f} "
              f"{240 * 320} max_err_vox={err_vox:.4f}", file=out)
        rows.append(((nscan, fp), ns, err_vox))
    return rows


def bench_depth(device: torch.device) -> torch.Tensor:
    """The traj2-like scene's first frame from its first pose, 640x480
    in mm, at the computation size 320x240 in metres (ratio 2)."""
    from slambench_tpu_torch.io.synthetic import (
        SyntheticScene, orbit_trajectory, render_depth_frame,
    )
    from slambench_tpu_torch.ops.preprocess import mm2meters
    pose = orbit_trajectory(1, [0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8])[0]
    mm = render_depth_frame(SyntheticScene(dim=DIM), pose,
                            (481.2, 480.0, 320.0, 240.0), (640, 480), device)
    return mm2meters(torch.from_numpy(mm.astype(np.int32)).to(device),
                     2).contiguous()


def sweep_blocks(values, resolution: int, iters: int, device: torch.device,
                 out=None):
    """The integrate a call at each block grid ``NZxNY[xNX]`` (1x1x1 is
    the monolithic ``integrate``), at the traj2-like clip's first pose
    and frame; grids that do not divide the volume are skipped."""
    out = out or sys.stdout
    from slambench_tpu_torch.ops.integrate import (
        block_visibility, integrate, integrate_blocks,
    )
    n = resolution
    depth = bench_depth(device)
    K = G.get_camera_matrix(torch.tensor(K_320, device=device))
    inv = G.rigid_inverse(G.translation_pose(
        [0.34 * DIM[0], 0.5 * DIM[1], 0.24 * DIM[2]], device))
    rows = []
    for spec in values:
        parts = [int(x) for x in str(spec).lower().split("x")]
        nz, ny, nx = (parts + [1, 1])[:3]
        if n % nz or n % ny or n % nx:
            continue
        if (nz, ny, nx) == (1, 1, 1):
            def fn(t, w):
                return integrate(t, w, depth, inv, K, 0.1, params.MAX_WEIGHT,
                                 DIM)
            vis_n, vis_d = 1, 1
        else:
            def fn(t, w, g=(nz, ny, nx)):
                return integrate_blocks(t, w, depth, inv, K, 0.1,
                                        params.MAX_WEIGHT, DIM, *g)
            vis = block_visibility(nz, ny, DIM, inv, K, depth, 0.1, n_x=nx)
            vis_n, vis_d = int(vis.sum()), vis.numel()
        chain = {"tw": (torch.full((n,) * 3, 32766, dtype=torch.int16,
                                   device=device),
                        torch.zeros((n,) * 3, dtype=torch.int8,
                                    device=device))}

        def call(fn=fn):
            chain["tw"] = fn(*chain["tw"])   # chained: w saturates

        ns = 1e6 * call_ms(call, iters, device)
        print(f"integrate[blocks={nz}x{ny}x{nx}{_tag(device)}] {ns:.0f} "
              f"{n ** 3} visible={vis_n}/{vis_d}", file=out)
        rows.append(((nz, ny, nx), ns, vis_n / vis_d))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=["reduce", "mip", "refine", "blocks"])
    ap.add_argument("--values", default=None,
                    help="comma-separated parameter values to sweep")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--pixels", type=int, default=76800)
    ap.add_argument("--resolution", type=int, default=256)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    apply_precision_policy()

    if args.kernel == "reduce":
        values = [int(v) for v in
                  (args.values or "128,256,512,1024").split(",")]
        rows = sweep_reduce(values, args.pixels, args.iters, device)
    elif args.kernel == "refine":
        values = (args.values or "8:4,6:3,4:3,4:2,3:2,2:2").split(",")
        rows = sweep_refine(values, args.resolution, args.iters, device)
    elif args.kernel == "blocks":
        values = (args.values
                  or "1x1x1,8x8x1,8x8x2,8x8x8,16x16x2,16x16x8").split(",")
        rows = sweep_blocks(values, args.resolution, args.iters, device)
    else:
        values = [int(v) for v in (args.values or "4,8,16,32").split(",")]
        rows = sweep_mip(values, args.resolution, args.iters, device)

    best = min(rows, key=lambda r: r[1])
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu, host clock"
    print(f"# best: {args.kernel}={best[0]} ({best[1]:.0f} ns/call, {where})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
