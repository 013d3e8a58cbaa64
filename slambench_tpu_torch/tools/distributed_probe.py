"""Live multi-process collective probe (port of
``slambench_tpu/tools/distributed_probe.py``).

N processes, each one rank of a ``torch.distributed`` group
(``parallel/distributed.py``), form one mesh and run:

  1. a ``psum`` of every rank's index (the ICP normal-equations
     reduction, ``parallel/step.py``);
  2. a ring shift: each rank's halo from its neighbours through
     ``Mesh.halo`` (the TSDF halo exchange), checked plane by plane;
  3. with ``--full-step``, one complete sharded frame step at tiny shapes
     with every phase on;
  4. with ``--raycast FILE.npz`` (repeatable; ``save_raycast_case``
     writes one), the slab-composite raycast of a whole volume against
     the single-device min-mip raycast (``raycast_fast_maps``) of the
     same volume and view: rank 0 reports the hit mismatch share, the
     largest vertex difference on common hits and the share of them
     whose normals agree to a dot > 0.99;
  5. with ``--capability N``, JAX's 1024^3 capability setting
     (``tests/test_sharded.py:206``) at an N^3 volume of 4.8 m: a
     bootstrap integrate of a flat 2 m depth (64x48), then a frame with
     tracking, integrate and raycast; the wall must show in
     ``ref_normal`` and ``tsdf[:, ::N/16, ::N/16]`` (gathered) must
     cross zero. Each rank reports both frames' ms, its peak device
     memory, and whether one monolithic ``integrate`` of its slab fits
     beside the state (its peak, or the out-of-memory error). The
     integrate runs ``SLAMBENCH_INTEGRATE_BLOCKS``'s grid when set.

Each rank prints one JSON line; the parent (``--launch N``, a test, or
``chip_smoke.py``) checks the collective results. Run by hand on the CPU
or on a card (ranks beyond the card count share it, over gloo):

  python -m slambench_tpu_torch.tools.distributed_probe --launch 2 \\
      [--device cpu] [--full-step]
      [--raycast case.npz ...] [--capability 1024]
  torchrun --nproc-per-node 2 -m slambench_tpu_torch.tools.distributed_probe
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def save_raycast_case(path: str, tsdf, dim, camera, pose, image,
                      mu: float) -> None:
    """Write a ``--raycast`` case: an int16 [Z, Y, X] volume, its size
    in metres, the camera (fx, fy, cx, cy), the pose, the image (W, H)
    and mu (which sets the march's large step)."""
    np.savez(path, tsdf=np.asarray(tsdf, np.int16),
             dim=np.asarray(dim, np.float64),
             camera=np.asarray(camera, np.float64),
             pose=np.asarray(pose, np.float32),
             image=np.asarray(image, np.int64), mu=np.float64(mu))


def slab_raycast_case(mesh, path: str):
    """This rank's slab raycast of a case's volume: (the sharded
    pipeline, the whole volume, the view, vertex map, normal map)."""
    from slambench_tpu_torch import geometry as G
    from slambench_tpu_torch.parallel.step import ShardedKFusion

    case = np.load(path)
    dev = mesh.device
    tsdf = torch.from_numpy(case["tsdf"]).to(dev)
    dim = tuple(float(d) for d in case["dim"])
    W, H = (int(v) for v in case["image"])
    sz, sy, sx = tsdf.shape
    kf = ShardedKFusion((W, H), (sx, sy, sz), dim, (0.0, 0.0, 0.0), (1,),
                        tuple(float(c) for c in case["camera"]),
                        mu=float(case["mu"]), mesh=mesh)
    pose = torch.from_numpy(case["pose"]).to(dev)
    view = G.mat4mul(pose, G.get_inverse_camera_matrix(kf._k))
    v, n = kf._slab_raycast(tsdf[kf.z0:kf.z0 + kf.slab_z].contiguous(), view)
    return kf, tsdf, view, v, n


def raycast_case(mesh, path: str) -> dict:
    """Slab raycast (this rank's slab of the case's volume) against the
    single-device march; the comparison on rank 0, None elsewhere."""
    from slambench_tpu_torch import params
    from slambench_tpu_torch.ops.raycast_fast import (
        make_min_mip, raycast_fast_maps,
    )

    kf, tsdf, view, v2, n2 = slab_raycast_case(mesh, path)
    W, H = kf.W, kf.H
    dim = kf.volume_dimensions
    sz, sy, sx = tsdf.shape
    if mesh.rank != 0:
        return None
    v1, n1, _ = raycast_fast_maps(tsdf, make_min_mip(tsdf), dim, view,
                                  (H, W), params.NEAR_PLANE,
                                  params.FAR_PLANE, kf.step, 0.75 * kf.mu)
    v1, n1, v2, n2 = (x.cpu().numpy() for x in (v1, n1, v2, n2))
    h1, h2 = n1[0] != params.INVALID, n2[0] != params.INVALID
    m = h1 & h2
    dv = np.abs(v1[:, m] - v2[:, m]).max(axis=0) if m.any() else np.zeros(1)
    dot = np.sum(n1[:, m] * n2[:, m], axis=0)
    return {"case": os.path.basename(path), "volume": [sx, sy, sz],
            "image": [W, H], "hits": int(h1.sum()),
            "hit_mismatch": float((h1 != h2).mean()),
            "max_abs_dv": float(dv.max()),
            "normal_dot_gt_0.99": float((dot > 0.99).mean()) if m.any()
            else 1.0}


def capability(mesh, volume: int) -> dict:
    """One rank's part of JAX's capability run at ``volume``^3
    (``tests/test_sharded.py:206``: 64x48, pyramid 4,3,3, a 2 m flat
    depth, frame 0 then frame 3)."""
    from slambench_tpu_torch.geometry import get_camera_matrix, rigid_inverse
    from slambench_tpu_torch.ops.integrate import integrate
    from slambench_tpu_torch.parallel.step import ShardedKFusion

    dev = mesh.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    kf = ShardedKFusion((64, 48), (volume,) * 3, (4.8,) * 3,
                        (1.6, 2.4, 1.2), (4, 3, 3), (48.0, 48.0, 32.0, 24.0),
                        mesh=mesh)
    depth = np.full((48, 64), 2000, np.uint16)
    ms = {}
    t0 = time.perf_counter()
    state = kf.init_state()
    sync()
    ms["init"] = 1e3 * (time.perf_counter() - t0)
    for frame, name in ((0, "bootstrap"), (3, "frame3")):
        t0 = time.perf_counter()
        state = kf.process_frame(state, depth, frame)
        sync()
        ms[name] = 1e3 * (time.perf_counter() - t0)
    stride = max(1, volume // 16)
    sub = mesh.all_gather_rows(
        state.tsdf[:, ::stride, ::stride].contiguous(), "capability_tsdf")
    wall_hits = int((state.ref_normal[0] != -2).sum())
    out = {"volume": volume, "slab_z": kf.slab_z,
           "integrate_block_grid": list(kf.integrate_block_grid),
           "integrated": bool(state.integrated), "ms": ms,
           "wall_hits": wall_hits,
           "tsdf_min": int(sub.min()), "tsdf_max": int(sub.max()),
           "zero_crossing": bool(int(sub.min()) < 0 < int(sub.max())),
           "peak_bytes": (torch.cuda.max_memory_allocated(dev) if cuda
                          else None)}
    # The monolithic integrate of this slab beside the state.
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        t0 = time.perf_counter()
        integrate(state.tsdf, state.weight, state.float_depth,
                  rigid_inverse(state.pose), get_camera_matrix(kf._k),
                  kf.mu, 100.0, kf.volume_dimensions, z_offset=kf.z0,
                  z_total=volume)
        sync()
        out["monolithic"] = {
            "fits": True, "ms": 1e3 * (time.perf_counter() - t0),
            "peak_bytes": (torch.cuda.max_memory_allocated(dev) if cuda
                           else None)}
    except torch.cuda.OutOfMemoryError as err:
        out["monolithic"] = {"fits": False, "error": str(err)[:300]}
    return out


def rank_main(device: str, full_step: bool, raycasts=(),
              capability_volume: int = 0) -> int:
    from slambench_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    mesh = distributed.initialize(0, device)
    n, rank = mesh.size, mesh.rank
    try:
        # 1. psum across every rank (the ICP reduction's transport).
        total = float(mesh.psum(torch.full((32,), float(rank),
                                           device=mesh.device), "probe")[0])
        want_total = float(sum(range(n)))

        # 2. ring shift (the halo exchange's transport): rank r's slab
        # holds planes 4r..4r+3 (value = global plane index); its halo
        # must be the ring neighbours' adjacent planes.
        h, depth = 2, 4
        z = torch.arange(rank * depth, (rank + 1) * depth,
                         dtype=torch.int16, device=mesh.device)
        slab = z[:, None, None].expand(depth, 3, 4).contiguous()
        ext = mesh.halo(slab, h, "probe_halo")[:, 0, 0].cpu().numpy()
        total_z = n * depth
        if n == 1:
            want = np.r_[np.arange(h), np.arange(depth),
                         np.arange(depth - h, depth)]
        else:
            prev = ((rank - 1) % n) * depth
            nxt = ((rank + 1) % n) * depth
            want = np.r_[np.arange(prev + depth - h, prev + depth),
                         np.arange(rank * depth, (rank + 1) * depth),
                         np.arange(nxt, nxt + h)] % total_z
        ring_ok = bool(np.array_equal(ext, want))

        # 3. one full sharded step at tiny shapes.
        step_ok = None
        if full_step:
            step_ok = _full_step(mesh)
        rays = [raycast_case(mesh, p) for p in raycasts]
        cap = capability(mesh, capability_volume) if capability_volume \
            else None
        print(json.dumps({
            "rank": rank, "ranks": n, "backend": mesh.backend,
            "device": str(mesh.device),
            "halo_by_gather": mesh.halo_by_gather,
            "psum": total, "psum_want": want_total,
            "ring": ext.tolist(), "ring_want": want.tolist(),
            "ring_ok": ring_ok, "full_step_pose_finite": step_ok,
            "raycast": rays if mesh.rank == 0 else None,
            "capability": cap,
        }), flush=True)
        ok = total == want_total and ring_ok and step_ok in (None, True) \
            and (cap is None or (cap["integrated"] and cap["wall_hits"] > 0
                                 and cap["zero_crossing"]))
        return 0 if ok else 1
    finally:
        mesh.close()


def _full_step(mesh) -> bool:
    """One frame through ``ShardedKFusion`` with every phase on (64x48,
    32^3); the pose must be finite and equal on every rank."""
    from slambench_tpu_torch.parallel.step import ShardedKFusion

    W, H = 64, 48
    kf = ShardedKFusion((W, H), (32, 32, 32), (4.8, 4.8, 4.8),
                        (0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8), (3, 2, 2),
                        (481.2 / 10, 480.0 / 10, 32.0, 24.0), mu=0.1,
                        mesh=mesh)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    depth = (1500 + 400 * np.sin(u / 9.0) * np.cos(v / 9.0)).astype(np.uint16)
    state = kf.compute_frame(kf.init_state(), kf.to_device(depth),
                             tracking_on=True, integrate_frame=True,
                             force_integrate=True, raycast_on=True)
    return bool(torch.isfinite(state.pose).all())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-step", action="store_true",
                    help="also run one complete sharded frame step (tiny "
                         "shapes) over the mesh")
    ap.add_argument("--raycast", action="append", default=[],
                    help="a case file (save_raycast_case): the slab "
                         "raycast against the single-device march")
    ap.add_argument("--capability", type=int, default=0, metavar="N",
                    help="also run JAX's capability setting at an N^3 "
                         "volume (1024 in JAX)")
    ap.add_argument("--launch", type=int, default=0,
                    help="start this many ranks as subprocesses and print "
                         "their lines (exit 1 unless every rank passes)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if not args.launch:
        return rank_main(args.device, args.full_step, args.raycast,
                         args.capability)

    from slambench_tpu_torch.parallel import distributed
    cmd = ["-m", "slambench_tpu_torch.tools.distributed_probe",
           "--device", args.device] + (["--full-step"] if args.full_step
                                       else [])
    for path in args.raycast:
        cmd += ["--raycast", os.path.abspath(path)]
    if args.capability:
        cmd += ["--capability", str(args.capability)]
    outs = distributed.launch(args.launch, cmd, cwd=REPO,
                              timeout=args.timeout)
    ok = True
    for rc, out, err in outs:
        lines = out.strip().splitlines()
        print(lines[-1] if lines else json.dumps({"error": err[-2000:]}))
        ok = ok and rc == 0
        if rc:
            print(err[-2000:], file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
