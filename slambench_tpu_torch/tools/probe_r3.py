"""Round-3 probes on the card (port of ``slambench_tpu/tools/
probe_r3.py``): three layouts that bear on the queued hand kernels.

1. **Integrate by slabs** (K3). The monolithic integrate against a loop
   over ``--slabs`` z-slabs that skips a slab the visibility gate says
   is hidden, at 8/8, 4/8 and 1/8 of the slabs visible: does a per-slab
   gate beat streaming every voxel? JAX gates each slab with
   ``lax.cond`` on the device; eager PyTorch reads the gate vector on
   the host once a call and runs only the visible slabs, which is the
   counterpart (and is why those rows are eager readings: a graph cannot
   branch on a value). With every slab visible the slab loop equals
   ``integrate`` bit for bit (asserted). Then the frustum-culled block
   integrate (``integrate_blocks``, one host read a call) over JAX's
   grids 8x8x1, 8x8x2, 8x8x8, 16x16x2 and 16x16x8 with each grid's
   visible blocks, on the bench scene's first frame (the traj2-like
   clip's frame 0, rendered by ``io/synthetic.py`` at 640x480, read at
   ratio 2) from its camera pose.
2. **The ICP's ref-map fetch** (K2F, K5): six channel rows ``[6, HW]``
   gathered at 76,800 indices (``ref_gather_6xHW``) against one
   ``[HW, 8]`` row table read a row an index (``ref_rowgather_HWx8``);
   the values are asserted equal.
3. **The lane gather** (K3's depth lookup): ``torch.gather`` along the
   last axis of a ``[N / 128, 128]`` table (``taa_lane_2M``, JAX's
   ``take_along_axis``) against the flat gather at 2M lookups
   (``gather_flat_2M``); the lane gather is checked against the flat
   gather of the same entries.

Each of JAX's keys holds ms a call: the monolithic integrate and the
gathers are CUDA graph replays (``tools/timing.py:graph_ms``); the slab
and block rows, which read the host, are eager (``per_launch_ms``).
``rows`` holds each key's whole row (``tools/timing.py:timed_row``:
its eager reading, ``host_bound`` and ``route`` too). On the CPU every
probe runs once and is checked; times are null.

Usage: python -m slambench_tpu_torch.tools.probe_r3 [--device cuda]
       [--volume 256] [--slabs 8] [--reps 3] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence

import numpy as np
import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.geometry import rigid_inverse, translation_pose
from slambench_tpu_torch.io.synthetic import (
    SyntheticScene, orbit_trajectory, render_depth_frame,
)
from slambench_tpu_torch.ops.integrate import (
    block_visibility, integrate, integrate_blocks,
)
from slambench_tpu_torch.ops.preprocess import mm2meters
from slambench_tpu_torch.policy import resolve_device, synchronize
from slambench_tpu_torch.tools.timing import Chain, timed_row
from slambench_tpu_torch.utils import backend

H, W = 240, 320
DIM = (4.8, 4.8, 4.8)
MU = 0.1
BLOCK_GRIDS = ((8, 8, 1), (8, 8, 2), (8, 8, 8), (16, 16, 2), (16, 16, 8))
LANES = 128
TWO_M = 2 * 1024 * 1024


def integrate_slabs(tsdf: torch.Tensor, weight: torch.Tensor,
                    depth: torch.Tensor, inv_track: torch.Tensor,
                    K: torch.Tensor, mu: float, max_weight: float,
                    dim, visible: Sequence[bool]):
    """The integrate as a loop over ``len(visible)`` equal z-slabs: a
    visible slab is fused by ``integrate(z_offset=, z_total=)``, a hidden
    one is left as it is. ``visible`` is host booleans (the one host
    read a call)."""
    V = tsdf.shape[0]
    S = len(visible)
    if V % S:
        raise ValueError(f"{V} planes do not split into {S} slabs")
    zs = V // S
    t_out, w_out = [], []
    for i, (ts, ws) in enumerate(zip(tsdf.split(zs), weight.split(zs))):
        if visible[i]:
            ts, ws = integrate(ts, ws, depth, inv_track, K, mu, max_weight,
                               dim, z_offset=i * zs, z_total=V)
        t_out.append(ts)
        w_out.append(ws)
    return torch.cat(t_out), torch.cat(w_out)


def ref_gather_6(idx: torch.Tensor, table6: torch.Tensor) -> torch.Tensor:
    """``[6, *idx.shape]``: each of the six channel rows at ``idx``."""
    return table6[:, idx]


def ref_rowgather_8(idx: torch.Tensor, table8: torch.Tensor
                    ) -> torch.Tensor:
    """``[*idx.shape, 8]``: the 8-wide row at each index."""
    return table8[idx, :]


def lane_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[r, idx[r, c]]`` (``jnp.take_along_axis(..., axis=-1)``)."""
    return torch.gather(table, -1, idx)


def bench_depth(device: torch.device) -> torch.Tensor:
    """The bench scene's first frame (the traj2-like clip's frame 0 at
    640x480) in metres at ratio 2: ``[240, 320]`` float32."""
    init = [f * d for f, d in zip((0.34, 0.5, 0.24), DIM)]
    pose = orbit_trajectory(1, init)[0]
    mm = render_depth_frame(SyntheticScene(dim=DIM), pose,
                            (481.2, 480.0, 320.0, 240.0), (640, 480),
                            device)
    return mm2meters(torch.as_tensor(mm.astype(np.int32), device=device), 2)


def run(device: torch.device, volume: int = 256, slabs: int = 8,
        reps: int = 3, runs: int = 3) -> dict:
    """The three probes; raises if an asserted equality fails."""
    V, S = volume, slabs
    rng = np.random.default_rng(0)
    out = {"backend": device.type, "volume": V, "slabs": S, "rows": {}}

    def measure(key: str, step, reps: int, graph: bool, note: str = ""):
        row = out["rows"][key] = timed_row(
            step, reps, device, "graph replay" if graph
            else "eager (reads the host)", runs, graph=graph)
        out[key] = row["ms"]
        if row["ms"] is not None:
            print(f"{key:28s} {row['ms']:9.3f} ms {note}", file=sys.stderr,
                  flush=True)

    # ---------------- 1. integrate by slabs ------------------------- #
    tsdf0 = torch.full((V, V, V), 32766, dtype=torch.int16, device=device)
    w0 = torch.zeros((V, V, V), dtype=torch.int8, device=device)
    depth = torch.as_tensor((rng.random((H, W)) * 3 + 0.5)
                            .astype(np.float32), device=device)
    inv_track = torch.eye(4, dtype=torch.float32, device=device)
    K = torch.tensor([[240.6, 0, 160, 0], [0, 240.0, 120, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], dtype=torch.float32,
                     device=device)
    args = (depth, inv_track, K, MU, params.MAX_WEIGHT, DIM)
    measure("integrate_monolithic",
            Chain(lambda tw: integrate(*tw, *args), (tsdf0, w0)), reps,
            graph=True)
    whole = integrate(tsdf0, w0, *args)
    for nvis in (S, S // 2, 1):
        vis = (torch.arange(S, device=device) < nvis)

        def slab_step(tw, vis=vis):
            return integrate_slabs(*tw, *args, vis.tolist())

        if nvis == S:
            t, w = slab_step((tsdf0, w0))
            out["slabs_equal_integrate"] = bool(
                torch.equal(t, whole[0]) and torch.equal(w, whole[1]))
            if not out["slabs_equal_integrate"]:
                raise RuntimeError("probe_r3: the slab loop with every "
                                   "slab visible differs from integrate")
        measure(f"integrate_slabs_{nvis}of{S}",
                Chain(slab_step, (tsdf0, w0)), reps, graph=False)
    del whole

    # ------------- 1b. frustum-culled block integrate ---------------- #
    pose = translation_pose([0.34 * DIM[0], 0.5 * DIM[1], 0.24 * DIM[2]],
                            device)
    inv_bench = rigid_inverse(pose)
    depth_b = bench_depth(device)
    out["visible_blocks"] = {}
    for (nz, ny, nx) in BLOCK_GRIDS:
        if V % nz or V % ny or V % nx:
            continue
        vis = block_visibility(nz, ny, DIM, inv_bench, K, depth_b, MU,
                               n_x=nx)
        name = f"integrate_blocks_{nz}x{ny}x{nx}"
        out["visible_blocks"][name] = [int(vis.sum()), vis.numel()]
        step = Chain(lambda tw, g=(nz, ny, nx): integrate_blocks(
            *tw, depth_b, inv_bench, K, MU, params.MAX_WEIGHT, DIM,
            n_z=g[0], n_y=g[1], n_x=g[2]), (tsdf0, w0))
        measure(name, step, reps, graph=False,
                note=f"(visible {int(vis.sum())}/{vis.numel()})")

    # ------------- 2. the ICP's ref-map fetch ------------------------ #
    npix = H * W
    idx2d = torch.as_tensor(rng.integers(0, npix, (H, W)), device=device)
    ref6 = torch.as_tensor(rng.random((6, npix)).astype(np.float32),
                           device=device)
    ref8 = torch.zeros((npix, 8), dtype=torch.float32, device=device)
    ref8[:, :6] = ref6.T
    g6 = ref_gather_6(idx2d, ref6)
    g8 = ref_rowgather_8(idx2d, ref8)
    out["ref_fetch_equal"] = bool(torch.equal(g6, g8[..., :6]
                                              .permute(2, 0, 1)))
    if not out["ref_fetch_equal"]:
        raise RuntimeError("probe_r3: the [HW, 8] row gather differs from "
                           "the [6, HW] channel gather")
    measure("ref_gather_6xHW", lambda: ref_gather_6(idx2d, ref6), 8,
            graph=True, note="(6 channel rows, 460k elems)")
    measure("ref_rowgather_HWx8", lambda: ref_rowgather_8(idx2d, ref8), 8,
            graph=True, note="(77k rows x 8-elem slices)")

    # ------------- 3. the lane gather against the flat gather -------- #
    tbl = torch.as_tensor(rng.random((TWO_M // LANES, LANES))
                          .astype(np.float32), device=device)
    lane_idx = torch.as_tensor(rng.integers(0, LANES, TWO_M)
                               .reshape(TWO_M // LANES, LANES),
                               device=device)
    flat_idx = torch.as_tensor(rng.integers(0, TWO_M, TWO_M)
                               .reshape(TWO_M // LANES, LANES),
                               device=device)
    rows = torch.arange(TWO_M // LANES, device=device)[:, None] * LANES
    out["lane_equal_flat"] = bool(torch.equal(
        lane_gather(tbl, lane_idx), torch.take(tbl, rows + lane_idx)))
    if not out["lane_equal_flat"]:
        raise RuntimeError("probe_r3: the lane gather differs from the "
                           "flat gather of the same entries")
    measure("taa_lane_2M", lambda: lane_gather(tbl, lane_idx), 4,
            graph=True)
    measure("gather_flat_2M", lambda: torch.take(tbl, flat_idx), 4,
            graph=True)
    for key in ("taa_lane_2M", "gather_flat_2M"):
        out[f"{key}_ns_per_elem"] = None if out[key] is None \
            else out[key] * 1e6 / TWO_M
    synchronize(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda[:N]; default: SLAMBENCH_PLATFORM and "
                         "SLAMBENCH_DEVICE, else cuda")
    ap.add_argument("--volume", type=int, default=256)
    ap.add_argument("--slabs", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    out = run(resolve_device(backend.device_name(args.device)), args.volume,
              args.slabs, args.reps)
    text = json.dumps(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
