"""Accelerated raycast: min-mip empty-space skipping, nearest-sample
marching and trilinear rescan/false-position refinement (port of
``slambench_tpu/ops/raycast_fast.py``, plain torch; on the H100 this
becomes the hand kernel K4 in a later change).

Ported: ``make_min_mip``, ``make_skip_mip``, the single-phase
``mip_march``, ``rescan_refine``, ``raycast_fast_maps`` with its
``t_init`` warm start, and ``warm_start_bound``. Left out, because they
exist for the TPU's lockstep march: ``march_two_phase`` (bit-identical
to the single-phase march by design) and the concatenated volume++skip
gather table.

The march budget is the JAX default path's: ``MARCH_PHASE1`` substeps
plus ``max_iters`` rounded up to ``MARCH_UNROLL``, with the "any ray
live" test every ``MARCH_UNROLL`` substeps. With ``early_exit=False``
the march runs the whole budget and reads nothing on the host (the CUDA
graph route, ``graphs.py``): a finished ray is frozen by its masks, so
both modes give the same bits. ``march_calls`` and ``march_substeps``
count the marches and the substeps they ran.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from slambench_tpu_torch import params
from slambench_tpu_torch.geometry import constant, length3, normalize3
from slambench_tpu_torch.ops.raycast import camera_rays, ray_box_clip
from slambench_tpu_torch.volume import Dim3, grad, interp

MIP_BLOCK = 8
SKIP_MAX_D = 7
MARCH_UNROLL = 4
MARCH_PHASE1 = 24
RAYCAST_NSCAN = 4
RAYCAST_REFINE_ITERS = 2

# Marches and substeps run since the last reset (chip_smoke.py reads
# them to report how far the early exit cuts the budget).
march_calls = 0
march_substeps = 0


def _min_pool_axis(x: torch.Tensor, axis: int, win: int, stride: int,
                   pad_hi: int, pad_value: float) -> torch.Tensor:
    """1-D min-pool of a float [Z, Y, X] tensor along ``axis``, padded
    with ``pad_value`` past the far face."""
    pad = [0] * 6                       # F.pad order: X lo/hi, Y, Z
    pad[2 * (2 - axis) + 1] = pad_hi
    xp = F.pad(x[None, None], pad, value=pad_value)
    k = [1, 1, 1]
    s = [1, 1, 1]
    k[axis] = win
    s[axis] = stride
    return -F.max_pool3d(-xp, kernel_size=k, stride=s)[0, 0]


def make_min_mip(tsdf: torch.Tensor) -> torch.Tensor:
    """Overlapped min-pool of the raw int16 TSDF: cell (i,j,k) holds the
    min over voxels [i*m, i*m+m] per axis (inclusive upper edge), padding
    32767 past the far face. Torch has no int16 min-pool, so the windows
    run on an exact float32 copy."""
    m = MIP_BLOCK
    out = tsdf.to(torch.float32)
    for axis in range(3):
        out = _min_pool_axis(out, axis, m + 1, m, m, 32767.0)
    return out.to(torch.int16)


def make_skip_mip(mip: torch.Tensor) -> torch.Tensor:
    """Chebyshev distance (in cells, capped at ``SKIP_MAX_D``) from each
    mip cell to the nearest cell that may hold a crossing (``mip < 0``)."""
    big = float(SKIP_MAX_D)
    dist = torch.where(mip < 0, 0.0, big).to(torch.float32)
    for _ in range(SKIP_MAX_D - 1):
        nb = -F.max_pool3d(-F.pad(dist[None, None], [1] * 6, value=big),
                           kernel_size=3, stride=1)[0, 0]
        dist = torch.minimum(dist, nb + 1.0)
    return dist.to(torch.int8)


def mip_march(sample_t, dist_exit_t, tnear: torch.Tensor,
              tfar: torch.Tensor, step: float, large_step: float,
              budget: int, early_exit: bool = True) -> dict:
    """The skip-table nearest-sample march (JAX ``mip_march``): same
    masked substep, run ``MARCH_UNROLL`` substeps at a time while any
    ray is live, up to ``budget`` substeps. ``early_exit=False`` runs
    all ``budget`` substeps with no host read; every write is gated by
    ``cont = live & ~is_hit``, so a done ray does not change and the
    result is the early-exit march's, bit for bit."""
    global march_calls, march_substeps
    f_t0, _ = sample_t(tnear)
    marching = (tnear < tfar) & (f_t0 > 0)
    s = dict(t=tnear, t_prev=tnear, f_prev=f_t0,
             stepsize=torch.full_like(tnear, large_step),
             done=~marching, hit=torch.zeros_like(marching))

    def substep(s):
        live = ~s["done"]
        f_tt, d_val = sample_t(s["t"])
        empty = d_val >= 1
        is_hit = live & ~empty & (f_tt < 0.0)
        hit = s["hit"] | is_hit
        new_step = torch.where(f_tt < 0.8, step, s["stepsize"])
        t_step = s["t"] + new_step
        t_skip = torch.maximum(dist_exit_t(s["t"], d_val), t_step)
        t_next = torch.where(empty, t_skip, t_step)
        cont = live & ~is_hit
        occ = cont & ~empty
        t = torch.where(cont, t_next, s["t"])
        return dict(
            t=t,
            t_prev=torch.where(occ, s["t"], s["t_prev"]),
            f_prev=torch.where(occ, f_tt, s["f_prev"]),
            stepsize=torch.where(occ, new_step, s["stepsize"]),
            done=s["done"] | is_hit | (cont & (t >= tfar)),
            hit=hit)

    iters = 0
    while iters < budget and (not early_exit or bool((~s["done"]).any())):
        for _ in range(MARCH_UNROLL):
            s = substep(s)
        iters += MARCH_UNROLL
    march_calls += 1
    march_substeps += iters
    return s


def rescan_refine(tri_t, tri_batch, out: dict, step: float) -> torch.Tensor:
    """Re-bracket the crossing on the trilinear field over [t_prev,
    t + step] with ``RAYCAST_NSCAN`` uniform steps, then
    ``RAYCAST_REFINE_ITERS`` false-position iterations. Returns t_hit
    (0 where no hit)."""
    nscan = RAYCAST_NSCAN
    hit = out["hit"]
    ta = out["t_prev"]
    tb = out["t"] + step
    dtm = (tb - ta) / nscan
    fs = tri_batch(torch.stack([ta + dtm * j if j else ta
                                for j in range(nscan + 1)]))
    f_run = fs[0]
    t0, f0, t1 = ta, f_run, tb
    f1 = torch.zeros_like(f_run)
    found = torch.zeros_like(hit)
    fj = f_run
    for j in range(1, nscan + 1):
        tj = ta + dtm * j
        fj = fs[j]
        cross = ~found & (f_run > 0) & (fj < 0)
        t0 = torch.where(cross, ta + dtm * (j - 1.0), t0)
        f0 = torch.where(cross, f_run, f0)
        t1 = torch.where(cross, tj, t1)
        f1 = torch.where(cross, fj, f1)
        found = found | cross
        f_run = fj
    f1 = torch.where(found, f1, fj)

    def secant(t0, f0, t1, f1):
        denom = f0 - f1
        return t1 + torch.where(denom == 0, 0.0,
                                (t1 - t0) * f1 / denom)

    for _ in range(RAYCAST_REFINE_ITERS):
        tm = secant(t0, f0, t1, f1)
        fm = tri_t(tm)
        neg = fm < 0
        t0, f0, t1, f1 = (torch.where(neg, t0, tm), torch.where(neg, f0, fm),
                          torch.where(neg, tm, t1), torch.where(neg, fm, f1))
    t_hit = torch.where(found, secant(t0, f0, t1, f1), out["t"])
    return torch.where(hit, t_hit, torch.zeros_like(t_hit))


def raycast_fast(tsdf: torch.Tensor, mip: torch.Tensor, dim: Dim3,
                 view: torch.Tensor, image_size: Tuple[int, int],
                 near_plane: float, far_plane: float, step: float,
                 large_step: float, t_init: Optional[torch.Tensor] = None,
                 early_exit: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hit positions [3, H, W] (0 where no hit) and hit distances.

    ``t_init`` (optional, [H, W]) is a per-ray lower bound on the hit
    distance, the temporal warm start (``warm_start_bound``): marching
    starts at ``max(tnear, t_init)``, capped at ``tfar``.
    ``early_exit`` as in ``mip_march``."""
    m = MIP_BLOCK
    sz, sy, sx = tsdf.shape
    dev = tsdf.device
    origin, direction = camera_rays(view, image_size)
    o = origin.reshape(3, 1, 1)
    tnear, tfar = ray_box_clip(origin, direction, dim, near_plane, far_plane)
    if t_init is not None:
        tnear = torch.minimum(torch.maximum(tnear, t_init), tfar)

    voxel = constant((dim[0] / sx, dim[1] / sy, dim[2] / sz), torch.float32,
                     dev).reshape(3, 1, 1)
    limit = constant((sx - 1, sy - 1, sz - 1), torch.int32,
                     dev).reshape(3, 1, 1)
    flat_vol = tsdf.reshape(-1)
    mzb, myb, mxb = mip.shape
    flat_skip = make_skip_mip(mip).reshape(-1)

    def voxel_idx(pos):
        return torch.clamp(torch.clamp((pos / voxel).to(torch.int32), min=0),
                           max=limit)

    def sample_t(t):
        idx = voxel_idx(o + direction * t[None])
        vflat = (idx[2].long() * sy + idx[1]) * sx + idx[0]
        b = idx // m
        bx = torch.clamp(b[0], 0, mxb - 1)
        by = torch.clamp(b[1], 0, myb - 1)
        bz = torch.clamp(b[2], 0, mzb - 1)
        sflat = (bz.long() * myb + by) * mxb + bx
        return (flat_vol[vflat].to(torch.float32) * params.TSDF_INV_SCALE,
                flat_skip[sflat].to(torch.int32))

    def dist_exit_t(t, d):
        pos = o + direction * t[None]
        b = (voxel_idx(pos) // m).to(torch.float32)
        r = (d - 1).to(torch.float32)
        cell_lo = (b - r) * (m * voxel)
        cell_hi = (b + r + 1.0) * (m * voxel)
        dd = torch.where(direction == 0, 1e-20, direction)
        t_axis = torch.where(dd > 0, (cell_hi - pos) / dd,
                             (cell_lo - pos) / dd)
        dt = torch.minimum(torch.minimum(t_axis[0], t_axis[1]), t_axis[2])
        return t + torch.clamp(dt, min=0.0) + 0.25 * step

    def tri_t(t):
        return interp(tsdf, dim, o + direction * t[None])

    def tri_batch(ts):
        return interp(tsdf, dim, o.reshape(3, 1, 1, 1)
                      + direction[:, None] * ts[None])

    diag = (dim[0] ** 2 + dim[1] ** 2 + dim[2] ** 2) ** 0.5
    max_iters = int(diag / (m * min(dim) / max(sx, sy, sz))) \
        + int(3.0 * (0.8 / 0.75) * large_step / step) \
        + int((far_plane - near_plane) / large_step) + 16
    budget = MARCH_PHASE1 + -(-max_iters // MARCH_UNROLL) * MARCH_UNROLL
    out = mip_march(sample_t, dist_exit_t, tnear, tfar, step, large_step,
                    budget, early_exit)
    t_hit = rescan_refine(tri_t, tri_batch, out, step)
    hit_pos = o + direction * t_hit[None]
    hit_pos = torch.where(t_hit[None] > 0, hit_pos, torch.zeros_like(hit_pos))
    return hit_pos, t_hit


def warm_start_bound(prev_t_hit: torch.Tensor, pose_delta: torch.Tensor,
                     far_plane: float = params.FAR_PLANE,
                     large_step: float = 0.075,
                     pool: int = 8) -> torch.Tensor:
    """Per-ray hit-distance lower bound from the previous frame.

    ``prev_t_hit`` is the last raycast's t map (0 = miss); ``pose_delta``
    = ``inv(prev_pose) @ pose``. Misses and pixels near misses get no
    bound (0). The bound is the ``pool`` x ``pool`` block min (covering
    pixel reassociation under small rotations) minus a rigid-motion
    margin ``|t| + |angle| * far + 2*large_step``, conservative for any
    static scene. Both sides of the map must be multiples of ``pool``."""
    H, W = prev_t_hit.shape
    if H % pool or W % pool:
        raise ValueError(f"warm_start_bound: the t map is {H}x{W}; both "
                         f"sides must be multiples of the {pool}x{pool} "
                         "pool")
    trans = torch.linalg.vector_norm(pose_delta[:3, 3])
    # Rotation angle bound from the trace.
    cos_a = torch.clamp((torch.trace(pose_delta[:3, :3]) - 1.0) * 0.5,
                        -1.0, 1.0)
    angle = torch.arccos(cos_a)
    margin = trans + angle * far_plane + 2.0 * large_step

    guarded = torch.where(prev_t_hit > 0, prev_t_hit,
                          torch.zeros_like(prev_t_hit))
    pooled = guarded.reshape(H // pool, pool, W // pool, pool).amin((1, 3))
    up = pooled[:, None, :, None].expand(H // pool, pool, W // pool,
                                         pool).reshape(H, W)
    return torch.clamp(up - margin, min=0.0)


def raycast_fast_maps(tsdf: torch.Tensor, mip: torch.Tensor, dim: Dim3,
                      view: torch.Tensor, image_size: Tuple[int, int],
                      near_plane: float = params.NEAR_PLANE,
                      far_plane: float = params.FAR_PLANE,
                      step: float = 0.0078125, large_step: float = 0.075,
                      t_init: Optional[torch.Tensor] = None,
                      early_exit: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vertex + normal reference maps and the hit-distance map
    (reference: cpp/kernels.cpp:726-757); ``t_init`` and ``early_exit``
    as in ``raycast_fast``."""
    hit_pos, t_hit = raycast_fast(tsdf, mip, dim, view, image_size,
                                  near_plane, far_plane, step, large_step,
                                  t_init, early_exit)
    g = grad(tsdf, dim, hit_pos)
    glen = length3(g)
    normal = normalize3(g)
    hit = t_hit > 0
    invalid = torch.zeros_like(normal)
    invalid[0] = params.INVALID
    normal = torch.where((hit & (glen != 0))[None], normal, invalid)
    vertex = torch.where(hit[None], hit_pos, torch.zeros_like(hit_pos))
    return vertex, normal, t_hit
