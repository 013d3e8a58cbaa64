"""Accelerated raycast: min-mip empty-space skipping, nearest-sample
marching and trilinear rescan/false-position refinement (port of
``slambench_tpu/ops/raycast_fast.py``, plain torch; on the H100 this
becomes the hand kernel K4 in a later change).

Ported: ``make_min_mip``, ``make_skip_mip``, ``mip_march``,
``march_two_phase``, ``rescan_refine``, ``raycast_fast_maps`` with its
``t_init`` warm start, ``warm_start_bound``, and the ``SLAMBENCH_*``
knobs of the march (``read_knobs``). Left out: the concatenated
volume++skip gather table, which exists to halve the TPU's gather ops;
here the two lookups are two indexing ops.

**Knobs.** ``read_knobs`` parses JAX's variables with JAX's names,
defaults and clamps, once, at import (``MIP_BLOCK``, ``SKIP_MAX_D``,
``MARCH_UNROLL``, ``MARCH_COMPACT``, ``MARCH_PHASE1``,
``MARCH_SLOT_FRAC``, ``RAYCAST_NSCAN``, ``RAYCAST_REFINE_ITERS``); each
function also takes its knob as a parameter that defaults to the
constant. A value that is not an integer, a ``MARCH_COMPACT`` other
than 0 or 1, or a value no march can run with (a mip cell under one
voxel, no rescan step, a negative count) raises ``ValueError`` naming
the variable.

**Budget and routes.** Both routes march the JAX default path's
budget: ``MARCH_PHASE1`` substeps and then ``max_iters`` more, each
rounded up to whole ``MARCH_UNROLL`` groups, with the "any ray live"
test every group. The per-frame route (``early_exit=True``) runs
``march_two_phase`` when ``MARCH_COMPACT`` is on and ``MARCH_PHASE1 <
max_iters`` (JAX's test): phase 1 at full width, one host read of the
live count, then nothing more, the live rays compacted into a small
set of slots, or the rest at full width. Every other case runs the
single-phase ``mip_march`` over the same budget. With ``early_exit=
False`` (the CUDA graph route, ``graphs.py``) the march is single-phase
and runs its whole budget with no host read: a graph cannot branch on
the live count. A finished ray is frozen by its masks and the per-ray
arithmetic is elementwise, so every route gives the same bits.

**Counters** (since the last ``reset_counters``): ``march_calls``
raycast marches, ``march_substeps`` substeps they ran (both phases),
and ``march_counts``: substeps and ray-substeps (rays x substeps, the
lockstep work) of phase 1 (full width; a single-phase march counts
here) and of phase 2 (the compacted slots, or full width), and how
often each phase-2 branch was taken (``none``, ``compact``, ``full``).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from slambench_tpu_torch import params
from slambench_tpu_torch.geometry import constant, length3, normalize3
from slambench_tpu_torch.ops.raycast import camera_rays, ray_box_clip
from slambench_tpu_torch.volume import Dim3, grad, interp


def _env_int(env: Mapping[str, str], name: str, default: int,
             least: Optional[int] = None) -> int:
    raw = env.get(name, str(default))
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: not an integer") from None
    if least is not None and value < least:
        raise ValueError(f"{name}={raw!r}: must be at least {least}")
    return value


def read_knobs(env: Optional[Mapping[str, str]] = None) -> dict:
    """The march's ``SLAMBENCH_*`` knobs from ``env`` (default
    ``os.environ``), as JAX's ``raycast_fast.py`` reads them (lines
    48, 75, 236, 250-252, 417-418): ``MARCH_UNROLL`` and
    ``MARCH_SLOTS`` clamped to at least 1, ``MARCH_COMPACT`` on at
    "1"."""
    env = os.environ if env is None else env
    compact = env.get("SLAMBENCH_MARCH_COMPACT", "1")
    if compact not in ("0", "1"):
        raise ValueError(f"SLAMBENCH_MARCH_COMPACT={compact!r}: use 0 or 1")
    return {
        "MIP_BLOCK": _env_int(env, "SLAMBENCH_MIP_BLOCK", 8, 1),
        "SKIP_MAX_D": _env_int(env, "SLAMBENCH_SKIP_MAX_D", 7, 0),
        "MARCH_UNROLL": max(1, _env_int(env, "SLAMBENCH_MARCH_UNROLL", 4)),
        "MARCH_COMPACT": compact == "1",
        "MARCH_PHASE1": _env_int(env, "SLAMBENCH_MARCH_PHASE1", 24, 0),
        "MARCH_SLOT_FRAC": max(1, _env_int(env, "SLAMBENCH_MARCH_SLOTS", 8)),
        "RAYCAST_NSCAN": _env_int(env, "SLAMBENCH_RAYCAST_NSCAN", 4, 1),
        "RAYCAST_REFINE_ITERS": _env_int(env, "SLAMBENCH_RAYCAST_REFINE",
                                         2, 0),
    }


_KNOBS = read_knobs()
MIP_BLOCK = _KNOBS["MIP_BLOCK"]
SKIP_MAX_D = _KNOBS["SKIP_MAX_D"]
MARCH_UNROLL = _KNOBS["MARCH_UNROLL"]
MARCH_COMPACT = _KNOBS["MARCH_COMPACT"]
MARCH_PHASE1 = _KNOBS["MARCH_PHASE1"]
MARCH_SLOT_FRAC = _KNOBS["MARCH_SLOT_FRAC"]
RAYCAST_NSCAN = _KNOBS["RAYCAST_NSCAN"]
RAYCAST_REFINE_ITERS = _KNOBS["RAYCAST_REFINE_ITERS"]

# Counters since the last reset_counters() (chip_smoke.py and
# tools/march_census.py read them).
march_calls = 0
march_substeps = 0
march_counts: dict = {}


def reset_counters() -> None:
    global march_calls, march_substeps
    march_calls = march_substeps = 0
    march_counts.clear()
    march_counts.update(phase1_substeps=0, phase2_substeps=0,
                        phase1_ray_substeps=0, phase2_ray_substeps=0,
                        none=0, compact=0, full=0)


reset_counters()


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


def make_min_mip(tsdf: torch.Tensor, m: int = MIP_BLOCK) -> torch.Tensor:
    """Overlapped min-pool of the raw int16 TSDF: cell (i,j,k) holds the
    min over voxels [i*m, i*m+m] per axis (inclusive upper edge), padding
    32767 past the far face. Torch has no int16 min-pool, so the windows
    run on an exact float32 copy."""
    out = tsdf.to(torch.float32)
    for axis in range(3):
        out = _min_pool_axis(out, axis, m + 1, m, m, 32767.0)
    return out.to(torch.int16)


def make_skip_mip(mip: torch.Tensor, max_d: int = SKIP_MAX_D
                  ) -> torch.Tensor:
    """Chebyshev distance (in cells, capped at ``max_d``) from each mip
    cell to the nearest cell that may hold a crossing (``mip < 0``)."""
    big = float(max_d)
    dist = torch.where(mip < 0, 0.0, big).to(torch.float32)
    for _ in range(max_d - 1):
        nb = -F.max_pool3d(-F.pad(dist[None, None], [1] * 6, value=big),
                           kernel_size=3, stride=1)[0, 0]
        dist = torch.minimum(dist, nb + 1.0)
    return dist.to(torch.int8)


def mip_march(sample_t, dist_exit_t, tnear: torch.Tensor,
              tfar: torch.Tensor, step: float, large_step: float,
              budget: int, early_exit: bool = True,
              unroll: int = MARCH_UNROLL, init: Optional[dict] = None,
              phase: int = 1) -> dict:
    """The skip-table nearest-sample march (JAX ``mip_march``): the same
    masked substep, run ``unroll`` substeps at a time while any ray is
    live, up to ``budget`` substeps (rounded up to whole groups).
    ``early_exit=False`` runs the whole budget with no host read; every
    write is gated by ``cont = live & ~is_hit``, so a done ray does not
    change and the result is the early-exit march's, bit for bit.

    ``init`` resumes from a march state (``march_two_phase``'s second
    phase) instead of starting at ``tnear``. The substeps run are added
    to the counters of ``phase`` (1 or 2); a phase-1 march counts as one
    march call. Returns the state dict (t, t_prev, f_prev, stepsize,
    done, hit)."""
    global march_calls, march_substeps
    if init is None:
        f_t0, _ = sample_t(tnear)
        marching = (tnear < tfar) & (f_t0 > 0)
        s = dict(t=tnear, t_prev=tnear, f_prev=f_t0,
                 stepsize=torch.full_like(tnear, large_step),
                 done=~marching, hit=torch.zeros_like(marching))
    else:
        s = dict(init)

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
        for _ in range(unroll):
            s = substep(s)
        iters += unroll
    march_calls += phase == 1
    march_substeps += iters
    march_counts[f"phase{phase}_substeps"] += iters
    march_counts[f"phase{phase}_ray_substeps"] += iters * tnear.numel()
    return s


def march_two_phase(make_samplers, direction: torch.Tensor,
                    tnear: torch.Tensor, tfar: torch.Tensor, step: float,
                    large_step: float, budget1: int, budget2: int,
                    unroll: int = MARCH_UNROLL,
                    slot_frac: int = MARCH_SLOT_FRAC) -> dict:
    """The early-exit march in two phases (JAX ``march_two_phase``):
    ``budget1`` substeps at full width, then one host read of the live
    count (JAX's ``lax.cond``) and one of three branches:

    * no ray live: stop;
    * at most ``slots = max(128, ceil(npix / slot_frac) // 128 * 128)``
      live: the live rays, in ray order, go into ``slots`` lanes (the
      rest done), march up to ``budget2`` more substeps there with the
      samplers rebuilt on their directions (``make_samplers(dirs)``),
      and ``t``, ``t_prev`` and ``hit`` are scattered back;
    * more: up to ``budget2`` more substeps at full width.

    The per-ray arithmetic is elementwise on gathered state, so every
    branch gives the single-phase march's bits. Returns the fields
    ``rescan_refine`` reads (t, t_prev, hit)."""
    sample_t, dist_exit_t = make_samplers(direction)
    out = mip_march(sample_t, dist_exit_t, tnear, tfar, step, large_step,
                    budget1, unroll=unroll)
    live = ~out["done"]
    npix = live.numel()
    slots = max(128, -(-npix // slot_frac) // 128 * 128)
    n_live = int(live.sum())
    if n_live == 0:
        march_counts["none"] += 1
        return out
    if n_live > slots:
        march_counts["full"] += 1
        return mip_march(sample_t, dist_exit_t, tnear, tfar, step,
                         large_step, budget2, unroll=unroll, init=out,
                         phase=2)
    march_counts["compact"] += 1
    dev = live.device
    lv = live.reshape(-1)
    # Slot of each live ray by prefix sum; dead rays land in a bin past
    # the slots, which is dropped.
    dest = torch.where(lv, torch.cumsum(lv, 0) - 1,
                       torch.full_like(lv, slots, dtype=torch.long))
    ids = torch.full((slots + 1,), npix, dtype=torch.long, device=dev)
    ids.scatter_(0, dest, torch.arange(npix, dtype=torch.long, device=dev))
    ids = ids[:slots].reshape(-1, 128)          # [slots/128, 128] ray ids
    pad = ids >= npix
    safe = torch.clamp(ids, max=npix - 1)
    sub = {k: out[k].reshape(-1)[safe] for k in
           ("t", "t_prev", "f_prev", "stepsize", "done", "hit")}
    sub["done"] = sub["done"] | pad
    s2, de2 = make_samplers(direction.reshape(3, -1)[:, safe])
    o2 = mip_march(s2, de2, sub["t"], tfar.reshape(-1)[safe], step,
                   large_step, budget2, unroll=unroll, init=sub, phase=2)
    back = ids.reshape(-1)

    def scatter(full, vals):
        # Padded slots write into one spare element past the rays.
        ext = torch.cat([full.reshape(-1), full.new_zeros(1)])
        ext.index_copy_(0, back, vals.reshape(-1))
        return ext[:npix].reshape(full.shape)

    return dict(t=scatter(out["t"], o2["t"]),
                t_prev=scatter(out["t_prev"], o2["t_prev"]),
                hit=scatter(out["hit"], o2["hit"]))


def rescan_refine(tri_t, tri_batch, out: dict, step: float,
                  nscan: int = RAYCAST_NSCAN,
                  fp_iters: int = RAYCAST_REFINE_ITERS) -> torch.Tensor:
    """Re-bracket the crossing on the trilinear field over [t_prev,
    t + step] with ``nscan`` uniform steps, then ``fp_iters``
    false-position iterations. Returns t_hit (0 where no hit)."""
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

    for _ in range(fp_iters):
        tm = secant(t0, f0, t1, f1)
        fm = tri_t(tm)
        neg = fm < 0
        t0, f0, t1, f1 = (torch.where(neg, t0, tm), torch.where(neg, f0, fm),
                          torch.where(neg, tm, t1), torch.where(neg, fm, f1))
    t_hit = torch.where(found, secant(t0, f0, t1, f1), out["t"])
    return torch.where(hit, t_hit, torch.zeros_like(t_hit))


def march_samplers(tsdf: torch.Tensor, mip: torch.Tensor, dim: Dim3,
                   origin: torch.Tensor, step: float, m: int = MIP_BLOCK,
                   max_d: int = SKIP_MAX_D):
    """``make_samplers(dirs) -> (sample_t, dist_exit_t)``: the march's
    two per-t lookups for rays from ``origin`` [3] along ``dirs``
    [3, a, b] (the whole grid, or ``march_two_phase``'s compacted
    stragglers): ``sample_t(t)`` gives the nearest voxel's TSDF and the
    chebyshev skip distance of its mip cell, ``dist_exit_t(t, d)`` the
    exit of the ball of ``d - 1`` empty cells around it. ``mip`` is
    built with cell edge ``m``."""
    sz, sy, sx = tsdf.shape
    dev = tsdf.device
    o = origin.reshape(3, 1, 1)
    voxel = constant((dim[0] / sx, dim[1] / sy, dim[2] / sz), torch.float32,
                     dev).reshape(3, 1, 1)
    limit = constant((sx - 1, sy - 1, sz - 1), torch.int32,
                     dev).reshape(3, 1, 1)
    flat_vol = tsdf.reshape(-1)
    mzb, myb, mxb = mip.shape
    flat_skip = make_skip_mip(mip, max_d).reshape(-1)

    def voxel_idx(pos):
        return torch.clamp(torch.clamp((pos / voxel).to(torch.int32), min=0),
                           max=limit)

    def make_samplers(dirs):
        def sample_t(t):
            idx = voxel_idx(o + dirs * t[None])
            vflat = (idx[2].long() * sy + idx[1]) * sx + idx[0]
            b = idx // m
            bx = torch.clamp(b[0], 0, mxb - 1)
            by = torch.clamp(b[1], 0, myb - 1)
            bz = torch.clamp(b[2], 0, mzb - 1)
            sflat = (bz.long() * myb + by) * mxb + bx
            return (flat_vol[vflat].to(torch.float32)
                    * params.TSDF_INV_SCALE,
                    flat_skip[sflat].to(torch.int32))

        def dist_exit_t(t, d):
            pos = o + dirs * t[None]
            b = (voxel_idx(pos) // m).to(torch.float32)
            r = (d - 1).to(torch.float32)
            cell_lo = (b - r) * (m * voxel)
            cell_hi = (b + r + 1.0) * (m * voxel)
            dd = torch.where(dirs == 0, 1e-20, dirs)
            t_axis = torch.where(dd > 0, (cell_hi - pos) / dd,
                                 (cell_lo - pos) / dd)
            dt = torch.minimum(torch.minimum(t_axis[0], t_axis[1]),
                               t_axis[2])
            return t + torch.clamp(dt, min=0.0) + 0.25 * step

        return sample_t, dist_exit_t

    return make_samplers


def march_budgets(dim: Dim3, shape, step: float, large_step: float,
                  near_plane: float, far_plane: float, m: int = MIP_BLOCK,
                  phase1: int = MARCH_PHASE1, unroll: int = MARCH_UNROLL):
    """(JAX's ``max_iters``, phase 1's and phase 2's substep budgets,
    each rounded up to whole ``unroll`` groups) of a volume of ``shape``
    [Z, Y, X]."""
    diag = (dim[0] ** 2 + dim[1] ** 2 + dim[2] ** 2) ** 0.5
    max_iters = int(diag / (m * min(dim) / max(shape))) \
        + int(3.0 * (0.8 / 0.75) * large_step / step) \
        + int((far_plane - near_plane) / large_step) + 16
    return (max_iters, -(-phase1 // unroll) * unroll,
            -(-max_iters // unroll) * unroll)


def raycast_fast(tsdf: torch.Tensor, mip: torch.Tensor, dim: Dim3,
                 view: torch.Tensor, image_size: Tuple[int, int],
                 near_plane: float, far_plane: float, step: float,
                 large_step: float, t_init: Optional[torch.Tensor] = None,
                 early_exit: bool = True, *, m: int = MIP_BLOCK,
                 max_d: int = SKIP_MAX_D, nscan: int = RAYCAST_NSCAN,
                 fp_iters: int = RAYCAST_REFINE_ITERS,
                 compact: bool = MARCH_COMPACT, phase1: int = MARCH_PHASE1,
                 slot_frac: int = MARCH_SLOT_FRAC,
                 unroll: int = MARCH_UNROLL
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hit positions [3, H, W] (0 where no hit) and hit distances.

    ``t_init`` (optional, [H, W]) is a per-ray lower bound on the hit
    distance, the temporal warm start (``warm_start_bound``): marching
    starts at ``max(tnear, t_init)``, capped at ``tfar``. ``early_exit``
    picks the route (module docstring); the keyword knobs default to the
    ``SLAMBENCH_*`` constants (``mip`` must be built with the same
    ``m``)."""
    origin, direction = camera_rays(view, image_size)
    o = origin.reshape(3, 1, 1)
    tnear, tfar = ray_box_clip(origin, direction, dim, near_plane, far_plane)
    if t_init is not None:
        tnear = torch.minimum(torch.maximum(tnear, t_init), tfar)
    make_samplers = march_samplers(tsdf, mip, dim, origin, step, m, max_d)

    def tri_t(t):
        return interp(tsdf, dim, o + direction * t[None])

    def tri_batch(ts):
        return interp(tsdf, dim, o.reshape(3, 1, 1, 1)
                      + direction[:, None] * ts[None])

    max_iters, budget1, budget2 = march_budgets(
        dim, tsdf.shape, step, large_step, near_plane, far_plane, m, phase1,
        unroll)
    if early_exit and compact and phase1 < max_iters:
        out = march_two_phase(make_samplers, direction, tnear, tfar, step,
                              large_step, budget1, budget2, unroll,
                              slot_frac)
    else:
        out = mip_march(*make_samplers(direction), tnear, tfar, step,
                        large_step, budget1 + budget2, early_exit, unroll)
    t_hit = rescan_refine(tri_t, tri_batch, out, step, nscan, fp_iters)
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
                      early_exit: bool = True, **knobs
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vertex + normal reference maps and the hit-distance map
    (reference: cpp/kernels.cpp:726-757); ``t_init``, ``early_exit``
    and the keyword knobs as in ``raycast_fast``."""
    hit_pos, t_hit = raycast_fast(tsdf, mip, dim, view, image_size,
                                  near_plane, far_plane, step, large_step,
                                  t_init, early_exit, **knobs)
    g = grad(tsdf, dim, hit_pos)
    glen = length3(g)
    normal = normalize3(g)
    hit = t_hit > 0
    invalid = torch.zeros_like(normal)
    invalid[0] = params.INVALID
    normal = torch.where((hit & (glen != 0))[None], normal, invalid)
    vertex = torch.where(hit[None], hit_pos, torch.zeros_like(hit_pos))
    return vertex, normal, t_hit
