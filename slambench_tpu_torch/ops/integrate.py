"""TSDF volume integration (port of ``slambench_tpu/ops/integrate.py``:
``integrate``, ``block_visibility`` and ``integrate_blocks``; reference:
cpp/kernels.cpp:628-673).

Plain torch: every voxel's camera-space position in closed form, one
depth gather, the running-average update (``_update``). ``integrate``
runs it over the whole ``[Z, Y, X]`` grid; ``integrate_blocks`` first
culls the (z, y, x) blocks that ``block_visibility`` proves the update
cannot touch and runs it on the visible blocks' voxels only. On the
H100 this op becomes the hand kernel K3 in a later change.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.casts import f32_to_i32
from slambench_tpu_torch.geometry import mat4mul
from slambench_tpu_torch.volume import Dim3, pack_tsdf, voxel_centers_axis

# integrate_blocks calls, and the visible and all blocks they saw, since
# the last reset (chip_smoke.py reads them).
block_counts = {"calls": 0, "visible": 0, "blocks": 0}


def _z_centers(sz: int, dim_z: float, z_offset: int, z_total: int,
               device) -> torch.Tensor:
    """World z of the local planes' centres: plane ``z`` is global plane
    ``z + z_offset`` of a ``z_total``-deep volume (0: the volume is
    whole)."""
    if z_total:
        return (torch.arange(sz, dtype=torch.float32, device=device)
                + z_offset + 0.5) * (dim_z / z_total)
    return voxel_centers_axis(sz, dim_z, device)


def _update(tsdf: torch.Tensor, weight: torch.Tensor, X: torch.Tensor,
            Y: torch.Tensor, Z: torch.Tensor, depth: torch.Tensor,
            M: torch.Tensor, K: torch.Tensor, mu: float, max_weight: float,
            gate: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-voxel update at world centres ``X``, ``Y``, ``Z`` (which
    broadcast to the shape of ``tsdf`` / ``weight``): new (tsdf,
    weight). Elementwise, so a voxel gets the same bits whatever set of
    voxels it is updated with."""
    H, W = depth.shape
    px = M[0, 0] * X + M[0, 1] * Y + M[0, 2] * Z + M[0, 3]
    py = M[1, 0] * X + M[1, 1] * Y + M[1, 2] * Z + M[1, 3]
    pz = M[2, 0] * X + M[2, 1] * Y + M[2, 2] * Z + M[2, 3]

    cx = K[0, 0] * px + K[0, 1] * py + K[0, 2] * pz + K[0, 3]
    cy = K[1, 0] * px + K[1, 1] * py + K[1, 2] * pz + K[1, 3]
    cz = K[2, 0] * px + K[2, 1] * py + K[2, 2] * pz + K[2, 3]

    u = cx / cz + 0.5
    v = cy / cz + 0.5

    in_front = pz >= 1e-4
    in_img = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)

    ui = torch.clamp(f32_to_i32(u), 0, W - 1)
    vi = torch.clamp(f32_to_i32(v), 0, H - 1)
    d = depth.reshape(-1)[(vi * W + ui).long()]

    corr = torch.sqrt(1.0 + (px / pz) ** 2 + (py / pz) ** 2)
    diff = (d - cz) * corr

    update = in_front & in_img & (d != 0) & (diff > -mu)
    if gate is not None:
        update = update & gate

    sdf = torch.clamp(diff / mu, max=1.0)
    w = weight.to(torch.float32)
    val = tsdf.to(torch.float32) * params.TSDF_INV_SCALE
    new_val = torch.clamp((w * val + sdf) / (w + 1.0), -1.0, 1.0)
    new_w = torch.clamp(w + 1.0, max=max_weight)

    tsdf_out = torch.where(update, pack_tsdf(new_val), tsdf)
    weight_out = torch.where(update, new_w.to(weight.dtype), weight)
    return tsdf_out, weight_out


def integrate(tsdf: torch.Tensor,
              weight: torch.Tensor,
              depth: torch.Tensor,
              inv_track: torch.Tensor,
              K: torch.Tensor,
              mu: float,
              max_weight: float = params.MAX_WEIGHT,
              dim: Dim3 = (2.0, 2.0, 2.0),
              gate: Optional[torch.Tensor] = None,
              z_offset: int = 0,
              z_total: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse one depth frame into the TSDF; returns new (tsdf, weight).

    Per voxel: skip if camera z < 1e-4, the projection falls outside the
    image, or depth == 0; else diff = (depth - z) * norm_correction and,
    if diff > -mu, value <- clamp((w*v + min(1, diff/mu)) / (w+1), -1, 1),
    w <- min(w + 1, maxweight).

    ``gate`` (a 0-d bool tensor) is the device-side counterpart of JAX's
    ``lax.cond`` around the update: it joins the voxel mask, so where it
    is false no voxel changes and the host reads nothing.

    ``z_offset`` / ``z_total`` fuse into a z-slab (the sharded step,
    ``parallel/step.py``): local plane ``z`` is centred at global plane
    ``z + z_offset`` of a ``z_total``-deep volume (JAX's ``integrate``
    arguments of the same names); with ``z_total`` 0 the volume is
    whole."""
    sz, sy, sx = tsdf.shape
    dev = tsdf.device
    X = voxel_centers_axis(sx, dim[0], dev)[None, None, :]
    Y = voxel_centers_axis(sy, dim[1], dev)[None, :, None]
    Z = _z_centers(sz, dim[2], z_offset, z_total, dev)[:, None, None]
    return _update(tsdf, weight, X, Y, Z, depth, inv_track, K, mu,
                   max_weight, gate)


def block_visibility(n_z: int, n_y: int, dim: Dim3,
                     inv_track: torch.Tensor, K: torch.Tensor,
                     depth: torch.Tensor, mu: float,
                     z0_world: float = 0.0,
                     z1_world: Optional[float] = None,
                     n_x: int = 1) -> torch.Tensor:
    """[n_z * n_y * n_x] bool, (z, y, x) block order: False only where
    the block provably holds no voxel the integrate update can touch
    (JAX ``block_visibility``).

    Each frustum face is a half-space linear in camera coordinates, so
    a block whose 8 AABB corners all lie outside one face has no voxel
    inside it: near (``pz >= 1e-4``), the image's four sides (``0 <= u
    <= W-1``, ``0 <= v <= H-1`` as linear forms in (cx, cy, cz)), and
    far (``diff > -mu`` needs ``cz < max(depth) + mu``). The corners go
    through the fused ``K @ inv_track`` while ``integrate`` projects in
    two stages, so each face keeps JAX's slack (1e-5 m on near and far,
    0.5 pixel*m on the image forms): a voxel within it keeps its block.
    ``z0_world`` / ``z1_world`` bound the local z extent (a slab); by
    default the whole volume."""
    H, W = depth.shape
    dev = depth.device
    if z1_world is None:
        z1_world = dim[2]

    def edges(lo, hi, n):
        return lo + torch.arange(n + 1, dtype=torch.float32,
                                 device=dev) * ((hi - lo) / n)

    ez = edges(z0_world, z1_world, n_z)
    ey = torch.arange(n_y + 1, dtype=torch.float32, device=dev) \
        * (dim[1] / n_y)
    ex = torch.arange(n_x + 1, dtype=torch.float32, device=dev) \
        * (dim[0] / n_x)
    zc = torch.stack([ez[:-1], ez[1:]], -1)                 # [n_z, 2]
    yc = torch.stack([ey[:-1], ey[1:]], -1)
    xc = torch.stack([ex[:-1], ex[1:]], -1)

    M = mat4mul(K, inv_track)
    # Corners broadcast to [n_z, n_y, n_x, 2(z), 2(y), 2(x)].
    Z = zc[:, None, None, :, None, None]
    Y = yc[None, :, None, None, :, None]
    X = xc[None, None, :, None, None, :]
    cx = M[0, 0] * X + M[0, 1] * Y + M[0, 2] * Z + M[0, 3]
    cy = M[1, 0] * X + M[1, 1] * Y + M[1, 2] * Z + M[1, 3]
    cz = M[2, 0] * X + M[2, 1] * Y + M[2, 2] * Z + M[2, 3]

    dmax = torch.max(depth)
    eps_z = 1e-5                # near/far slack (metres)
    eps_i = 0.5                 # image-face slack (pixel*m forms)
    corner_ok = torch.stack([
        cz >= 1e-4 - eps_z,                                 # near
        cz < dmax + mu + eps_z,                             # far
        cx + 0.5 * cz >= -eps_i,                            # u >= 0
        (W - 1.5) * cz - cx >= -eps_i,                      # u <= W-1
        cy + 0.5 * cz >= -eps_i,                            # v >= 0
        (H - 1.5) * cz - cy >= -eps_i,                      # v <= H-1
    ])
    any_corner = corner_ok.reshape(6, n_z, n_y, n_x, 8).any(-1)
    return any_corner.all(0).reshape(n_z * n_y * n_x)


def integrate_blocks(tsdf: torch.Tensor,
                     weight: torch.Tensor,
                     depth: torch.Tensor,
                     inv_track: torch.Tensor,
                     K: torch.Tensor,
                     mu: float,
                     max_weight: float = params.MAX_WEIGHT,
                     dim: Dim3 = (2.0, 2.0, 2.0),
                     n_z: int = 8,
                     n_y: int = 1,
                     n_x: int = 1,
                     z_offset: int = 0,
                     z_total: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frustum-culled integrate over an ``n_z x n_y x n_x`` block grid
    (JAX ``integrate_blocks``): returns new (tsdf, weight), bit for bit
    ``integrate``'s.

    JAX walks the blocks in a ``fori_loop`` with a ``lax.cond`` a block.
    Here one host read a call (the visible blocks, ``torch.nonzero``)
    sizes one pass: the volume is copied block-major (``[blocks, bz, by,
    bx]``), the visible blocks are gathered whole, updated at their
    voxels' world centres (taken from the axis centres), written back
    with ``index_put_`` and the copy is laid out as the volume again. The
    arithmetic is ``integrate``'s, elementwise, so a visible voxel gets
    ``integrate``'s bits, and the cull leaves only voxels it cannot
    touch. ``z_offset`` / ``z_total`` as in ``integrate``; a grid that
    does not divide the volume raises ``ValueError``."""
    sz, sy, sx = tsdf.shape
    if sz % n_z or sy % n_y or sx % n_x:
        raise ValueError(f"volume {tuple(tsdf.shape)} not divisible into "
                         f"{n_z}x{n_y}x{n_x} (z, y, x) blocks")
    bz, by, bx = sz // n_z, sy // n_y, sx // n_x
    dev = tsdf.device
    vz = dim[2] / (z_total or sz)
    visible = block_visibility(n_z, n_y, dim, inv_track, K, depth, mu,
                               z0_world=z_offset * vz,
                               z1_world=(z_offset + sz) * vz, n_x=n_x)
    ids = torch.nonzero(visible).reshape(-1)
    block_counts["calls"] += 1
    block_counts["visible"] += ids.numel()
    block_counts["blocks"] += visible.numel()
    if ids.numel() == 0:
        return tsdf, weight

    def to_blocks(v):
        # A copy always (clone), so the update leaves the input alone.
        return v.reshape(n_z, bz, n_y, by, n_x, bx).permute(
            0, 2, 4, 1, 3, 5).clone(memory_format=torch.contiguous_format
                                    ).reshape(-1, bz, by, bx)

    def from_blocks(b):
        return b.reshape(n_z, n_y, n_x, bz, by, bx).permute(
            0, 3, 1, 4, 2, 5).reshape(sz, sy, sx)

    zs = _z_centers(sz, dim[2], z_offset, z_total, dev).reshape(n_z, bz)
    ys = voxel_centers_axis(sy, dim[1], dev).reshape(n_y, by)
    xs = voxel_centers_axis(sx, dim[0], dev).reshape(n_x, bx)
    Z = zs[ids // (n_y * n_x)][:, :, None, None]
    Y = ys[(ids // n_x) % n_y][:, None, :, None]
    X = xs[ids % n_x][:, None, None, :]
    t_blocks, w_blocks = to_blocks(tsdf), to_blocks(weight)
    t_new, w_new = _update(t_blocks[ids], w_blocks[ids], X, Y, Z, depth,
                           inv_track, K, mu, max_weight, None)
    t_blocks[ids] = t_new
    w_blocks[ids] = w_new
    return from_blocks(t_blocks), from_blocks(w_blocks)
