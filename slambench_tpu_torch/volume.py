"""TSDF volume: int16 fixed-point storage, trilinear interpolation and
the central-difference gradient (port of ``slambench_tpu/volume.py``).

Storage is ``tsdf[z, y, x]`` int16 (value * 32766, truncated toward zero)
and ``weight[z, y, x]`` int8, the JAX package's layout. Samplers clamp
indices into range on both sides (reference: commons.h:191-301). The JAX
package's gather workarounds for the TPU (``take_flat``'s 1-D assert and
the ``_vs_many`` stacking) are left out: a GPU gathers per element.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.geometry import constant

Shape3 = Tuple[int, int, int]   # (sx, sy, sz) — reference size order
Dim3 = Tuple[float, float, float]


def init_volume(resolution: Shape3, device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Fresh TSDF: value 1.0 (stored 32766), weight 0
    (reference: cpp/kernels.cpp:147-157)."""
    sx, sy, sz = resolution
    tsdf = torch.full((sz, sy, sx), 32766, dtype=torch.int16, device=device)
    weight = torch.zeros((sz, sy, sx), dtype=torch.int8, device=device)
    return tsdf, weight


def pack_tsdf(value: torch.Tensor) -> torch.Tensor:
    """float TSDF in [-1, 1] -> int16, truncating toward zero like the C
    cast (reference: commons.h:178-179)."""
    return (value * params.TSDF_SCALE).to(torch.int16)


def voxel_centers_axis(size: int, dim: float, device) -> torch.Tensor:
    """World coordinate of voxel centres along one axis:
    ``(i + 0.5) * dim / size`` (reference: commons.h:186-189)."""
    return (torch.arange(size, dtype=torch.float32, device=device) + 0.5) \
        * (dim / size)


def _vs(flat_tsdf: torch.Tensor, shape, x, y, z) -> torch.Tensor:
    """Raw stored value (unscaled) at in-range integer voxel coords."""
    sz, sy, sx = shape
    idx = (z.long() * sy + y.long()) * sx + x.long()
    return flat_tsdf[idx].to(torch.float32)


def _col(values, nd: int, dtype, device) -> torch.Tensor:
    return constant(tuple(values), dtype, device).reshape(3, *([1] * nd))


def _base_factor(tsdf: torch.Tensor, dim: Dim3, pos: torch.Tensor,
                 z_total: int = 0):
    sz, sy, sx = tsdf.shape
    sz = z_total or sz
    nd = pos.dim() - 1
    size = _col([sx, sy, sz], nd, torch.float32, pos.device)
    dim_a = _col(list(dim), nd, torch.float32, pos.device)
    limit = _col([sx - 1, sy - 1, sz - 1], nd, torch.int32, pos.device)
    scaled = pos * size / dim_a - 0.5
    base = torch.floor(scaled)
    factor = scaled - base
    return base.to(torch.int32), factor, limit, size, dim_a


def _clip(v, limit):
    return torch.clamp(v, min=0).minimum(limit)


def _slab_z(z: torch.Tensor, z_offset: int, depth: int) -> torch.Tensor:
    """Global plane ``z`` (already clamped to the whole volume) as an
    index into a slab that holds planes ``[z_offset, z_offset + depth)``,
    clamped into the slab."""
    return torch.clamp(z - z_offset, 0, depth - 1)


def interp(tsdf: torch.Tensor, dim: Dim3, pos: torch.Tensor,
           z_offset: int = 0, z_total: int = 0) -> torch.Tensor:
    """Trilinear TSDF value at world positions ``pos`` ([3, ...])
    (reference: commons.h:191-213).

    With ``z_total`` > 0, ``tsdf`` is a z-slab: its plane ``k`` is plane
    ``k + z_offset`` of a ``z_total``-deep volume (the sharded step's
    halo-extended slab, ``parallel/step.py``); indices clamp to the
    whole volume, then into the slab."""
    base, factor, limit, _, _ = _base_factor(tsdf, dim, pos, z_total)
    lower = _clip(base, limit)
    upper = _clip(base + 1, limit)
    lx, ly, lz = lower[0], lower[1], lower[2]
    ux, uy, uz = upper[0], upper[1], upper[2]
    if z_total:
        lz = _slab_z(lz, z_offset, tsdf.shape[0])
        uz = _slab_z(uz, z_offset, tsdf.shape[0])
    fx, fy, fz = factor[0], factor[1], factor[2]
    flat = tsdf.reshape(-1)
    shp = tsdf.shape

    def vs(x, y, z):
        return _vs(flat, shp, x, y, z)

    v = (((vs(lx, ly, lz) * (1 - fx) + vs(ux, ly, lz) * fx) * (1 - fy)
          + (vs(lx, uy, lz) * (1 - fx) + vs(ux, uy, lz) * fx) * fy) * (1 - fz)
         + ((vs(lx, ly, uz) * (1 - fx) + vs(ux, ly, uz) * fx) * (1 - fy)
            + (vs(lx, uy, uz) * (1 - fx) + vs(ux, uy, uz) * fx) * fy) * fz)
    return v * params.TSDF_INV_SCALE


def grad(tsdf: torch.Tensor, dim: Dim3, pos: torch.Tensor,
         z_offset: int = 0, z_total: int = 0) -> torch.Tensor:
    """Central-difference TSDF gradient at ``pos`` (reference:
    commons.h:215-301): trilinear blend of one-voxel central differences
    over the 32 distinct lattice points of the stencil, scaled by
    ``dim/size * 0.5/32766``. ``z_offset`` / ``z_total`` as in
    ``interp``."""
    base, factor, limit, size, dim_a = _base_factor(tsdf, dim, pos, z_total)
    ll = _clip(base - 1, limit)
    lo = _clip(base, limit)
    up = _clip(base + 1, limit)
    uu = _clip(base + 2, limit)
    fx, fy, fz = factor[0], factor[1], factor[2]
    flat = tsdf.reshape(-1)
    shp = tsdf.shape

    def trilerp(sample):
        c000 = sample(0, 0, 0)
        c100 = sample(1, 0, 0)
        c010 = sample(0, 1, 0)
        c110 = sample(1, 1, 0)
        c001 = sample(0, 0, 1)
        c101 = sample(1, 0, 1)
        c011 = sample(0, 1, 1)
        c111 = sample(1, 1, 1)
        return (((c000 * (1 - fx) + c100 * fx) * (1 - fy)
                 + (c010 * (1 - fx) + c110 * fx) * fy) * (1 - fz)
                + ((c001 * (1 - fx) + c101 * fx) * (1 - fy)
                   + (c011 * (1 - fx) + c111 * fx) * fy) * fz)

    xs = (lo[0], up[0])
    ys = (lo[1], up[1])
    zs = (lo[2], up[2])
    xw = (ll[0], uu[0])
    yw = (ll[1], uu[1])
    zw = (ll[2], uu[2])
    if z_total:
        zs, zw = ([_slab_z(z, z_offset, tsdf.shape[0]) for z in pair]
                  for pair in (zs, zw))
    sel3 = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    C = {k: _vs(flat, shp, xs[k[0]], ys[k[1]], zs[k[2]]) for k in sel3}
    XW = {k: _vs(flat, shp, xw[k[0]], ys[k[1]], zs[k[2]]) for k in sel3}
    YW = {k: _vs(flat, shp, xs[k[0]], yw[k[1]], zs[k[2]]) for k in sel3}
    ZW = {k: _vs(flat, shp, xs[k[0]], ys[k[1]], zw[k[2]]) for k in sel3}

    gx = trilerp(lambda i, j, k: (C[1, j, k] - XW[0, j, k]) if i == 0
                 else (XW[1, j, k] - C[0, j, k]))
    gy = trilerp(lambda i, j, k: (C[i, 1, k] - YW[i, 0, k]) if j == 0
                 else (YW[i, 1, k] - C[i, 0, k]))
    gz = trilerp(lambda i, j, k: (C[i, j, 1] - ZW[i, j, 0]) if k == 0
                 else (ZW[i, j, 1] - C[i, j, 0]))

    g = torch.stack([gx, gy, gz])
    scale = dim_a / size * (0.5 * params.TSDF_INV_SCALE)
    return g * scale
