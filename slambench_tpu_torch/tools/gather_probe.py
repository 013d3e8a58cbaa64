"""Gather formulations on the card: the counterpart of
``slambench_tpu/tools/gather_probe.py``, at its shapes.

It times the three gather populations of the frame step through the
hand kernels of ``ops/hopper/gather.py``:

* the integrate's depth lookup, ``--n`` lookups (default 2,097,152) into
  the 240x320 image: ``flat1d_f32`` (G1 on the flat index
  ``vi * W + ui``), ``op2d_f32`` (G4 on ``vi``, ``ui``), ``flat1d_u16``
  (G1 on the uint16 image, widened) and ``flat1d_u16_smem`` (G3: the
  uint16 image in shared memory, converted to metres by IEEE division
  as the JAX package's ``mm2meters``);
* the raycast's volume lookup, ``vol_s16_77k``: 76,800 lookups into the
  int16 256^3 volume (G1);
* the tiny-table lookup (a 512-entry mip level), ``tiny512_gather`` (G1),
  against two plain-torch yardsticks the JAX tool also timed: a one-hot
  matrix product (``tiny512_onehot_mm``, full float32) and a masked sum
  (``tiny512_iota_sum``).

The JAX tool also timed the flat gather with 1-D, 2-D and 3-D index
arrays, because XLA on the TPU lowered them very differently. A CUDA
kernel reads a contiguous index as a flat array whatever its shape, so
those lines are one line here, ``flat1d_f32``.

Entries hold the fields of ``tools/mosaic_probe.py``; the yardsticks
carry the gather's bytes and bound, their own time as ``ns_per_elem``,
and no library time. With ``--device cpu`` the plain twins run and every
timing field is null; ``--device cuda`` without a card raises.

Usage: python -m slambench_tpu_torch.tools.gather_probe [--json out.json]
       [--device cuda] [--n 2097152]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from slambench_tpu_torch.ops.hopper import gather
from slambench_tpu_torch.policy import apply_precision_policy, resolve_device
from slambench_tpu_torch.tools.mosaic_probe import (
    H, V, W, generator, randint, report, measure,
)

NPIX = 76_800
TINY = 512


def run(device: torch.device, n: int = 2 * 1024 * 1024,
        seed: int = 0) -> dict:
    apply_precision_policy()
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"), "n": n}
    gen = generator(device, seed)
    rng = np.random.default_rng(seed)
    mm = torch.from_numpy(rng.integers(0, 5000, (H, W)).astype(np.uint16)) \
        .to(device)
    depth = gather.mm_to_meters(mm)
    vi = randint(gen, 0, H, (n,), device)
    ui = randint(gen, 0, W, (n,), device)
    flat = vi * W + ui
    io = 8 * n
    report(out, "flat1d_f32", measure(
        lambda: gather.gather_flat(depth, flat),
        lambda: gather.gather_flat_plain(depth, flat), n,
        io + depth.numel() * 4))
    report(out, "op2d_f32", measure(
        lambda: gather.gather_2d(depth, vi, ui),
        lambda: gather.gather_2d_plain(depth, vi, ui), n,
        io + 4 * n + depth.numel() * 4))
    report(out, "flat1d_u16", measure(
        lambda: gather.gather_flat(mm, flat),
        lambda: gather.gather_flat_plain(mm, flat), n,
        io + mm.numel() * 2))
    report(out, "flat1d_u16_smem", measure(
        lambda: gather.gather_smem_u16(mm, flat),
        lambda: gather.gather_u16_plain(mm, flat), n,
        io + mm.numel() * 2, ops=n))

    npix = min(NPIX, n)
    vol = randint(gen, -32766, 32767, (V ** 3,), device).to(torch.int16)
    vidx = randint(gen, 0, V ** 3, (npix,), device)
    report(out, "vol_s16_77k", measure(
        lambda: gather.gather_flat(vol, vidx),
        lambda: gather.gather_flat_plain(vol, vidx), npix,
        8 * npix + vol.numel() * 2))

    mip = torch.rand(TINY, generator=gen, device=device) * 1000 - 500
    sidx = randint(gen, 0, TINY, (npix,), device)
    tiny_bytes = 8 * npix + TINY * 4
    report(out, "tiny512_gather", measure(
        lambda: gather.gather_flat(mip, sidx),
        lambda: gather.gather_flat_plain(mip, sidx), npix, tiny_bytes))
    iota = torch.arange(TINY, device=device, dtype=torch.int32)

    def onehot_mm():
        return ((sidx[:, None] == iota).to(torch.float32) @ mip[:, None])[:, 0]

    def iota_sum():
        return torch.where(sidx[:, None] == iota, mip, 0.0).sum(dim=1)

    for name, fn in (("tiny512_onehot_mm", onehot_mm),
                     ("tiny512_iota_sum", iota_sum)):
        report(out, name, measure(
            fn, lambda: gather.gather_flat_plain(mip, sidx), npix,
            tiny_bytes, twin_is_library=False))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2 * 1024 * 1024,
                    help="lookups of the depth-image lines (the 76,800-"
                         "lookup lines are capped at it too)")
    args = ap.parse_args(argv)
    out = run(resolve_device(args.device), args.n)
    text = json.dumps(out, indent=1)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
