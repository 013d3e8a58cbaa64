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

from slambench_tpu_torch.ops.hopper import build, gather
from slambench_tpu_torch.policy import apply_precision_policy, resolve_device
from slambench_tpu_torch.tools.mosaic_probe import (
    H, V, W, generator, randint, report, measure,
)

NPIX = 76_800
TINY = 512


def _unaligned(t: torch.Tensor, shift: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``shift`` elements into a
    fresh buffer (``shift * 4`` bytes past a 16-byte boundary)."""
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    out = buf[shift:].view(t.shape)
    out.copy_(t)
    return out


def edge_cases(device: torch.device, seed: int = 9) -> list:
    """``(name, kernel call, twin call)`` for the inputs that the
    redesigned G1 and G2 take apart from the probes' own shapes: an index
    that does not start on 16 bytes (a slice of a contiguous tensor),
    lookup counts 1, 3 and 4k+3, clamping with indices below -n, in
    [-n, 0), in range and at or above n; G2 tables whose rows or columns
    do not divide its bands, tables smaller than its cluster's split, and
    a two-row table of the full 232,448 bytes. The pairs must be equal."""
    gen = generator(device, seed)
    cases = []

    def g1(name, table, idx, clamp=False):
        cases.append((f"G1 {name}",
                      lambda: gather.gather_flat(table, idx, clamp),
                      lambda: gather.gather_flat_plain(table, idx, clamp)))

    def g2(name, table, idx, mode):
        cases.append((f"G2 {mode} {name}",
                      lambda: gather.gather_axis_smem(table, idx, mode),
                      lambda: gather.gather_axis_plain(table, idx, mode)))

    p1 = torch.rand((256, 128), generator=gen, device=device)
    tables = {"f32": p1,
              "int16": randint(gen, -32766, 32767, (256, 128), device)
              .to(torch.int16),
              "uint16": randint(gen, 0, 65535, (256, 128), device)
              .to(torch.uint16)}
    nt = p1.numel()
    for kind, table in tables.items():
        base = randint(gen, 0, nt, (4099,), device)
        for shift in (1, 2, 3):
            g1(f"{kind} idx[{shift}:]", table, base[shift:])
        for n in (1, 3, 4 * 1000 + 3):
            g1(f"{kind} n={n}", table, randint(gen, 0, nt, (n,), device))
        wide = torch.cat([randint(gen, -3 * nt, -nt, (1000,), device),
                          randint(gen, -nt, 0, (1000,), device),
                          randint(gen, 0, nt, (1000,), device),
                          randint(gen, nt, 3 * nt, (1000,), device),
                          torch.tensor([-nt - 1, -nt, -1, 0, nt - 1, nt,
                                        -2**31, 2**31 - 1],
                                       dtype=torch.int32, device=device)])
        wide = wide[torch.randperm(wide.numel(), generator=gen,
                                   device=device)]
        g1(f"{kind} clip below -n / [-n, 0) / in range / >= n", table,
           wide, True)
        g1(f"{kind} clip, idx[1:]", table, wide[1:], True)
    g1("f32 one-entry table, clip", p1[:1, :1], wide, True)
    if device.type == "cuda":
        # The wrapper puts out at idx's offset within 16 bytes; through
        # the C entry, out at another offset takes the all-scalar way.
        idx = randint(gen, 0, nt, (4099,), device)

        def scalar_way():
            out = torch.empty(idx.numel() + 1, device=device)[1:]
            build.check(build.load().slb_gather_flat(
                p1.data_ptr(), gather.TABLE_TYPES[p1.dtype], idx.data_ptr(),
                out.data_ptr(), idx.numel(), nt, 0,
                torch.cuda.get_device_properties(device)
                .multi_processor_count,
                torch.cuda.current_stream(device).cuda_stream),
                "gather_flat kernel")
            return out
        cases.append(("G1 out at another 16-byte offset than idx (C entry)",
                      scalar_way,
                      lambda: gather.gather_flat_plain(p1, idx)))

    # G2: P1's table from a misaligned index in every mode.
    for mode, hi in (("flat", nt), ("lane", 128), ("sublane", 256)):
        g2("256x128, idx at +4 bytes", p1,
           _unaligned(randint(gen, 0, hi, (256, 128), device), 1), mode)
    # Tables whose rows or columns do not divide the bands, tables below
    # the cluster's split of 8, and the full 232,448 bytes in two rows.
    for rows, cols in ((37, 13), (250, 130), (3, 100), (1, 5), (2, 3),
                       (2, 29056)):
        t = torch.rand((rows, cols), generator=gen, device=device)
        for mode, shape, hi in (("flat", (31, 7), rows * cols),
                                ("flat", (1, 3), rows * cols),
                                ("lane", (rows, 29), cols),
                                ("lane", (rows, 3), cols),
                                ("sublane", (29, cols), rows),
                                ("sublane", (1, cols), rows)):
            g2(f"{rows}x{cols}, index {shape[0]}x{shape[1]}", t,
               randint(gen, 0, hi, shape, device), mode)
    return cases


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
