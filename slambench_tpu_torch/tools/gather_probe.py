"""Gather formulations on the card: the counterpart of
``slambench_tpu/tools/gather_probe.py``, at its shapes.

It times the three gather populations of the frame step through the
hand kernels of ``ops/hopper/gather.py``:

* the integrate's depth lookup, ``--n`` lookups (default 2,097,152) into
  the 240x320 image: ``flat1d_f32`` (G1 on the flat index
  ``vi * W + ui``), ``op2d_f32`` (G4 on ``vi``, ``ui``: the image's
  first 58,108 floats staged in every block, the rest read from device
  memory), ``flat1d_u16`` (G1 on the uint16 image, widened) and
  ``flat1d_u16_smem`` (G3: the uint16 image in shared memory, converted
  to metres by IEEE division as the JAX package's ``mm2meters``);
* the same lookup into a 720x1280 depth image (a depth camera's largest
  mode, 3,686,400 bytes), ``op2d_f32_720p``: a table of which a block
  would stage less than half (``gather.g4_staged``), so G4 reads it from
  device memory;
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
and no library time. ``edge_cases`` lists the inputs the card checks
hold each kernel to beside the probes' shapes (``chip_smoke.py`` phase
3, ``tests/test_torch_cuda.py``), compared by ``equal_nan``. With
``--device cpu`` (or, without ``--device``, ``SLAMBENCH_PLATFORM=cpu``;
``utils/backend.py``) the plain twins run and every timing field is
null; ``--device cuda`` without a card raises.

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
    H, V, W, generator, l2_sectors, library_u16, measure, randint, report,
)
from slambench_tpu_torch.utils import backend

NPIX = 76_800
TINY = 512
H720, W720 = 720, 1280


def _unaligned(t: torch.Tensor, shift: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``shift`` elements into a
    fresh buffer (``shift * 4`` bytes past a 16-byte boundary)."""
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    out = buf[shift:].view(t.shape)
    out.copy_(t)
    return out


def equal_nan(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Same shape and dtype, NaN in the same places, and every other
    value equal (``torch.equal`` is false wherever there is a NaN)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    nan = want.isnan()
    return bool(torch.equal(got.isnan(), nan)
                and torch.equal(got[~nan], want[~nan]))


def out_of_range(gen: torch.Generator, n: int, count: int,
                 device: torch.device) -> torch.Tensor:
    """``count`` indices of each class against ``n`` entries (below -n,
    in [-n, 0), in range, at or above n) and the exact edges, shuffled."""
    wide = torch.cat([randint(gen, -3 * n - 1, -n, (count,), device),
                      randint(gen, -n, 0, (count,), device),
                      randint(gen, 0, n, (count,), device),
                      randint(gen, n, 3 * n + 1, (count,), device),
                      torch.tensor([-n - 1, -n, -1, 0, n - 1, n,
                                    -2**31, 2**31 - 1],
                                   dtype=torch.int32, device=device)])
    return wide[torch.randperm(wide.numel(), generator=gen, device=device)]


def edge_cases(device: torch.device, seed: int = 9) -> list:
    """``(name, kernel call, twin call)`` for the inputs that the
    redesigned G1-G4 take apart from the probes' own shapes: indices that
    do not start on 16 bytes (slices of contiguous tensors; for G4 also
    vi and ui at different offsets), lookup counts 1, 3 and 4k+3, indices
    below -n, in [-n, 0), in range, at or above n and at the int32
    extremes (G1 in modes clip and fill, G2 in every mode, G3, G4 on
    both axes); G2 tables whose rows or columns do not divide its bands,
    tables smaller than its cluster's split, and a two-row table of the
    full 232,448 bytes; G3 tables at the 116,224-entry cap and of a size
    that is no multiple of 16 bytes; G4 tables of 1x1, 37x13, exactly
    what a block stages and one entry more (read from device memory past
    the stage), exactly the staged route's largest and one entry more
    (the device-memory route).
    The pairs must agree by ``equal_nan``."""
    gen = generator(device, seed)
    cases = []

    def g1(name, table, idx, clamp=False, mode=None):
        cases.append((f"G1 {name}",
                      lambda: gather.gather_flat(table, idx, clamp, mode),
                      lambda: gather.gather_flat_plain(table, idx, clamp,
                                                       mode)))

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
        wide = out_of_range(gen, nt, 1000, device)
        for mode in ("clip", "fill"):
            g1(f"{kind} {mode} below -n / [-n, 0) / in range / >= n",
               table, wide, mode=mode)
            g1(f"{kind} {mode}, idx[1:]", table, wide[1:], mode=mode)
    for mode in ("clip", "fill"):
        g1(f"f32 one-entry table, {mode}", p1[:1, :1], wide, mode=mode)
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

    # G2: P1's table from a misaligned index in every mode, and every
    # class of out-of-range index along the gathered axis.
    for mode, hi in (("flat", nt), ("lane", 128), ("sublane", 256)):
        g2("256x128, idx at +4 bytes", p1,
           _unaligned(randint(gen, 0, hi, (256, 128), device), 1), mode)
        g2("256x128, out of range", p1,
           out_of_range(gen, hi, 8192, device)[:256 * 128].view(256, 128),
           mode)
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
    cases += g3_cases(gen, device) + g4_cases(gen, device)
    return cases


def g3_cases(gen: torch.Generator, device: torch.device) -> list:
    """G3's edge cases (see ``edge_cases``)."""
    cases = []

    def g3(name, table, idx):
        cases.append((f"G3 {name}",
                      lambda: gather.gather_smem_u16(table, idx),
                      lambda: gather.gather_u16_plain(table, idx)))

    mm = randint(gen, 0, 65536, (H, W), device).to(torch.uint16)
    nt = mm.numel()
    base = randint(gen, 0, nt, (4099,), device)
    for shift in (1, 2, 3):
        g3(f"240x320 idx[{shift}:]", mm, base[shift:])
    for n in (1, 3, 4 * 1000 + 3):
        g3(f"240x320 n={n}", mm, randint(gen, 0, nt, (n,), device))
    wide = out_of_range(gen, nt, 1000, device)
    g3("240x320 below -n / [-n, 0) / in range / >= n", mm, wide)
    g3("240x320 out of range, idx[1:]", mm, wide[1:])
    cap = gather.MAX_SMEM_BYTES // 2
    for rows, cols in ((2, cap // 2), (37, 13), (1, 1)):
        t = randint(gen, 0, 65536, (rows, cols), device).to(torch.uint16)
        g3(f"{rows}x{cols} table ({rows * cols * 2} bytes), out of range",
           t, out_of_range(gen, t.numel(), 1000, device))
    return cases


def g4_cases(gen: torch.Generator, device: torch.device) -> list:
    """G4's edge cases (see ``edge_cases``), on both routes."""
    cases = []

    def g4(name, table, vi, ui):
        cases.append((f"G4 {name}",
                      lambda: gather.gather_2d(table, vi, ui),
                      lambda: gather.gather_2d_plain(table, vi, ui)))

    depth = torch.rand((H, W), generator=gen, device=device) * 5
    vi = randint(gen, 0, H, (4099,), device)
    ui = randint(gen, 0, W, (4099,), device)
    for shift in (1, 2, 3):
        g4(f"240x320 vi, ui [{shift}:]", depth, vi[shift:], ui[shift:])
    g4("240x320 vi[1:], ui[2:] (indices at different offsets)", depth,
       vi[1:4098], ui[2:])
    for n in (1, 3, 4 * 1000 + 3):
        g4(f"240x320 n={n}", depth, vi[:n], ui[:n])
    share, most = gather.SHARE_FLOATS, gather.G4_STAGED_MAX_ENTRIES
    for rows, cols in ((H, W), (1, 1), (37, 13), (4, share // 4),
                       (1, share + 1), (8, most // 8), (1, most + 1)):
        t = torch.rand((rows, cols), generator=gen, device=device)
        vo = out_of_range(gen, rows, 1000, device)
        uo = out_of_range(gen, cols, 1000, device)
        route = "staged" if gather.g4_staged(t.numel()) else "device"
        g4(f"{rows}x{cols} ({route}) out of range on both axes", t, vo,
           uo[torch.randperm(uo.numel(), generator=gen, device=device)])
        g4(f"{rows}x{cols} ({route}) in range", t,
           randint(gen, 0, rows, (4099,), device),
           randint(gen, 0, cols, (4099,), device))
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
        io + 4 * n + depth.numel() * 4, library=lambda: depth[vi, ui]))
    big = torch.rand((H720, W720), generator=gen, device=device) * 5
    vi7 = randint(gen, 0, H720, (n,), device)
    ui7 = randint(gen, 0, W720, (n,), device)
    report(out, "op2d_f32_720p", measure(
        lambda: gather.gather_2d(big, vi7, ui7),
        lambda: gather.gather_2d_plain(big, vi7, ui7), n,
        io + 4 * n + big.numel() * 4, library=lambda: big[vi7, ui7],
        sectors=l2_sectors(n) + 4 * n))
    report(out, "flat1d_u16", measure(
        lambda: gather.gather_flat(mm, flat),
        lambda: gather.gather_flat_plain(mm, flat), n,
        io + mm.numel() * 2))
    report(out, "flat1d_u16_smem", measure(
        lambda: gather.gather_smem_u16(mm, flat),
        lambda: gather.gather_u16_plain(mm, flat), n,
        io + mm.numel() * 2, ops=n, library=lambda: library_u16(mm, flat)))

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
    ap.add_argument("--device", default=None,
                    help="cpu or cuda[:N]; default: SLAMBENCH_PLATFORM and "
                         "SLAMBENCH_DEVICE, else cuda")
    ap.add_argument("--n", type=int, default=2 * 1024 * 1024,
                    help="lookups of the depth-image lines (the 76,800-"
                         "lookup lines are capped at it too)")
    args = ap.parse_args(argv)
    out = run(resolve_device(backend.device_name(args.device)), args.n)
    text = json.dumps(out, indent=1)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
