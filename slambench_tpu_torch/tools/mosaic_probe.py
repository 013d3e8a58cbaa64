"""Gather throughput on the card: the counterpart of
``slambench_tpu/tools/mosaic_probe.py``.

On the TPU that tool asked whether Mosaic could compile each gather form
from a table held in VMEM (flat ``take``, lane and sublane
``take_along_axis``, a wide flat gather into the whole depth image, a
2-D advanced index). On Hopper every thread loads from any address, so
whether a gather compiles means nothing here. This tool asks instead how
fast the card serves each of those gathers, and from which memory: device
memory through L2 (kernel G1, G4's device-memory route) or a table
staged into shared memory (G2, G3, G4's staged route). It runs the same probes at the JAX tool's shapes:

* ``probe_gathers`` (P1): a f32 [256, 128] table, [256, 128] indices;
  the flat, lane and sublane forms through G2, the flat one through G1
  in mode "fill" (the Pallas body's ``take``);
* ``probe_wide_gather`` (P2, P3): 2,097,152 lookups into the 240x320
  depth image: G1 in mode "fill" on the f32 metre image in device
  memory, G3 on the uint16 millimetre image in shared memory (bit-equal
  to G1), G4 as the 2-D index ``t[vi, ui]`` (the image's first 58,108
  floats staged in every block, the rest read from device memory);
* ``probe_pallas_reduce`` / ``probe_pallas_bilateral``: K2 and K1 at
  240x320 against their plain twins;
* ``probe_gather_modes``: G1 with ``clamp`` on and off (``mode="clip"``
  vs ``promise_in_bounds``), from a 76,800-entry f32 table and the int16
  256^3 volume, at 76,800 and 16,777,216 (the integrate's) lookups.

Every entry holds ``ok``, ``max_abs_err`` of the kernel against its plain
twin on the same inputs, ``count`` (lookups or pixels), ``bytes`` (index
and output once, table once), ``ns_per_elem`` (kernel),
``plain_ns_per_elem`` (the twin), ``library_ns_per_elem`` (one PyTorch
call computing the same function on the probe's in-range indices: the
indexing call at the twin's core, without the glue that gives NaN or
clips out-of-range indices, or for the clip and pib lines the twin
itself; none exists for K1, K2), ``bound_ns_per_elem``
(``bytes`` over 3.35 TB/s, or operations over 67 TFLOP/s where larger)
and ``l2_resident`` (whether those bytes fit the 50 MB L2, so that
back-to-back launches find them warm; the 16.7 M-lookup cases do not).
G1's entries also hold ``l2_sector_bytes`` (a 32-byte sector a random
table read, plus the index and output streams) and
``l2_sector_tb_per_s``, the rate that the kernel's time implies.
Times come from ``tools/timing.per_launch_ms``: one CUDA-event pair
around back-to-back launches after a warm-up, median of five runs.

With ``--device cpu`` the wrappers run their plain twins and every timing
field is null (not measured). ``--device cuda`` without a card raises.

Usage: python -m slambench_tpu_torch.tools.mosaic_probe [--json out.json]
       [--device cuda] [--n N] [--skip-slow]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Optional

import numpy as np
import torch

from slambench_tpu_torch.ops.hopper import bilateral, gather, reduce
from slambench_tpu_torch.ops.preprocess import make_gaussian
from slambench_tpu_torch.policy import apply_precision_policy, resolve_device
from slambench_tpu_torch.tools.timing import L2_BYTES, bound_ms, per_launch_ms

H, W, V = 240, 320, 256
WIDE_N = 2 * 1024 * 1024        # P2/P3: the integrate-population lookups
SWEEP_COUNTS = {"77k": 76_800, "16M": V ** 3}
K1_TOL = dict(rtol=1e-5, atol=1e-5)
K2_TOL = dict(rtol=1e-4, atol=1e-3)   # tests/test_pallas.py tolerances
# K1 work per tap: difference, square, scaled negation, expf, two
# products and the two sums (one fused multiply-add, one add).
K1_OPS_PER_TAP = 9


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want|; NaN in both places agrees, NaN in one is inf."""
    g, w = got.double(), want.double()
    d = torch.where(g.isnan() & w.isnan(), torch.zeros_like(g), (g - w).abs())
    d = torch.nan_to_num(d, nan=float("inf"))
    return float(d.max()) if d.numel() else 0.0


def measure(kernel: Callable[[], torch.Tensor],
            twin: Callable[[], torch.Tensor], count: int, nbytes: int,
            ops: float = 0.0, tol: Optional[dict] = None,
            twin_is_library: bool = True, reps: int = 100,
            sectors: Optional[int] = None,
            library: Optional[Callable[[], torch.Tensor]] = None) -> dict:
    """One probe entry: the kernel against its plain twin on the same
    inputs (exact unless ``tol``), timed on the card. The library time is
    ``library``'s where given, else the twin's where ``twin_is_library``.
    ``sectors``: the L2 sector bytes a device-memory gather moves
    (``l2_sectors``), kept beside the byte bound with the rate the
    kernel's time implies."""
    got, want = kernel(), twin()
    err = max_abs_err(got, want)
    ok = (err == 0.0 if tol is None else
          bool(torch.allclose(got, want, equal_nan=True, **tol)))
    bound = bound_ms(nbytes, ops)
    entry = {"ok": ok, "max_abs_err": err, "count": count, "bytes": nbytes,
             "ops": ops,
             "ns_per_elem": None, "plain_ns_per_elem": None,
             "library_ns_per_elem": None, "host_bound": None,
             "bound_ns_per_elem": bound * 1e6 / count,
             "l2_resident": nbytes <= L2_BYTES}
    if got.device.type == "cuda":
        k_ms, k_paced = per_launch_ms(kernel, reps)
        p_ms, _ = per_launch_ms(twin, max(5, reps // 5))
        entry.update(ns_per_elem=k_ms * 1e6 / count,
                     plain_ns_per_elem=p_ms * 1e6 / count,
                     host_bound=k_paced)
        if library is not None:
            entry["library_ns_per_elem"] = per_launch_ms(
                library, max(5, reps // 5))[0] * 1e6 / count
        elif twin_is_library:
            entry["library_ns_per_elem"] = entry["plain_ns_per_elem"]
    if sectors is not None:
        entry["l2_sector_bytes"] = sectors
        entry["l2_sector_tb_per_s"] = (
            None if entry["ns_per_elem"] is None
            else sectors / (entry["ns_per_elem"] * count) * 1e-3)
    return entry


def l2_sectors(count: int) -> int:
    """L2-to-SM bytes of ``count`` random lookups from device memory: a
    32-byte sector a table read, whatever the entry's width, plus the
    4-byte index read and the 4-byte output written."""
    return (32 + 8) * count


def report(out: dict, name: str, entry: dict) -> None:
    out[name] = entry
    print(f"{name}: {entry}", file=sys.stderr, flush=True)


def randint(gen: torch.Generator, lo: int, hi: int, shape,
             device: torch.device) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen, device=device,
                         dtype=torch.int32)


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def library_gather(table: torch.Tensor, idx: torch.Tensor,
                   mode: str = "flat") -> torch.Tensor:
    """The one PyTorch call that computes a flat, lane or sublane gather
    of in-range indices: the library yardstick."""
    if mode == "flat":
        return table.reshape(-1)[idx]
    return torch.gather(table, 1 if mode == "lane" else 0, idx)


def probe_gathers(out: dict, device: torch.device, seed: int = 0) -> None:
    """P1: flat / lane / sublane gathers from a [256, 128] f32 table held
    in shared memory (G2), and the flat one from device memory (G1)."""
    gen = generator(device, seed)
    rows, cols = 256, 128
    table = torch.rand((rows, cols), generator=gen, device=device)
    for name, mode, hi in (("mosaic_take_flat", "flat", rows * cols),
                           ("mosaic_take_along_lane", "lane", cols),
                           ("mosaic_take_along_sublane", "sublane", rows)):
        idx = randint(gen, 0, hi, (rows, cols), device)
        report(out, name, measure(
            lambda: gather.gather_axis_smem(table, idx, mode),
            lambda: gather.gather_axis_plain(table, idx, mode),
            idx.numel(), 3 * table.numel() * 4,
            library=lambda: library_gather(table, idx, mode)))
        if mode == "flat":
            report(out, "take_flat_device", measure(
                lambda: gather.gather_flat(table, idx, mode="fill"),
                lambda: gather.gather_flat_plain(table, idx, mode="fill"),
                idx.numel(), 3 * table.numel() * 4,
                sectors=l2_sectors(idx.numel()),
                library=lambda: library_gather(table, idx)))


def library_u16(mm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """G3's library yardstick: metres of the widened ``mm[idx]``."""
    return gather.mm_to_meters(mm.reshape(-1).to(torch.float32)[idx])


def probe_wide_gather(out: dict, device: torch.device, n: int = WIDE_N,
                      seed: int = 1) -> None:
    """P2/P3: ``n`` lookups into the whole 240x320 depth image: G1 on the
    f32 metres in device memory, G3 on the uint16 millimetres in shared
    memory (must equal G1 bit for bit), G4 as ``t[vi, ui]``. The library
    lines time the indexing calls of the twins' cores: ``flat[idx]``,
    ``mm_to_meters`` of the widened ``mm[idx]`` and ``depth[vi, ui]``."""
    gen = generator(device, seed)
    rng = np.random.default_rng(seed)
    mm = torch.from_numpy(rng.integers(0, 5000, (H, W)).astype(np.uint16)) \
        .to(device)
    depth = gather.mm_to_meters(mm)
    shape = (max(1, n // 2048), min(n, 2048))
    count = shape[0] * shape[1]
    idx = randint(gen, 0, H * W, shape, device)
    vi = randint(gen, 0, H, shape, device)
    ui = randint(gen, 0, W, shape, device)
    io = 8 * count
    report(out, "wide_gather_device", measure(
        lambda: gather.gather_flat(depth, idx, mode="fill"),
        lambda: gather.gather_flat_plain(depth, idx, mode="fill"), count,
        io + depth.numel() * 4, sectors=l2_sectors(count),
        library=lambda: library_gather(depth, idx)))
    entry = measure(lambda: gather.gather_smem_u16(mm, idx),
                    lambda: gather.gather_u16_plain(mm, idx), count,
                    io + mm.numel() * 2, ops=count,
                    library=lambda: library_u16(mm, idx))
    entry["equals_device_f32"] = bool(torch.equal(
        gather.gather_smem_u16(mm, idx),
        gather.gather_flat(depth, idx, mode="fill")))
    entry["ok"] = entry["ok"] and entry["equals_device_f32"]
    report(out, "wide_gather_smem_u16", entry)
    report(out, "adv2d_gather", measure(
        lambda: gather.gather_2d(depth, vi, ui),
        lambda: gather.gather_2d_plain(depth, vi, ui), count,
        io + 4 * count + depth.numel() * 4,
        library=lambda: depth[vi, ui]))


def probe_pallas_reduce(out: dict, device: torch.device, seed: int = 2) -> None:
    """K2 against its plain twin on random TrackData at 240x320."""
    rng = np.random.default_rng(seed)
    data = {"result": rng.choice([1, -1, -4, -5], (H, W)).astype(np.int32),
            "error": rng.standard_normal((H, W)).astype(np.float32),
            "J": rng.standard_normal((6, H, W)).astype(np.float32)}
    data = {k: torch.from_numpy(a).to(device) for k, a in data.items()}
    n_valid = int((data["result"] >= 1).sum())
    report(out, "pallas_reduce", measure(
        lambda: reduce.reduce_track_cuda(data), lambda: reduce.plain(data),
        H * W, 32 * H * W + 32 * 4, ops=56 * n_valid, tol=K2_TOL,
        twin_is_library=False))


def probe_pallas_bilateral(out: dict, device: torch.device,
                           seed: int = 3) -> None:
    """K1 against its plain twin on random metre depth at 240x320."""
    gen = generator(device, seed)
    depth = torch.rand((H, W), generator=gen, device=device) * 3 + 0.5
    g = make_gaussian()
    report(out, "pallas_bilateral", measure(
        lambda: bilateral.bilateral_filter_cuda(depth, g),
        lambda: bilateral.plain(depth, g), H * W,
        2 * 4 * H * W, ops=K1_OPS_PER_TAP * 25 * H * W, tol=K1_TOL,
        twin_is_library=False))


def probe_gather_modes(out: dict, device: torch.device,
                       cap: Optional[int] = None, seed: int = 4) -> None:
    """G1, clamp on and off, from a 76,800-entry f32 table and the int16
    256^3 volume, at 76,800 and 16,777,216 lookups (each capped at
    ``cap``)."""
    gen = generator(device, seed)
    small = torch.rand(H * W, generator=gen, device=device)
    vol = randint(gen, -32766, 32767, (V ** 3,), device).to(torch.int16)
    for label, count in SWEEP_COUNTS.items():
        count = min(count, cap or count)
        for table, kind in ((small, "small"), (vol, "vol")):
            idx = randint(gen, 0, table.numel(), (count,), device)
            nbytes = 8 * count + table.numel() * table.element_size()
            for clamp, mode in ((True, "clip"), (False, "pib")):
                report(out, f"gather_{kind}_{mode}_{label}", measure(
                    lambda: gather.gather_flat(table, idx, clamp),
                    lambda: gather.gather_flat_plain(table, idx, clamp),
                    count, nbytes, sectors=l2_sectors(count)))


def run(device: torch.device, n: Optional[int] = None,
        skip_slow: bool = False) -> dict:
    """Every probe on ``device``; ``n`` caps each lookup count."""
    apply_precision_policy()
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    probe_gathers(out, device)
    probe_wide_gather(out, device, min(WIDE_N, n or WIDE_N))
    probe_pallas_reduce(out, device)
    probe_pallas_bilateral(out, device)
    if not skip_slow:
        probe_gather_modes(out, device, n)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None,
                    help="cap every probe's lookup count (default: the JAX "
                         "tool's counts, up to 16,777,216)")
    ap.add_argument("--skip-slow", action="store_true",
                    help="skip the gather-mode sweep (16.7 M lookups)")
    args = ap.parse_args(argv)
    out = run(resolve_device(args.device), args.n, args.skip_slow)
    text = json.dumps(out, indent=1)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
