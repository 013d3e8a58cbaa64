"""Where K1's time goes, and what K1F saves, on the card.

Times, on the synthetic 640x480 frame at compute-size ratio 2 (240x320
outputs), each with ``tools/timing.per_launch_ms``:

* ``old_k1_variants``: the one-thread-per-pixel kernel that K1 was
  before its tiled redesign (``tools/k1_split.cu``): an empty kernel on
  its grid, the loads alone, the loads plus the range weight ``expf``,
  and the kernel in full (with its IEEE division ``-mod / e2``);
* ``k1f_variants``: K1F as ``csrc/bilateral.cu`` ships it (two outputs
  per thread, ``exp2f``) and copies of that source changed in one place
  each: one or four outputs per thread, or the range weight as ``expf``
  of the product with ``-1 / e2``, or as ``expf(-mod / e2)`` with the
  IEEE division;
* the shipped tiled K1 (``bilateral_filter_cuda``) and K1F
  (``mm2m_bilateral_cuda``);
* ``mm2meters`` alone, and the two preprocessing pairs: ``mm2meters``
  then the old kernel (the frame path before K1F) and ``mm2meters``
  then the tiled K1.

Every variant is built with ``nvcc`` (one process each, all started
together) and checked first: the old kernel, the tiled K1 and every K1F
within ``K1_TOL`` of the plain twin, K1F's metres bit for bit numpy's
division. Prints one JSON object with the card's name and power limit
(and writes it to ``--out`` when given). Needs a CUDA card and
``nvcc``; there is no CPU mode.

Usage: python -m slambench_tpu_torch.tools.k1_split [--out split.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.io.synthetic import (
    SyntheticScene, orbit_trajectory, render_depth_frame,
)
from slambench_tpu_torch.ops.hopper import bilateral, build
from slambench_tpu_torch.ops.preprocess import make_gaussian, mm2meters
from slambench_tpu_torch.policy import apply_precision_policy, resolve_device
from slambench_tpu_torch.tools.mosaic_probe import K1_TOL, max_abs_err
from slambench_tpu_torch.tools.timing import per_launch_ms

HERE = os.path.dirname(os.path.abspath(__file__))
OLD_SOURCE = os.path.join(HERE, "k1_split.cu")
K1F_SOURCE = os.path.join(build.CSRC, "bilateral.cu")
MODES = {0: "empty kernel, same grid", 1: "loads only",
         2: "loads + expf (reciprocal product)",
         3: "old K1 in full (IEEE division + expf)"}

# The shipped K1F's window read and range weight, and their stand-ins.
_WINDOW = """    const float2 a = *reinterpret_cast<const float2*>(row);
    const float2 b = *reinterpret_cast<const float2*>(row + 2);
    const float2 c = *reinterpret_cast<const float2*>(row + 4);
    const float v[MX + 2 * R] = {a.x, a.y, b.x, b.y, c.x, c.y};
"""
_ANY_WINDOW = """    float v[MX + 2 * R];
#pragma unroll
    for (int c = 0; c < MX + 2 * R; ++c) v[c] = row[c];
"""
_WEIGHT = "gg * exp2f(d * d * c2)"
_SCALE = "return static_cast<float>(-1.4426950408889634 / e2);"
K1F_VARIANTS = {
    "shipped: 2 outputs/thread, exp2f": {},
    "1 output/thread": {"mx": 1},
    "4 outputs/thread": {"mx": 4},
    "expf(mod * (-1/e2))": {"weight": "gg * expf(d * d * c2)",
                            "scale": "return -1.0f / e2;"},
    "expf(-mod / e2), IEEE division": {"weight": "gg * expf(-(d * d) / c2)",
                                       "scale": "return e2;"},
}


def k1f_variant_source(mx: int = 2, weight: str = _WEIGHT,
                       scale: str = _SCALE) -> str:
    """``csrc/bilateral.cu`` with another micro-tile width or weight."""
    with open(K1F_SOURCE) as f:
        src = f.read()
    for part in (_WINDOW, _WEIGHT, _SCALE, "constexpr int MX = 2;",
                 "static_assert(MX == 2"):
        if part not in src:
            raise RuntimeError(f"csrc/bilateral.cu no longer holds {part!r}")
    if mx != 2:
        src = src.replace("constexpr int MX = 2;", f"constexpr int MX = {mx};")
        src = src.replace("static_assert(MX == 2", "static_assert(true")
        src = src.replace(_WINDOW, _ANY_WINDOW)
    return src.replace(_WEIGHT, weight).replace(_SCALE, scale)


def build_libs(sources: dict) -> dict:
    """Compile each {name: CUDA source} into its own shared library, one
    nvcc process each, all started together; returns {name: CDLL}."""
    libs = build.build_variants(sources, "k1_split")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, lib in libs.items():
        if name == "old":
            lib.slb_k1_split.argtypes = [ci, vp, vp, ci, ci, vp, cf, vp]
            lib.slb_k1_split.restype = ci
        else:
            lib.slb_mm2m_bilateral_f32.argtypes = [vp, vp, vp, ci, ci, ci,
                                                   vp, cf, vp, vp, vp]
            lib.slb_mm2m_bilateral_f32.restype = ci
    return libs


def empty_kernel_ms(device: torch.device, reps: int = 200) -> dict:
    """Mode 0 alone: an empty kernel on the old K1's 240x320 grid, the
    floor under any launch (what the gather rows sit on)."""
    with open(OLD_SOURCE) as f:
        lib = build_libs({"old": f.read()})["old"]
    depth = torch.zeros((240, 320), device=device)
    out = torch.empty_like(depth)
    lut = make_gaussian()
    stream = torch.cuda.current_stream(device).cuda_stream

    def empty():
        build.check(lib.slb_k1_split(
            0, depth.data_ptr(), out.data_ptr(), 240, 320,
            lut.ctypes.data_as(ctypes.c_void_p), 1.0, stream),
            "k1_split mode 0")

    ms, paced = per_launch_ms(empty, reps)
    return {"ms": ms, "host_paced": paced}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def synthetic_frame(device: torch.device) -> torch.Tensor:
    """The int32 640x480 millimetre frame that chip_smoke.py uses."""
    poses = orbit_trajectory(12, [0.34 * 4.8, 0.5 * 4.8, 0.24 * 4.8])
    mm = render_depth_frame(SyntheticScene(dim=(4.8, 4.8, 4.8)), poses[11],
                            (481.2, 480.0, 320.0, 240.0), (640, 480), device)
    return torch.from_numpy(mm.astype(np.int32)).to(device)


def run(device: torch.device, reps: int = 200) -> dict:
    apply_precision_policy()
    with open(OLD_SOURCE) as f:
        sources = {"old": f.read()}
    sources.update({name: k1f_variant_source(**kw)
                    for name, kw in K1F_VARIANTS.items()})
    libs = build_libs(sources)
    mm = synthetic_frame(device)
    lut = make_gaussian()
    lut_ptr = lut.ctypes.data_as(ctypes.c_void_p)
    e2 = float(np.float32(params.E_DELTA * params.E_DELTA * 2.0))
    fd = mm2meters(mm, 2).contiguous()
    H, W = fd.shape
    stream = torch.cuda.current_stream(device).cuda_stream

    def old(mode, depth):
        out = torch.empty_like(depth)
        build.check(libs["old"].slb_k1_split(
            mode, depth.data_ptr(), out.data_ptr(), H, W, lut_ptr, e2,
            stream), f"k1_split mode {mode}")
        return out

    def k1f(name):
        metres, out = torch.empty_like(fd), torch.empty_like(fd)
        build.check(libs[name].slb_mm2m_bilateral_f32(
            mm.data_ptr(), metres.data_ptr(), out.data_ptr(), *mm.shape, 2,
            lut_ptr, e2, stream, None, None), f"K1F variant {name}")
        return metres, out

    want = bilateral.plain(fd, lut)
    ieee = mm.cpu().numpy()[::2, ::2].astype(np.float32) / np.float32(1000)
    got = {"old K1": old(3, fd),
           "tiled K1": bilateral.bilateral_filter_cuda(fd, lut)}
    for name in ["K1F", *K1F_VARIANTS]:
        metres, got[name] = (bilateral.mm2m_bilateral_cuda(mm, 2, lut)
                             if name == "K1F" else k1f(name))
        if not np.array_equal(metres.cpu().numpy().view(np.uint32),
                              ieee.view(np.uint32)):
            raise RuntimeError(f"{name}: metres differ from IEEE division")
    for name, g in got.items():
        torch.testing.assert_close(g, want, equal_nan=True, msg=name, **K1_TOL)

    def ms(fn):
        t, paced = per_launch_ms(fn, reps)
        return {"ms": t, "host_paced": paced}

    return {"card": card_line(), "outputs": [H, W],
            "max_abs_err": {k: max_abs_err(g, want) for k, g in got.items()},
            "old_k1_variants": {f"{m}: {label}": ms(lambda m=m: old(m, fd))
                                for m, label in MODES.items()},
            "k1f_variants": {name: ms(lambda name=name: k1f(name))
                             for name in K1F_VARIANTS},
            "tiled K1": ms(lambda: bilateral.bilateral_filter_cuda(fd, lut)),
            "K1F": ms(lambda: bilateral.mm2m_bilateral_cuda(mm, 2, lut)),
            "mm2meters": ms(lambda: mm2meters(mm, 2).contiguous()),
            "mm2meters + old K1": ms(
                lambda: old(3, mm2meters(mm, 2).contiguous())),
            "mm2meters + tiled K1": ms(
                lambda: bilateral.bilateral_filter_cuda(
                    mm2meters(mm, 2).contiguous(), lut))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    result = run(resolve_device("cuda"))
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
