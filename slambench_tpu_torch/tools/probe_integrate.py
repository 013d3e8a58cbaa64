"""Where the integrate's time goes (port of
``slambench_tpu/tools/probe_integrate.py``): the op and variants of it
with one part taken out, each timed at the same volume and depth.

Variants (JAX's names):

* ``integrate_full`` -- the op, the arithmetic of ``ops/integrate.py``
  (equal to ``integrate`` bit for bit);
* ``integrate_nogather`` -- the depth lookup replaced by arithmetic on
  its index (the gather's cost);
* ``integrate_nocorr`` -- no Euclidean-ray sqrt correction;
* ``integrate_w32`` -- a float32 weight volume in place of int8;
* ``integrate_noweight`` -- no weight stream: every voxel's weight taken
  as 1 and not stored (the weight volume's read and write);
* ``gather_only`` -- the projection and the depth gather, the volume
  written back unchanged;
* ``stream_touch`` -- read and write the tsdf and weight volumes, no
  gather and no arithmetic.

Each variant is chained (its outputs are the next call's inputs) and
timed by ``tools/timing.py:call_ms``: CUDA events on the card, the host
clock on the CPU, and the report says which. Defaults: JAX's
256^3 volume, a 240x320 depth of uniform 0.5-3.5 m from ``--seed``, the
camera at the volume's origin looking down +z.

Usage: python -m slambench_tpu_torch.tools.probe_integrate [--device cuda]
           [--volume 256] [--image 320x240] [--reps 3] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.casts import f32_to_i32
from slambench_tpu_torch.policy import apply_precision_policy, resolve_device
from slambench_tpu_torch.tools.timing import call_ms
from slambench_tpu_torch.volume import pack_tsdf, voxel_centers_axis

DIM = (4.8, 4.8, 4.8)
MU = 0.1
K_320 = ((240.6, 0, 160, 0), (0, 240.0, 120, 0), (0, 0, 1, 0), (0, 0, 0, 1))


def _coords(V: int, device):
    c = voxel_centers_axis(V, DIM[0], device)
    return c[None, None, :], c[None, :, None], c[:, None, None]


def _proj(X, Y, Z, M):
    return (M[0, 0] * X + M[0, 1] * Y + M[0, 2] * Z + M[0, 3],
            M[1, 0] * X + M[1, 1] * Y + M[1, 2] * Z + M[1, 3],
            M[2, 0] * X + M[2, 1] * Y + M[2, 2] * Z + M[2, 3])


def integ(tsdf, weight, depth, M, K, use_gather=True, use_corr=True,
          use_weight=True):
    """``ops/integrate.py``'s update over the whole volume, with a part
    taken out where a flag is off; returns (tsdf, weight)."""
    H, W = depth.shape
    X, Y, Z = _coords(tsdf.shape[0], tsdf.device)
    px, py, pz = _proj(X, Y, Z, M)
    cx, cy, cz = _proj(px, py, pz, K)
    u = cx / cz + 0.5
    v = cy / cz + 0.5
    in_front = pz >= 1e-4
    in_img = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    ui = torch.clamp(f32_to_i32(u), 0, W - 1)
    vi = torch.clamp(f32_to_i32(v), 0, H - 1)
    if use_gather:
        d = depth.reshape(-1)[(vi * W + ui).long()]
    else:
        d = (vi * W + ui).to(torch.float32) * 1e-7 + 2.0
    if use_corr:
        corr = torch.sqrt(1.0 + (px / pz) ** 2 + (py / pz) ** 2)
        diff = (d - cz) * corr
    else:
        diff = d - cz
    update = in_front & in_img & (d != 0) & (diff > -MU)
    sdf = torch.clamp(diff / MU, max=1.0)
    w = weight.to(torch.float32) if use_weight else 1.0
    val = tsdf.to(torch.float32) * params.TSDF_INV_SCALE
    new_val = torch.clamp((w * val + sdf) / (w + 1.0), -1.0, 1.0)
    tsdf_out = torch.where(update, pack_tsdf(new_val), tsdf)
    if not use_weight:
        return tsdf_out, weight
    new_w = torch.clamp(w + 1.0, max=params.MAX_WEIGHT)
    return tsdf_out, torch.where(update, new_w.to(weight.dtype), weight)


def gather_only(tsdf, weight, depth, M, K):
    H, W = depth.shape
    X, Y, Z = _coords(tsdf.shape[0], tsdf.device)
    px, py, pz = _proj(X, Y, Z, M)
    cx, cy, cz = _proj(px, py, pz, K)
    ui = torch.clamp(f32_to_i32(cx / cz + 0.5), 0, W - 1)
    vi = torch.clamp(f32_to_i32(cy / cz + 0.5), 0, H - 1)
    d = depth.reshape(-1)[(vi * W + ui).long()]
    return torch.where(d > 2.0, tsdf, tsdf), weight


def stream_touch(tsdf, weight, depth, M, K):
    return tsdf + 0, weight + 0


VARIANTS = {
    "integrate_full": lambda *a: integ(*a),
    "integrate_nogather": lambda *a: integ(*a, use_gather=False),
    "integrate_nocorr": lambda *a: integ(*a, use_corr=False),
    "integrate_w32": lambda *a: integ(*a),
    "integrate_noweight": lambda *a: integ(*a, use_weight=False),
    "gather_only": gather_only,
    "stream_touch": stream_touch,
}


def inputs(V: int, H: int, W: int, seed: int, device):
    """(tsdf, int8 weight, depth, inv_track, K): an empty volume, a
    uniform 0.5-3.5 m depth and the camera at the origin."""
    rng = np.random.default_rng(seed)
    depth = torch.from_numpy((rng.random((H, W)) * 3 + 0.5)
                             .astype(np.float32)).to(device)
    K = torch.tensor(K_320, dtype=torch.float32, device=device)
    K[0, 2], K[1, 2] = W / 2, H / 2
    return (torch.full((V,) * 3, 32766, dtype=torch.int16, device=device),
            torch.zeros((V,) * 3, dtype=torch.int8, device=device), depth,
            torch.eye(4, device=device), K)


def probe(V: int, H: int, W: int, reps: int, seed: int,
          device: torch.device) -> dict:
    """ms a call of every variant."""
    tsdf, w8, depth, M, K = inputs(V, H, W, seed, device)
    out = {}
    for name, fn in VARIANTS.items():
        w = w8.to(torch.float32) if name == "integrate_w32" else w8
        chain = {"tw": (tsdf, w)}

        def call(fn=fn):
            chain["tw"] = fn(*chain["tw"], depth, M, K)

        ms = out[name] = call_ms(call, reps, device)
        print(f"{name:24s} {ms:10.4f} ms", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--volume", type=int, default=256)
    ap.add_argument("--image", default="320x240")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    apply_precision_policy()
    W, H = (int(v) for v in args.image.split("x"))
    res = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "timing": ("CUDA events" if device.type == "cuda"
                      else "host clock, cpu"),
           "volume": args.volume, "image": [W, H],
           "ms": probe(args.volume, H, W, args.reps, args.seed, device)}
    text = json.dumps(res)
    print(text)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
