"""Probe: slice gathers against scalar gathers from the 256^3 int16
volume table (port of ``slambench_tpu/tools/slice_probe.py``).

The card's question, for K4 (the raycast's hand kernel): is a gather's
price per index or per element? x-adjacent voxels are adjacent in the
flat table, so ``volume.interp``'s 8 trilinear corners could be 4
slice-2 fetches and ``volume.grad``'s 32 lattice points 4 slice-4 plus 8
slice-2 fetches, bit for bit. If the card prices per index, a kernel
that fetches x-neighbours as one wider load wins; if per element, the
repacking buys nothing. (JAX's probe answered "per element" on the TPU;
that answer is not the card's.)

A slice-``s`` gather is one index into ``table.unfold(0, s, 1)``, the
``[n - s + 1, s]`` view of overlapping windows: one index fetches ``s``
adjacent entries. It is PyTorch's library gather, as JAX's probe used
XLA's. Each variant is JAX's: ``k`` indices ``base + 3 j`` per base
index (600 x 128 base indices), clipped to the table, gathered, summed
in int32 and chained ``INNER`` = 8 times (the next iteration's bases
depend on the sums). Every variant's sum is asserted equal, bit for bit,
to the scalar gather of the same elements. On the card the ``INNER``
iterations are captured once as a CUDA graph and replayed
(``tools/timing.py:graph_ms``): ms a replayed iteration and ns an index.
On the CPU every variant runs and is checked once; times are null.

Usage: python -m slambench_tpu_torch.tools.slice_probe [--device cuda]
       [--side 256] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from slambench_tpu_torch.policy import resolve_device, synchronize
from slambench_tpu_torch.tools.timing import Chain, graph_ms
from slambench_tpu_torch.utils import backend

INNER = 8
BASE_SHAPE = (600, 128)
# JAX's variants: (name, kind, k indices a base index, slice size).
VARIANTS = (
    ("scalar k=1 (control)", "scalar", 1, 1),
    ("scalar k=8 (interp today)", "scalar", 8, 1),
    ("slice2 k=4 (interp alt)", "slice", 4, 2),
    ("scalar k=32 (grad today)", "scalar", 32, 1),
    ("slice4 k=4 (grad alt A)", "slice", 4, 4),
    ("slice2 k=8 (grad alt B)", "slice", 8, 2),
    ("slice2 k=20 (rescan alt)", "slice", 20, 2),
    ("scalar k=40 (rescan today)", "scalar", 40, 1),
)


def slice_gather(table: torch.Tensor, idx: torch.Tensor, s: int
                 ) -> torch.Tensor:
    """``[*idx.shape, s]``: ``table[i:i + s]`` for every index ``i``
    (``jax.lax.gather`` with ``slice_sizes=(s,)``); indices must lie in
    ``[0, len(table) - s]``."""
    return table.unfold(0, s, 1)[idx]


def scalar_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take(table, idx)


def variant_step(table: torch.Tensor, kind: str, k: int, s: int):
    """One chained iteration on ``(acc, base)``: JAX's loop body."""
    n = table.numel()
    offsets = torch.arange(k, device=table.device).reshape(k, 1, 1) * 3

    def body(carry):
        acc, base = carry
        idx = torch.clamp(base[None] + offsets, 0, n - 8)
        if kind == "scalar":
            v = scalar_gather(table, idx).to(torch.int32).sum(0)
        else:
            v = slice_gather(table, idx, s).to(torch.int32).sum((0, -1))
        return acc + v, base + (v & 0)
    return body


def scalar_twin(table: torch.Tensor, base: torch.Tensor, k: int, s: int
                ) -> torch.Tensor:
    """The int32 sum of the same elements by scalar gathers, ``INNER``
    iterations (the bases do not move: the chain adds 0)."""
    n = table.numel()
    offsets = torch.arange(k, device=table.device).reshape(k, 1, 1) * 3
    idx = torch.clamp(base[None] + offsets, 0, n - 8)
    expanded = idx[..., None] + torch.arange(s, device=table.device)
    return scalar_gather(table, expanded).to(torch.int32).sum((0, -1)) \
        * INNER


def run(device: torch.device, side: int = 256, runs: int = 3) -> dict:
    """Every variant's ms a replayed iteration and ns an index (null on
    the CPU) and whether its sum equals its scalar twin's."""
    rng = np.random.default_rng(0)
    nvox = side ** 3
    table = torch.as_tensor(rng.integers(-32766, 32766, nvox)
                            .astype(np.int16), device=device)
    base = torch.as_tensor(rng.integers(0, nvox - 8, BASE_SHAPE)
                           .astype(np.int64), device=device)
    n_base = base.numel()
    out = {"backend": device.type, "side": side, "inner": INNER,
           "base_indices": n_base, "variants": {}}
    for name, kind, k, s in VARIANTS:
        body = variant_step(table, kind, k, s)
        chain = Chain(body, (torch.zeros(BASE_SHAPE, dtype=torch.int32,
                                         device=device), base))
        for _ in range(INNER):
            chain()
        equal = bool(torch.equal(chain.carry[0],
                                 scalar_twin(table, base, k, s)))
        ms = None
        if device.type == "cuda":
            ms = graph_ms(Chain(body, chain.carry), INNER, device, runs)
        out["variants"][name] = {
            "kind": kind, "k": k, "slice": s, "equal": equal, "ms": ms,
            "ns_per_index": None if ms is None else ms * 1e6 / (k * n_base),
            "ns_per_element": None if ms is None
            else ms * 1e6 / (k * s * n_base)}
        if not equal:
            raise RuntimeError(f"slice_probe: {name}: the sum differs "
                               "from the scalar gather of the same "
                               "elements")
    synchronize(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda[:N]; default: SLAMBENCH_PLATFORM and "
                         "SLAMBENCH_DEVICE, else cuda")
    ap.add_argument("--side", type=int, default=256)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    out = run(resolve_device(backend.device_name(args.device)), args.side)
    print(f"{'variant':31s} {'ms/iter':>8s} {'ns/index':>9s}",
          file=sys.stderr)
    for name, v in out["variants"].items():
        if v["ms"] is not None:
            print(f"{name:31s} {v['ms']:8.3f} {v['ns_per_index']:9.3f}",
                  file=sys.stderr)
    text = json.dumps(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
