"""Lookups a thread for G1, and one-place variants of G1 and G2, swept
on the card.

G1 (``csrc/gather.cu``) serves ``kLookups`` consecutive lookups a thread:
one index load and one store of ``kLookups`` lanes (16 bytes at 4; two
16-byte accesses at 8), every table load issued before any is used. This
tool builds copies of ``csrc/gather.cu``, each changed in one place, one
library each (one ``nvcc`` process each, all started together):

* ``kLookups`` = 1, 2, 4 (as shipped) and 8;
* ``default carveout``: G1 without the L1-over-shared-memory preference;
* ``sublane rows by TMA``: G2's sublane band staged by one TMA bulk copy
  a table row (16 bytes each) instead of ``cp.async``;
* ``flat generic DSMEM``: G2 flat reading its peers' shares through
  ``cluster.map_shared_rank`` pointers (generic loads) instead of
  ``mapa`` and ``ld.shared::cluster``;
* ``flat local reads``: G2 flat reading its own share at the same offset
  instead of the owner's (wrong values: a timing split only, not
  checked);
* ``flat local reads, no cluster barrier``: the same without the two
  cluster barriers (safe with local reads only; a timing split);
* ``no streaming hints``: G1 and G2 with ``__ldg`` and plain stores for
  the index and output streams instead of ``__ldcs`` / ``__stcs``;
* ``grid unbounded``: G1 with a block for every 1,024 lookups instead of
  the persistent grid;
* ``cluster 2`` / ``cluster 4``: G2 flat with clusters of 2 or 4 blocks
  (a half or a quarter of the table a block) instead of 8.

Each checked variant must equal the plain twin bit for bit. Every variant
is timed with ``tools/timing.per_launch_ms`` at

* ``p1``: P1's 32,768 lookups into the f32 [256, 128] table;
* ``p2``: P2's 2,097,152 lookups into the f32 240x320 depth image;
* ``vol_77k`` / ``vol_16M``: 76,800 and 16,777,216 lookups into the
  int16 256^3 volume, and ``small_16M``: 16,777,216 into a 76,800-entry
  f32 table (the gather-mode sweep's lines, clamp off);

and G2 in its three modes at P1's shape (flat and lane share G1's lookup
loop). Beside them: an empty kernel's time (``tools/k1_split.py`` mode
0), each G1 shape's byte bound, and its L2 sector bytes (32 a random
table read, plus the index and output streams) with the rate the shipped
kernel's time implies. Prints one JSON object with the card's name and
power limit (and writes it to ``--out``). Needs a CUDA card and ``nvcc``.

Usage: python -m slambench_tpu_torch.tools.gather_sweep [--out sweep.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

from slambench_tpu_torch.ops.hopper import build, gather
from slambench_tpu_torch.policy import apply_precision_policy, resolve_device
from slambench_tpu_torch.tools import k1_split
from slambench_tpu_torch.tools.mosaic_probe import (
    generator, l2_sectors, randint,
)
from slambench_tpu_torch.tools.timing import bound_ms, per_launch_ms

SOURCE = os.path.join(build.CSRC, "gather.cu")
SHIPPED = "shipped (kLookups 4)"
_LOOKUPS = "constexpr int kLookups = 4;"
_CARVEOUT = """    cudaError_t err = cudaFuncSetAttribute(
        gather_flat<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxL1);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor("""
_BY_TMA = "const bool by_tma = aligned && nrows == 1;"
_DSMEM = "return ld_cluster(stage + (j - owner * share), owner);"
_NAMESPACE = "namespace {\n\nnamespace cg = cooperative_groups;"
_MOST = "const long long most = static_cast<long long>(nsm) * per_sm;"
_CLUSTER = "constexpr int kCluster = 8;"
_CLUSTER_WAIT = """wait_stage(bar);
          cluster_sync_thread();
        });"""
_CLUSTER_EXIT = """  cluster_sync_thread();      // no share leaves while a peer reads it
}

// G2 lane (mode 1)"""
# {name: ([(shipped text, variant text)], checked against the twin)}
VARIANTS = {
    SHIPPED: ([], True),
    **{f"kLookups {k}": ([(_LOOKUPS, f"constexpr int kLookups = {k};")],
                         True) for k in (1, 2, 8)},
    "default carveout": ([(_CARVEOUT, """    cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(""")], True),
    "sublane rows by TMA": ([(_BY_TMA, "const bool by_tma = aligned;")],
                            True),
    "flat generic DSMEM": ([(_DSMEM, "return cluster.map_shared_rank("
                             "stage, owner)[j - owner * share];")], True),
    "flat local reads": ([(_DSMEM, "return stage[j - owner * share];")],
                         False),
    "flat local reads, no cluster barrier": (
        [(_DSMEM, "return stage[j - owner * share];"),
         (_CLUSTER_WAIT, "wait_stage(bar);\n        });"),
         (_CLUSTER_EXIT, "}\n\n// G2 lane (mode 1)")], False),
    "no streaming hints": ([(_NAMESPACE, "#define __ldcs(p) __ldg(p)\n"
                             "#define __stcs(p, v) (*(p) = (v))\n"
                             + _NAMESPACE)], True),
    "grid unbounded": ([(_MOST, "const long long most = 1LL << 30;")], True),
    **{f"cluster {c}": ([(_CLUSTER, f"constexpr int kCluster = {c};")], True)
       for c in (2, 4)},
}


def variant_source(changes) -> str:
    with open(SOURCE) as f:
        src = f.read()
    for shipped, variant in changes:
        if shipped not in src:
            raise RuntimeError(f"csrc/gather.cu no longer holds {shipped!r}")
        src = src.replace(shipped, variant)
    return src


def shapes(device: torch.device) -> dict:
    """{name: (table, idx)} at the probes' shapes."""
    gen = generator(device, 11)
    p1 = torch.rand((256, 128), generator=gen, device=device)
    depth = torch.rand((240, 320), generator=gen, device=device) * 5
    vol = randint(gen, -32766, 32767, (256 ** 3,), device).to(torch.int16)
    small = torch.rand(76_800, generator=gen, device=device)
    return {"p1": (p1, randint(gen, 0, p1.numel(), (256, 128), device)),
            "p2": (depth, randint(gen, 0, depth.numel(), (1024, 2048),
                                  device)),
            "vol_77k": (vol, randint(gen, 0, vol.numel(), (76_800,), device)),
            "vol_16M": (vol, randint(gen, 0, vol.numel(), (256 ** 3,),
                                     device)),
            "small_16M": (small, randint(gen, 0, small.numel(), (256 ** 3,),
                                         device))}


def run(device: torch.device, reps: int = 100) -> dict:
    apply_precision_policy()
    libs = build.build_variants(
        {name: variant_source(changes)
         for name, (changes, _) in VARIANTS.items()}, "gather_sweep")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.slb_gather_flat.argtypes = [vp, ci, vp, vp, ci, ci, ci, ci, vp]
        lib.slb_gather_flat.restype = ci
        lib.slb_gather_axis_smem_f32.argtypes = [vp, vp, vp, ci, ci, ci, ci,
                                                 ci, ci, vp]
        lib.slb_gather_axis_smem_f32.restype = ci
    nsm = torch.cuda.get_device_properties(device).multi_processor_count
    stream = torch.cuda.current_stream(device).cuda_stream
    cases = shapes(device)

    def g1(lib, table, idx):
        out = torch.empty(idx.shape, dtype=torch.float32, device=device)
        build.check(lib.slb_gather_flat(
            table.data_ptr(), gather.TABLE_TYPES[table.dtype],
            idx.data_ptr(), out.data_ptr(), idx.numel(), table.numel(), 0,
            nsm, stream), "gather_flat variant")
        return out

    def g2(lib, table, idx, mode):
        out = torch.empty(idx.shape, dtype=torch.float32, device=device)
        build.check(lib.slb_gather_axis_smem_f32(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), *table.shape,
            *idx.shape, gather.AXIS_MODES[mode], nsm, stream),
            "gather_axis_smem variant")
        return out

    p1 = cases["p1"][0]
    gen = generator(device, 12)
    axis_idx = {"flat": cases["p1"][1],
                "lane": randint(gen, 0, 128, (256, 128), device),
                "sublane": randint(gen, 0, 256, (256, 128), device)}
    calls = {}
    for v, lib in libs.items():
        for name, (table, idx) in cases.items():
            calls[(v, f"G1 {name}")] = (
                lambda lib=lib, t=table, i=idx: g1(lib, t, i),
                lambda t=table, i=idx: gather.gather_flat_plain(t, i))
        for mode, idx in axis_idx.items():
            calls[(v, f"G2 {mode} p1")] = (
                lambda lib=lib, i=idx, m=mode: g2(lib, p1, i, m),
                lambda i=idx, m=mode: gather.gather_axis_plain(p1, i, m))
    for (v, name), (kernel, twin) in calls.items():
        if VARIANTS[v][1] and not torch.equal(kernel(), twin()):
            raise RuntimeError(f"{v}: {name} differs from the twin")
    torch.cuda.synchronize()
    times = {}
    for (v, name), (kernel, _) in calls.items():
        ms, paced = per_launch_ms(kernel, reps)
        times.setdefault(name, {})[v] = {"ms": ms, "host_paced": paced}
    yardsticks = {}
    for name, (table, idx) in cases.items():
        n = idx.numel()
        nbytes = 8 * n + table.numel() * table.element_size()
        sectors = l2_sectors(n)
        shipped_ms = times[f"G1 {name}"][SHIPPED]["ms"]
        yardsticks[f"G1 {name}"] = {
            "lookups": n, "bytes": nbytes, "bound_ms": bound_ms(nbytes),
            "l2_sector_bytes": sectors,
            "l2_sector_tb_per_s": sectors / (shipped_ms * 1e-3) / 1e12}
    return {"card": k1_split.card_line(),
            "empty_kernel": k1_split.empty_kernel_ms(device, reps),
            "times": times, "yardsticks": yardsticks}


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
