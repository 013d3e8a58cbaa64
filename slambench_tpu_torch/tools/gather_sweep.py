"""One-place variants of the gather kernels G1-G4, swept on the card.

This tool builds copies of ``csrc/gather.cu``, each changed in one place,
one library each (one ``nvcc`` process each, all started together), with
``tools/gather_variants.cu`` appended to every copy (the G3 and G4
designs that lost, as entry points of their own):

* ``kLookups`` = 1, 2, 4 (as shipped) and 8: G1 serves ``kLookups``
  consecutive lookups a thread (one index load and one store of
  ``kLookups`` lanes: 16 bytes at 4, two 16-byte accesses at 8), every
  table load issued before any is used; so do G2 flat and lane, G3, G4;
* ``default carveout``: G1 without the L1-over-shared-memory preference;
* ``sublane rows by TMA``: G2's sublane band staged by one TMA bulk copy
  a table row (16 bytes each) instead of ``cp.async``;
* ``flat generic DSMEM``: G2 flat reading its peers' shares through
  ``cluster.map_shared_rank`` pointers (generic loads) instead of
  ``mapa`` and ``ld.shared::cluster``;
* ``flat local reads``: the same kernel reading its own share at the same
  offset instead of the owner's (wrong values: a timing split only, not
  checked);
* ``flat local reads, no cluster barrier``: the same without the two
  cluster barriers (safe with local reads only; a timing split);
* ``no streaming hints``: ``__ldg`` and plain stores for the index and
  output streams instead of ``__ldcs`` / ``__stcs`` (G1, G2; the stores
  of G3, G4); ``index loads without hint`` and ``stores without hint``:
  one of the two; ``staged index loads with hint``: G3 and G4 loading
  their indices with ``__ldcs`` instead of ``__ldg``;
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
  f32 table (the gather-mode sweep's lines, mode promise_in_bounds);

G2 in its three modes at P1's shape (flat and lane share G1's lookup
loop); G4 at P3 (2,097,152 pairs into the 240x320 f32 image) on its
staged route (one block's worth, 58,108 floats, staged in every block
and the rest read from device memory) and on its device-memory route
(the share the C entry is given: ``gather.SHARE_FLOATS`` or 0), also at
tables of 302x384 and 454x384 floats (a block stages a half and a third
of them) and at a 720x1280 image; G3 at P2 on the uint16 image with each
block staging the whole table (as shipped). On the shipped copy only,
the variants of ``tools/gather_variants.cu``: G4 at P3 with the table
split over clusters of 2 / 4 / 8 and read through distributed shared
memory (the design G4 was first built as), and over pairs where every
block serves only the lookups in its own half (``local only``: no
remote read, no cluster barrier, each index read once a block); G2 flat
at P1 over pairs, local only, beside the ``cluster 2`` copy; G3 at P2
by TMA multicast in clusters of 2 and 4, and on 66 and 33 blocks (alone
and with clusters of 2) instead of one an SM. Beside them: an empty
kernel's time (``tools/k1_split.py`` mode 0), each
shape's byte bound, and G1's L2 sector bytes (32 a random table read,
plus the index and output streams) with the rate the shipped kernel's
time implies. Prints one JSON object with the card's name and power
limit (and writes it to ``--out``). Needs a CUDA card and ``nvcc``.

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
    H, W, generator, l2_sectors, randint,
)
from slambench_tpu_torch.tools.timing import bound_ms, per_launch_ms

SOURCE = os.path.join(build.CSRC, "gather.cu")
LOST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "gather_variants.cu")
SHIPPED = "shipped (kLookups 4)"
_LOOKUPS = "constexpr int kLookups = 4;"
_CARVEOUT = """    cudaError_t err = cudaFuncSetAttribute(
        gather_flat<T, Src>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxL1);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor("""
_BY_TMA = "const bool by_tma = aligned && nrows == 1;"
_DSMEM = "ld_cluster(stage + (q - owner * share), owner)"
_NAMESPACE = "namespace {\n\nnamespace cg = cooperative_groups;"
_MOST = "const long long most = static_cast<long long>(nsm) * per_sm;"
_CLUSTER = "constexpr int kCluster = 8;"
_CLUSTER_WAIT = """wait_stage(bar);
          cluster_sync_thread();
        });"""
_CLUSTER_EXIT = """  cluster_sync_thread();      // no share leaves while a peer reads it
}"""
# G3's and G4's index loads (the read-only path as shipped).
_STAGED_LOADS = ("load_idx<false>", "ld_index<false>",
                 "FlatIdx<false, kFill>{idx, n_table}")
# {name: ([(shipped text, variant text)], checked against the twin)}.
VARIANTS = {
    SHIPPED: ([], True),
    **{f"kLookups {k}": ([(_LOOKUPS, f"constexpr int kLookups = {k};")],
                         True) for k in (1, 2, 8)},
    "default carveout": ([(_CARVEOUT, """    cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(""")], True),
    "sublane rows by TMA": ([(_BY_TMA, "const bool by_tma = aligned;")],
                            True),
    "flat generic DSMEM": ([(_DSMEM, "cluster.map_shared_rank(stage, "
                             "owner)[q - owner * share]")], True),
    "flat local reads": ([(_DSMEM, "stage[q - owner * share]")], False),
    "flat local reads, no cluster barrier": (
        [(_DSMEM, "stage[q - owner * share]"),
         (_CLUSTER_WAIT, "wait_stage(bar);\n        });"),
         (_CLUSTER_EXIT, "}")], False),
    "no streaming hints": ([(_NAMESPACE, "#define __ldcs(p) __ldg(p)\n"
                             "#define __stcs(p, v) (*(p) = (v))\n"
                             + _NAMESPACE)], True),
    "index loads without hint": ([(_NAMESPACE, "#define __ldcs(p) __ldg(p)\n"
                                   + _NAMESPACE)], True),
    "stores without hint": ([(_NAMESPACE, "#define __stcs(p, v) (*(p) = (v))\n"
                              + _NAMESPACE)], True),
    "staged index loads with hint": (
        [(text, text.replace("false", "true")) for text in _STAGED_LOADS],
        True),
    "grid unbounded": ([(_MOST, "const long long most = 1LL << 30;")], True),
    **{f"cluster {c}": ([(_CLUSTER, f"constexpr int kCluster = {c};")], True)
       for c in (2, 4)},
}
# G4 by the share the C entry is given (SHARE_FLOATS: the staged route,
# one block's worth of the table in every block and the rest read from
# device memory; 0: device memory), at P3's 240x320 image, at tables of
# which a block stages a half (302x384) and a third (454x384), and at a
# 720x1280 image.
G4_TABLES = {"p3": (H, W), "302x384": (302, 384), "454x384": (454, 384),
             "720p": (720, 1280)}
G4_ROUTES = {f"G4 {name} {'staged' if share else 'device memory'}":
             (shape, share) for name, shape in G4_TABLES.items()
             for share in (gather.SHARE_FLOATS, 0)}
# gather_variants.cu on the shipped copy: G4 at P3 and G2 flat at P1 by
# (cluster, local_only), G3 at P2 by (cluster, blocks; 0: one an SM).
G4_CLUSTERS = {**{f"G4 p3 over clusters of {c} (DSMEM)": (c, 0)
                  for c in (2, 4, 8)},
               "G4 p3 over pairs, local only": (2, 1)}
G2_CLUSTERS = {"G2 flat p1 over pairs, local only": (2, 1)}
G3_LOST = {"G3 p2 multicast 2": (2, 0), "G3 p2 multicast 4": (4, 0),
           "G3 p2 66 blocks": (1, 66), "G3 p2 33 blocks": (1, 33),
           "G3 p2 multicast 2, 66 blocks": (2, 66)}


def variant_source(changes) -> str:
    with open(SOURCE) as f:
        src = f.read()
    for shipped, variant in changes:
        if shipped not in src:
            raise RuntimeError(f"csrc/gather.cu no longer holds {shipped!r}")
        src = src.replace(shipped, variant)
    with open(LOST) as f:
        return src + "\n" + f.read()


def bind(lib):
    """Bind a copy's G1-G4 and the entries of ``gather_variants.cu``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    build.bind_gather(lib)
    lib.slb_sweep_g3.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.slb_sweep_cluster.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                      vp]
    lib.slb_sweep_g3.restype = lib.slb_sweep_cluster.restype = ci
    return lib


def shapes(device: torch.device) -> dict:
    """{name: (table, idx)} at the probes' shapes (G1)."""
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
    libs = {name: bind(lib) for name, lib in build.build_variants(
        {name: variant_source(spec[0])
         for name, spec in VARIANTS.items()}, "gather_sweep").items()}
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

    def g3(lib, table, idx):
        out = torch.empty(idx.shape, dtype=torch.float32, device=device)
        build.check(lib.slb_gather_smem_u16(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
            table.numel(), nsm, stream), "gather_smem_u16 variant")
        return out

    def g3_lost(lib, table, idx, cluster, blocks):
        out = torch.empty(idx.shape, dtype=torch.float32, device=device)
        build.check(lib.slb_sweep_g3(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
            table.numel(), cluster, blocks, nsm, stream), "G3 variant")
        return out

    def g4(lib, table, vi, ui, share):
        out = torch.empty(vi.shape, dtype=torch.float32, device=device)
        build.check(lib.slb_gather_2d_f32(
            table.data_ptr(), vi.data_ptr(), ui.data_ptr(), out.data_ptr(),
            vi.numel(), *table.shape, share, nsm, stream),
            "gather_2d variant")
        return out

    def over_cluster(lib, table, vi, ui, cluster, local_only):
        """G4 (ui given) or G2 flat (ui None) over a cluster."""
        out = torch.empty(vi.shape, dtype=torch.float32, device=device)
        build.check(lib.slb_sweep_cluster(
            table.data_ptr(), vi.data_ptr(),
            None if ui is None else ui.data_ptr(), out.data_ptr(),
            vi.numel(), *table.shape, cluster, local_only, nsm, stream),
            "cluster variant")
        return out

    p1 = cases["p1"][0]
    gen = generator(device, 12)
    axis_idx = {"flat": cases["p1"][1],
                "lane": randint(gen, 0, 128, (256, 128), device),
                "sublane": randint(gen, 0, 256, (256, 128), device)}
    mm = randint(gen, 0, 5000, (H, W), device).to(torch.uint16)
    idx2 = cases["p2"][1]
    g4_args = {}
    for shape in G4_TABLES.values():
        g4_args[shape] = (
            torch.rand(shape, generator=gen, device=device) * 5,
            randint(gen, 0, shape[0], (1024, 2048), device),
            randint(gen, 0, shape[1], (1024, 2048), device))
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
        for name, (shape, share) in G4_ROUTES.items():
            a = g4_args[shape]
            calls[(v, name)] = (
                lambda lib=lib, c=share, a=a: g4(lib, *a, c),
                lambda a=a: gather.gather_2d_plain(*a))
        calls[(v, "G3 p2")] = (lambda lib=lib: g3(lib, mm, idx2),
                               lambda: gather.gather_u16_plain(mm, idx2))
    lib, a = libs[SHIPPED], g4_args[(H, W)]
    for name, (c, local) in G4_CLUSTERS.items():
        calls[(SHIPPED, name)] = (
            lambda c=c, local=local: over_cluster(lib, *a, c, local),
            lambda: gather.gather_2d_plain(*a))
    for name, (c, local) in G2_CLUSTERS.items():
        calls[(SHIPPED, name)] = (
            lambda c=c, local=local: over_cluster(
                lib, p1, axis_idx["flat"], None, c, local),
            lambda: gather.gather_axis_plain(p1, axis_idx["flat"], "flat"))
    for name, (c, b) in G3_LOST.items():
        calls[(SHIPPED, name)] = (
            lambda c=c, b=b: g3_lost(lib, mm, idx2, c, b),
            lambda: gather.gather_u16_plain(mm, idx2))
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
    n = idx2.numel()
    for shape in g4_args:
        nbytes = 12 * n + 4 * shape[0] * shape[1]
        yardsticks[f"G4 {shape[0]}x{shape[1]}"] = {
            "lookups": n, "bytes": nbytes, "bound_ms": bound_ms(nbytes)}
    yardsticks["G3 p2"] = {"lookups": n, "bytes": 8 * n + mm.numel() * 2,
                           "bound_ms": bound_ms(8 * n + mm.numel() * 2, n)}
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
