// G1-G4: table gathers, the Hopper counterparts of the three Pallas
// gather probes in slambench_tpu/tools/mosaic_probe.py (P1
// probe_mosaic_gathers.try_kernel.run, P2 probe_mosaic_wide_gather.
// run_wide, P3 probe_mosaic_wide_gather.run_adv).
//
// On the TPU those kernels asked whether Mosaic could lower a gather from
// a VMEM-resident table at all. On Hopper every thread can load from any
// address, so the question becomes how fast the card serves a gather, and
// from which memory: device memory through L2 and the read-only path
// (G1, G4's device-memory route) or a table staged into shared memory
// (G2, G3, G4's staged route).
//
// Bound: bytes. A lookup moves a 4-byte index in (G4 two) and a 4-byte
// value out and does no arithmetic (G3 one division), so the least time
// is (indices + output + table once) / 3.35 TB/s. Random lookups touch a
// new 32-byte sector per table read; while the table fits the 50 MB L2
// those reads stay on chip and only the index and output streams reach
// HBM. At P1's 32,768 lookups the bound (0.117 us) is far below an empty
// launch (~1.8 us): what a design there can remove is the time above it.
//
// Every kernel walks its lookups the same way (serve()): a persistent
// grid, kLookups consecutive lookups a thread with one 16-byte index load
// a stream (ld_index) and one 16-byte store (__stcs, streaming), every
// table read of the group issued before any is used, warps of work
// spread over the blocks first; a scalar head and tail take the lookups
// before the index is 16-byte aligned and after the last whole group, and
// every lookup goes the scalar way when the streams sit at different
// offsets within 16 bytes (the wrappers allocate out at the index's
// offset, so their own calls take the vector way). A staged kernel's
// threads load their first indices before they wait for the stage, so
// the index stream overlaps the copy.
//
// G1 gather_flat (replaces P1's flat form and P2, mosaic_probe.py:56 and
// :217): the table in device memory (__ldg). Measured on the H100
// (PERF.md), what bounds it is L2's rate of random 32-byte sectors, one
// a lookup, not latency: 1, 2, 4 or 8 lookups a thread take the same
// time; the hints keep a 32 MB table in L2 (8% at 16.7 M lookups).
//
// G2 gather_axis_smem (replaces P1, mosaic_probe.py:56). At P1's size a
// staged gather is bound by its rounds of staging and synchronisation
// above the launch, not by bytes, so every mode spreads over at least a
// block an SM and stages only what its outputs can read, by asynchronous
// copy completing on an mbarrier while the block loads its first indices:
//   * flat: gather_flat_cluster, thread-block clusters of kCluster; each block
//     stages 1/kCluster of the table by one TMA bulk copy
//     (cp.async.bulk) and a lookup reads the owning block's share
//     through distributed shared memory (mapa, ld.shared::cluster) after
//     a cluster barrier; a second one keeps every share alive until the
//     cluster's last read. The remote reads and the cluster's barriers
//     cost ~2 us above the lane mode's time (PERF.md);
//   * lane: each block serves a contiguous piece of the outputs and
//     stages the table rows that piece reads (out[r, c] = t[r, idx]), one
//     TMA bulk copy;
//   * sublane: each block serves kBandCols columns of a chunk of output
//     rows and stages those columns of every table row (out[r, c] =
//     t[idx, c]), 16 bytes a row by cp.async from all its threads.
// A segment whose address or size is not a multiple of 16 bytes is staged
// (in the part the copy cannot take) by the block's own loads, which
// arrive on the same mbarrier.
//
// G3 gather_smem_u16 (replaces P2 on chip). The uint16 millimetre image
// (240x320 = 153,600 bytes) staged in shared memory by TMA bulk copy on
// an mbarrier, one block of kStageThreads an SM (the stage fills most of
// the SM's shared memory), each thread's first index load issued before
// it waits for the stage. What the old design paid above the streams was
// a staging loop of scalar loads and a __syncthreads before the first
// index load. Sharing the stage's L2 traffic across a cluster by TMA
// multicast, or staging in fewer blocks, costs more than it saves
// (tools/gather_variants.cu, timed by tools/gather_sweep.py; PERF.md).
//
// G4 gather_2d (replaces P3, mosaic_probe.py:246), two routes chosen by
// the table's size alone (the wrapper's rule). G1 on P3's image showed
// the cost of the old kernel: every table read a random L2 sector (67 MB
// beside 25 MB of streams) at L2's sector rate.
//   * staged (gather_2d_staged): every block stages the table's first
//     `share` floats (the wrapper passes as many as a block holds beside
//     its barrier, 58,108: all of a table that fits, 76% of P3's
//     307,200-byte image) by one TMA bulk copy and reads the rest from
//     device memory by a predicated load, so most table reads leave L2.
//     The table split over a cluster and read through distributed shared
//     memory, the design first built, is slower: random 4-byte remote
//     reads are slow (tools/gather_variants.cu; PERF.md);
//   * device memory (gather_flat, G1's loop on the 2-D index): share 0,
//     which the wrapper passes for tables of which a block would stage
//     less than half.
//
// Contracts (the plain twins in ops/hopper/gather.py are the reference;
// each out-of-range index gives what the Pallas body gives in interpret
// mode):
//   * G1 gather_flat: out[i] = float(table[idx[i]]), table f32, int16 or
//     uint16 (the integer types widen exactly). mode 1 (kClip) does what
//     JAX's mode="clip" does: an index in [-n_table, 0) first becomes
//     idx + n_table (NumPy-style), then the index is clipped to
//     [0, n_table - 1]; mode 2 (kFill) wraps the same way and gives NaN
//     for any other out-of-range index, reading nothing (JAX's default
//     for take / take_along_axis, which P1's flat body and P2 use); mode
//     0 (kPromise): idx must be in range, as mode="promise_in_bounds".
//   * G2 gather_axis_smem: an f32 [rows, cols] table (at most 232,448
//     bytes), mode 0 flat (take(t.ravel(), i)), 1 lane
//     (take_along_axis(t, i, axis=1)) or 2 sublane
//     (take_along_axis(t, i, axis=0)); kFill along the gathered axis.
//   * G3 gather_smem_u16: kFill over the table, each lookup converted as
//     mm2meters does: float(mm) / 1000.0f. Built without
//     --use_fast_math, so the division is IEEE and the result equals G1
//     on the f32 metre image bit for bit.
//   * G4 gather_2d: out[i] = table[vi', ui'], f32, where each index first
//     wraps from [-n, 0) and is then clipped to [0, n - 1] along its axis
//     (P3's t[vi, ui]): memory-safe on any input.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kFlatThreads = 256;
constexpr int kBandThreads = 256;
constexpr int kStageThreads = 1024;   // G3, G4 staged: a block an SM
// Consecutive lookups a thread serves: one 16-byte index load a stream
// and one 16-byte store. tools/gather_sweep.py sweeps 1 / 2 / 4 / 8 on
// copies of this file (PERF.md).
constexpr int kLookups = 4;
constexpr int kCluster = 8;        // G2 flat: blocks sharing one table
constexpr int kBandCols = 4;       // G2 sublane: 16 bytes of a table row
constexpr int kMaxSmemBytes = 232448;
constexpr int kDefaultSmemBytes = 48 * 1024;

// JAX's gather modes, as the kernels take them.
enum GatherMode : int { kPromise = 0, kClip = 1, kFill = 2 };

// JAX's mode="clip": an index in [-n, 0) wraps NumPy-style, then the
// result is clipped to [0, n - 1] (j + n cannot overflow: j < 0).
__device__ __forceinline__ int clip_index(int j, int n) {
  if (j < 0) j += n;
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}

// JAX's mode="fill": an index in [-n, 0) wraps; any other index outside
// [0, n) gives -1, which the kernels turn into NaN (G1 reads nothing for
// it; a staged kernel reads its stage's entry 0 and drops it).
__device__ __forceinline__ int fill_index(int j, int n) {
  if (j < 0) j += n;
  return j >= 0 && j < n ? j : -1;
}

__device__ __forceinline__ float fill_nan() {
  return __int_as_float(0x7fc00000);
}

// A lookup's value, or NaN where its position is -1. The reads go to a
// position that is always valid (0 for -1), or under a predicate, and the
// NaN is selected after: a read inside a branch on the position makes
// each lookup wait for its read before the next one issues (G1 on int16
// tables lost its 4 reads in flight that way; PERF.md).
__device__ __forceinline__ float or_nan(int j, float v) {
  return j < 0 ? fill_nan() : v;
}

// float(*p) where `take`, else `otherwise`, by a predicated read-only load
// (nothing is read where `take` is false): unlike a load under a branch,
// it leaves the thread's other loads in flight beside it.
__device__ __forceinline__ float ldg_if(const float* p, bool take,
                                        float otherwise) {
  float v = otherwise;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q ld.global.nc.f32 %0, [%1];\n\t}"
      : "+f"(v) : "l"(p), "r"(static_cast<unsigned>(take)));
  return v;
}

__device__ __forceinline__ float ldg_if(const int16_t* p, bool take,
                                        float otherwise) {
  int v = 0;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q ld.global.nc.s16 %0, [%1];\n\t}"
      : "+r"(v) : "l"(p), "r"(static_cast<unsigned>(take)));
  return take ? static_cast<float>(v) : otherwise;
}

__device__ __forceinline__ float ldg_if(const uint16_t* p, bool take,
                                        float otherwise) {
  unsigned v = 0;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q ld.global.nc.u16 %0, [%1];\n\t}"
      : "+r"(v) : "l"(p), "r"(static_cast<unsigned>(take)));
  return take ? static_cast<float>(v) : otherwise;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------- vector access of kLookups lanes ------------------- //

template <int L> struct Lanes;
template <> struct Lanes<1> { using I = int; using F = float; };
template <> struct Lanes<2> { using I = int2; using F = float2; };
template <> struct Lanes<4> { using I = int4; using F = float4; };
constexpr int kVec = kLookups < 4 ? kLookups : 4;   // lanes an access
static_assert(kLookups % kVec == 0, "kLookups: 1, 2 or a multiple of 4");
using IdxVec = Lanes<kVec>::I;
using OutVec = Lanes<kVec>::F;

// An index load: with the streaming hint (__ldcs, evict-first) or by the
// read-only path (__ldg). G1 and G2 take the hint, which keeps G1's table
// in L2 against its index stream (-8% at 16.7 M lookups into the 32 MB
// volume); G3 and G4, whose table reads do not depend on L2 keeping the
// table, take the read-only path (kHint false), 8-11% faster at P2 and P3
// (PERF.md).
template <bool kHint, typename V>
__device__ __forceinline__ V ld_index(const V* p) {
  if constexpr (kHint) {
    return __ldcs(p);
  } else {
    return __ldg(p);
  }
}
template <bool kHint>
__device__ __forceinline__ void load_idx(int (&j)[kLookups],
                                         const int* p) {
#pragma unroll
  for (int v = 0; v < kLookups / kVec; ++v) {
    const IdxVec q =
        ld_index<kHint>(reinterpret_cast<const IdxVec*>(p) + v);
    const int* lane = reinterpret_cast<const int*>(&q);
#pragma unroll
    for (int k = 0; k < kVec; ++k) j[v * kVec + k] = lane[k];
  }
}

__device__ __forceinline__ void store_out(float* p,
                                          const float (&x)[kLookups]) {
#pragma unroll
  for (int v = 0; v < kLookups / kVec; ++v) {
    OutVec q;
    float* lane = reinterpret_cast<float*>(&q);
#pragma unroll
    for (int k = 0; k < kVec; ++k) lane[k] = x[v * kVec + k];
    __stcs(reinterpret_cast<OutVec*>(p) + v, q);
  }
}

// ---------------------------- index streams ---------------------------- //
// Each loads a lookup's raw indices from its stream(s) (group: kLookups
// consecutive ones; one: a single one) and resolves them into a table
// position, or -1 for NaN (at). lead() is the stream whose alignment
// sets the scalar head, vec(head) whether the other streams allow the
// vector way from there. serve() resolves only after a staged kernel's
// wait, so the loads stay in flight across it.

struct Raw {        // a lookup's loaded indices (v alone for one stream)
  int v, u;
};

// One index a lookup, resolved against n entries by a GatherMode (a
// template argument: resolving by a mode read at run time put each
// lookup's resolve and read under branches; PERF.md).
template <bool kHint, int kMode>
struct FlatIdx {
  static constexpr bool kFills = kMode == kFill;   // positions may be -1
  const int* idx;
  int n;
  __device__ int at(Raw r) const {
    if constexpr (kMode == kClip) return clip_index(r.v, n);
    if constexpr (kMode == kFill) return fill_index(r.v, n);
    return r.v;
  }
  __device__ const void* lead() const { return idx; }
  __device__ bool vec(unsigned) const { return true; }
  __device__ void group(Raw (&r)[kLookups], unsigned p0) const {
    int v[kLookups];
    load_idx<kHint>(v, idx + p0);
#pragma unroll
    for (int k = 0; k < kLookups; ++k) r[k] = Raw{v[k], 0};
  }
  __device__ Raw one(unsigned p) const {
    return Raw{ld_index<kHint>(idx + p), 0};
  }
};

// G4: the flat position of t[vi, ui] in a [rows, cols] table, each axis
// wrapped and clipped as P3's Pallas body does (always in range).
struct Idx2d {
  static constexpr bool kFills = false;
  const int* vi;
  const int* ui;
  int rows, cols;
  __device__ int at(Raw r) const {
    return clip_index(r.v, rows) * cols + clip_index(r.u, cols);
  }
  __device__ const void* lead() const { return vi; }
  __device__ bool vec(unsigned head) const { return aligned16(ui + head); }
  __device__ void group(Raw (&r)[kLookups], unsigned p0) const {
    int v[kLookups], u[kLookups];
    load_idx<false>(v, vi + p0);
    load_idx<false>(u, ui + p0);
#pragma unroll
    for (int k = 0; k < kLookups; ++k) r[k] = Raw{v[k], u[k]};
  }
  __device__ Raw one(unsigned p) const {
    return Raw{ld_index<false>(vi + p), ld_index<false>(ui + p)};
  }
};

// Serves out[p] = fetch(position p, p) for p in [0, n) with the threads
// tid = 0..nthreads-1: groups of kLookups by 16-byte accesses where the
// streams allow it, the rest one lookup at a time, kLookups in flight a
// thread. Each thread calls ready() once, after its first index loads
// and before it resolves them (or at the end, if it has none): the
// staged kernels wait there for their stage, so the index loads overlap
// it (a use of a loaded index before the wait would stall on the load
// first; PERF.md).
template <typename Src, typename Fetch, typename Ready>
__device__ __forceinline__ void serve(const Src& src,
                                      float* __restrict__ out, unsigned n,
                                      unsigned tid, unsigned nthreads,
                                      Fetch fetch, Ready ready) {
  bool pending = true;
  auto go = [&] {
    if (pending) {
      ready();
      pending = false;
    }
  };
  unsigned head = static_cast<unsigned>(
      ((16 - (reinterpret_cast<uintptr_t>(src.lead()) & 15)) & 15) / 4);
  head = head < n ? head : n;
  unsigned body_end = 0;          // [head, body_end): whole groups
  if (aligned16(out + head) && src.vec(head)) {
    const unsigned groups = (n - head) / kLookups;
    body_end = head + groups * kLookups;
    for (unsigned g = tid; g < groups; g += nthreads) {
      const unsigned p0 = head + g * kLookups;
      Raw r[kLookups];
      int j[kLookups];
      float v[kLookups];
      src.group(r, p0);
      go();
#pragma unroll
      for (int k = 0; k < kLookups; ++k) {
        j[k] = src.at(r[k]);
        v[k] = fetch(j[k], p0 + k);
      }
      store_out(out + p0, v);
    }
  } else {
    head = 0;                     // misaligned apart: all scalar
  }
  // Scalar lookups: [0, head) and [body_end, n) (all of [0, n) when the
  // vector way does not apply).
  const unsigned rest = head + (n - body_end);
  for (unsigned b = tid; b < rest; b += nthreads * kLookups) {
    unsigned p[kLookups];
    Raw r[kLookups];
    int j[kLookups];
    float v[kLookups];
#pragma unroll
    for (int k = 0; k < kLookups; ++k) {
      const unsigned q = b + k * nthreads;
      p[k] = q < head ? q : body_end + (q - head);
      r[k] = q < rest ? src.one(p[k]) : Raw{0, 0};
    }
    go();
#pragma unroll
    for (int k = 0; k < kLookups; ++k) {
      j[k] = src.at(r[k]);
      if (b + k * nthreads < rest) v[k] = fetch(j[k], p[k]);
    }
#pragma unroll
    for (int k = 0; k < kLookups; ++k)
      if (b + k * nthreads < rest) __stcs(out + p[k], v[k]);
  }
  go();
}

// --------------------- staging: TMA and mbarrier ---------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Thread 0's part of a stage's barrier: count arrivals (thread 0's own,
// which comes with the bytes the copies will bring, and one a thread).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count,
                                          uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar)
               : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into this block's shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Stages nrows segments of seg entries, src + k * stride -> dst + k *
// seg, into shared memory by asynchronous copy. Where every segment
// starts 16-byte aligned (src aligned; for several rows also seg and
// stride multiples of 16 bytes), the 16-byte multiple of one segment goes
// by one TMA bulk copy completing on bar, and several rows go by
// cp.async, one 16-byte request a chunk from all the threads (a TMA bulk
// copy would take one request a row, each as slow to issue as a whole
// band: PERF.md); the rest (all of it otherwise) by the threads' own
// loads. bar counts blockDim.x + 1 arrivals: thread 0's with the expected
// bytes, and every thread's once its own loads are stored or its cp.async
// requests have landed, so wait_stage(bar) returns once the whole stage
// is in shared memory. Called by every thread of the block, once a launch
// (the barrier is new each launch).
// A stage that leaves no room for the barrier's 8 bytes (a table of the
// full 232,448 bytes staged whole) comes with bar null: the threads load
// it all themselves and meet at __syncthreads.
template <typename T>
__device__ void stage_rows(T* dst, const T* src, int nrows, int seg,
                           int stride, uint64_t* bar) {
  constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));
  if (bar == nullptr) {
    for (int e = threadIdx.x; e < nrows * seg; e += blockDim.x) {
      const int k = e / seg;
      dst[e] = __ldg(src + static_cast<size_t>(k) * stride + (e - k * seg));
    }
    __syncthreads();
    return;
  }
  const bool aligned =
      seg > 0 && aligned16(src) &&
      (nrows == 1 || (seg % kPer16 == 0 && stride % kPer16 == 0));
  const bool by_tma = aligned && nrows == 1;
  const bool by_lsu = aligned && !by_tma;
  const int seg_bulk = aligned ? seg & ~(kPer16 - 1) : 0;
  const uint32_t b = smem_u32(bar);
  if (threadIdx.x == 0)
    mbar_init(b, blockDim.x + 1,
              by_tma ? static_cast<uint32_t>(nrows * seg_bulk * sizeof(T))
                     : 0u);
  __syncthreads();
  if (by_lsu) {
    const int chunks = seg_bulk / kPer16;      // 16-byte chunks a row
    for (int e = threadIdx.x; e < nrows * chunks; e += blockDim.x) {
      const int k = e / chunks;
      const int c = kPer16 * (e - k * chunks);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   :: "r"(smem_u32(dst + k * seg + c)),
                      "l"(src + static_cast<size_t>(k) * stride + c)
                   : "memory");
    }
    // seg is a multiple of 16 bytes here: nothing is left for own loads.
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(b) : "memory");
    return;
  }
  if (by_tma && seg_bulk > 0) {
    for (int k = threadIdx.x; k < nrows; k += blockDim.x)
      bulk_copy(dst + k * seg, src + static_cast<size_t>(k) * stride,
                seg_bulk * sizeof(T), b);
  }
  const int rest = seg - seg_bulk;
  for (int e = threadIdx.x; e < nrows * rest; e += blockDim.x) {
    const int k = e / rest;
    const int c = seg_bulk + (e - k * rest);
    dst[k * seg + c] = __ldg(src + static_cast<size_t>(k) * stride + c);
  }
  mbar_arrive(b);
}

__device__ __forceinline__ void wait_stage(uint64_t* bar) {
  if (bar == nullptr) return;
  const uint32_t b = smem_u32(bar);
  while (!mbar_try_wait(b, 0)) {
  }
}

// The stage's barrier: 8 bytes at float bar_at of the dynamic shared
// memory, or none (bar_at < 0; see stage_rows).
__device__ __forceinline__ uint64_t* stage_barrier(float* stage,
                                                   int bar_at) {
  return bar_at < 0 ? nullptr
                    : reinterpret_cast<uint64_t*>(stage + bar_at);
}

// Reads the float at `local` in the shared memory of cluster block
// `rank` (distributed shared memory), by its shared::cluster address.
__device__ __forceinline__ float ld_cluster(const float* local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(smem_u32(local)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote));
  return v;
}

// A thread's rank in a walk over `units` units of blockDim.x threads
// (unit u = blockIdx.x / per, where per blocks share one walk):
// consecutive warps of ranks go to different units first, so that a
// launch with fewer lookups than threads spreads them over every unit,
// while each warp's index and output accesses stay contiguous.
// blockDim.x is a multiple of 32.
__device__ __forceinline__ unsigned spread_rank(unsigned per = 1) {
  return ((threadIdx.x >> 5) * (gridDim.x / per) + blockIdx.x / per) * 32 +
         (threadIdx.x & 31);
}

// Per-thread cluster barrier (not .aligned: threads reach it at
// different points of serve()).
__device__ __forceinline__ void cluster_sync_thread() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// ------------------------------ kernels ------------------------------- //

// G1, and G4's device-memory route (Src Idx2d).
template <typename T, typename Src>
__global__ void __launch_bounds__(kFlatThreads)
gather_flat(const T* __restrict__ table, Src src, float* __restrict__ out,
            int n) {
  serve(src, out, static_cast<unsigned>(n), spread_rank(),
        gridDim.x * kFlatThreads,
        [=](int j, unsigned) {
          if constexpr (Src::kFills) {
            return ldg_if(&table[j], j >= 0, fill_nan());
          } else {
            return static_cast<float>(__ldg(&table[j]));
          }
        },
        [] {});
}

// G2 flat: rank r of each cluster stages table[r * share, (r + 1) *
// share); a lookup reads its owner's share through distributed shared
// memory.
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kBandThreads)
gather_flat_cluster(const float* __restrict__ table,
                    FlatIdx<true, kFill> src, float* __restrict__ out,
                    int n_table, int share, int n) {
  extern __shared__ __align__(16) float stage[];
  uint64_t* bar = stage_barrier(stage, share);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lo = min(rank * share, n_table);
  stage_rows(stage, table + lo, 1, min(share, n_table - lo), 0, bar);
  serve(src, out, static_cast<unsigned>(n), spread_rank(),
        gridDim.x * kBandThreads,
        [&](int j, unsigned) {
          const int q = j < 0 ? 0 : j;
          const int owner = q / share;
          return or_nan(j, ld_cluster(stage + (q - owner * share), owner));
        },
        [&] {
          wait_stage(bar);
          cluster_sync_thread();
        });
  cluster_sync_thread();      // no share leaves while a peer reads it
}

// G4's staged route: every block stages the table's first `share` floats
// (a multiple of 4; all of a table that fits) and reads a position past
// them from device memory.
__global__ void __launch_bounds__(kStageThreads)
gather_2d_staged(const float* __restrict__ table, Idx2d src,
                 float* __restrict__ out, int n_table, int share, int n) {
  extern __shared__ __align__(16) float stage[];
  uint64_t* bar = stage_barrier(stage, share);
  stage_rows(stage, table, 1, min(share, n_table), 0, bar);
  serve(src, out, static_cast<unsigned>(n), spread_rank(),
        gridDim.x * kStageThreads,
        [&](int j, unsigned) {
          return ldg_if(&table[j], j >= share, stage[min(j, share - 1)]);
        },
        [&] { wait_stage(bar); });
}

// G2 lane (mode 1): block b serves outputs [b * per, (b + 1) * per) and
// stages the table rows they read. Sublane (mode 2): block (x, y) serves
// columns [x * kBandCols, +kBandCols) of output rows [y * per, +per) and
// stages those columns of every table row.
__global__ void __launch_bounds__(kBandThreads)
gather_axis_band(const float* __restrict__ table,
                 const int* __restrict__ idx, float* __restrict__ out,
                 int rows, int cols, int irows, int icols, int mode,
                 int per, int bar_at) {
  extern __shared__ __align__(16) float stage[];
  uint64_t* bar = stage_barrier(stage, bar_at);
  if (mode == 1) {
    const unsigned n = static_cast<unsigned>(irows) * icols;
    const unsigned begin = blockIdx.x * static_cast<unsigned>(per);
    if (begin >= n) return;
    const unsigned count = min(n - begin, static_cast<unsigned>(per));
    const int r0 = static_cast<int>(begin / icols);
    const int r1 = static_cast<int>((begin + count - 1) / icols) + 1;
    stage_rows(stage, table + static_cast<size_t>(r0) * cols, 1,
               (r1 - r0) * cols, 0, bar);
    serve(FlatIdx<true, kFill>{idx + begin, cols}, out + begin, count,
          threadIdx.x, kBandThreads,
          [&](int j, unsigned p) {
            const int r = static_cast<int>((begin + p) / icols) - r0;
            return or_nan(j, stage[r * cols + (j < 0 ? 0 : j)]);
          },
          [&] { wait_stage(bar); });
    return;
  }
  const int c0 = blockIdx.x * kBandCols;
  const int cw = min(kBandCols, cols - c0);
  const int q0 = blockIdx.y * per;
  const int q1 = min(irows, q0 + per);
  stage_rows(stage, table + c0, rows, cw, cols, bar);
  // Every row's band starts 16-byte aligned in idx and out.
  const bool vec = cw == kBandCols && cols % kBandCols == 0 &&
                   aligned16(idx) && aligned16(out);
  bool pending = true;
  for (int r = q0 + threadIdx.x; r < q1; r += kBandThreads) {
    const size_t base = static_cast<size_t>(r) * cols + c0;
    int j[kBandCols];
    float v[kBandCols];
    if (vec) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(idx + base));
      j[0] = q.x; j[1] = q.y; j[2] = q.z; j[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < kBandCols; ++k)
        j[k] = k < cw ? __ldcs(idx + base + k) : 0;
    }
    if (pending) {
      wait_stage(bar);
      pending = false;
    }
#pragma unroll
    for (int k = 0; k < kBandCols; ++k) {
      const int t = fill_index(j[k], rows);
      v[k] = k >= cw ? 0.0f : or_nan(t, stage[(t < 0 ? 0 : t) * cw + k]);
    }
    if (vec) {
      __stcs(reinterpret_cast<float4*>(out + base),
             make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int k = 0; k < kBandCols; ++k)
        if (k < cw) __stcs(out + base + k, v[k]);
    }
  }
  if (pending) wait_stage(bar);
}

// G3: the uint16 image staged whole in every block.
__global__ void __launch_bounds__(kStageThreads)
gather_smem_u16(const uint16_t* __restrict__ table,
                const int* __restrict__ idx, float* __restrict__ out, int n,
                int n_table, int bar_at) {
  extern __shared__ __align__(16) float stage[];
  uint16_t* mm = reinterpret_cast<uint16_t*>(stage);
  uint64_t* bar = stage_barrier(stage, bar_at);
  stage_rows(mm, table, 1, n_table, 0, bar);
  serve(FlatIdx<false, kFill>{idx, n_table}, out,
        static_cast<unsigned>(n),
        spread_rank(), gridDim.x * kStageThreads,
        [&](int j, unsigned) {
          return or_nan(j, static_cast<float>(mm[j < 0 ? 0 : j]) / 1000.0f);
        },
        [&] { wait_stage(bar); });
}

// Dynamic shared memory above 48 KB needs the kernel's attribute raised
// first; a refused size returns its error here and nothing is launched.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (bytes <= kDefaultSmemBytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) cudaGetLastError();   // leave none for the next
  return err;
}

// Dynamic shared memory for a stage of `floats` and its barrier behind
// it (8-byte aligned), or the stage alone when the two do not fit a
// block (*bar_at = -1).
int stage_bytes(int floats, int* bar_at) {
  const int at = (floats + 1) & ~1;
  if (4 * at + 8 <= kMaxSmemBytes) {
    *bar_at = at;
    return 4 * at + 8;
  }
  *bar_at = -1;
  return 4 * floats;
}

// G1's persistent grid: enough blocks for kLookups lookups a thread, but
// a block an SM while there is a warp's worth of work for each (spread by
// spread_rank), and at most as many as the SMs hold at once (asked once a
// kernel, with the L1 cache given all of the SM's shared memory).
template <typename T, typename Src>
cudaError_t launch_flat(const T* table, Src src, float* out, int n,
                        int nsm, cudaStream_t s) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_flat<T, Src>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxL1);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_flat<T, Src>, kFlatThreads, 0);
    if (err != cudaSuccess) {
      cudaGetLastError();
      per_sm = 0;
      return err;
    }
  }
  const long long groups = (static_cast<long long>(n) + kLookups - 1) /
                           kLookups;
  const long long full = (groups + kFlatThreads - 1) / kFlatThreads;
  const long long warps = (groups + 31) / 32;
  const long long spread = warps < nsm ? warps : nsm;
  const long long want = full > spread ? full : spread;
  const long long most = static_cast<long long>(nsm) * per_sm;
  const int blocks = static_cast<int>(want < most ? want : most);
  gather_flat<T, Src><<<blocks < 1 ? 1 : blocks, kFlatThreads, 0, s>>>(
      table, src, out, n);
  return cudaGetLastError();
}

// Blocks of kStageThreads for one group of kLookups a thread, at most
// `most`: a staged kernel's grid (each block pays for a stage).
int stage_blocks(int n, int most) {
  const long long groups = (static_cast<long long>(n) + kLookups - 1) /
                           kLookups;
  const long long want = (groups + kStageThreads - 1) / kStageThreads;
  return static_cast<int>(want < most ? (want < 1 ? 1 : want) : most);
}

// G4's staged route: the table's first `share` floats at most, rounded up
// to 16 bytes with the barrier behind them, one block an SM; a stage that
// does not fit a block is refused (allow_smem).
cudaError_t launch_2d_staged(const float* table, Idx2d src, float* out,
                             int n_table, int share, int n, int nsm,
                             cudaStream_t s) {
  const int floats = ((share < n_table ? share : n_table) + 3) & ~3;
  const int bytes = 4 * floats + 8;
  const cudaError_t err = allow_smem(gather_2d_staged, bytes);
  if (err != cudaSuccess) return err;
  gather_2d_staged<<<stage_blocks(n, nsm), kStageThreads, bytes, s>>>(
      table, src, out, n_table, floats, n);
  return cudaGetLastError();
}

template <typename T, int kMode>
cudaError_t launch_flat_mode(const void* table, const int* idx, float* out,
                             int n, int n_table, int nsm, cudaStream_t s) {
  return launch_flat(static_cast<const T*>(table),
                     FlatIdx<true, kMode>{idx, n_table}, out, n, nsm, s);
}

template <typename T>
cudaError_t launch_flat_typed(const void* table, const int* idx, float* out,
                              int n, int n_table, int mode, int nsm,
                              cudaStream_t s) {
  switch (mode) {
    case kPromise:
      return launch_flat_mode<T, kPromise>(table, idx, out, n, n_table, nsm,
                                           s);
    case kClip:
      return launch_flat_mode<T, kClip>(table, idx, out, n, n_table, nsm, s);
    case kFill:
      return launch_flat_mode<T, kFill>(table, idx, out, n, n_table, nsm, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// table_type: 0 float32, 1 int16, 2 uint16; mode: a GatherMode.
extern "C" int slb_gather_flat(const void* table, int table_type,
                               const int* idx, float* out, int n, int n_table,
                               int mode, int nsm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (table_type == 0) {
    err = launch_flat_typed<float>(table, idx, out, n, n_table, mode, nsm, s);
  } else if (table_type == 1) {
    err = launch_flat_typed<int16_t>(table, idx, out, n, n_table, mode, nsm,
                                     s);
  } else if (table_type == 2) {
    err = launch_flat_typed<uint16_t>(table, idx, out, n, n_table, mode, nsm,
                                      s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// G2. flat: ceil(nsm / kCluster) clusters (a block an SM), each block
// staging a share of the table rounded up to 16 bytes. lane: pieces of
// n / nsm outputs (a multiple of 4, so each piece keeps idx's alignment),
// each staging the rows it reads. sublane: bands of kBandCols columns
// times enough chunks of output rows for a block an SM; each block
// stages its columns of every row.
extern "C" int slb_gather_axis_smem_f32(const float* table, const int* idx,
                                        float* out, int rows, int cols,
                                        int irows, int icols, int mode,
                                        int nsm, void* stream) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long table_bytes = 4LL * rows * cols;
  if (table_bytes > kMaxSmemBytes || nsm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = irows * icols;
  const int n_table = rows * cols;
  cudaError_t err;
  if (mode == 0) {
    // A share is at most 1/kCluster of the table plus 16 bytes: its
    // barrier always fits behind it, at float `share` (a multiple of 4).
    const int share = ((n_table + kCluster - 1) / kCluster + 3) & ~3;
    const int bytes = 4 * share + 8;
    err = allow_smem(gather_flat_cluster, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int clusters = (nsm + kCluster - 1) / kCluster;
    gather_flat_cluster<<<clusters * kCluster, kBandThreads, bytes, s>>>(
        table, FlatIdx<true, kFill>{idx, n_table}, out, n_table, share, n);
  } else if (mode == 1) {
    const int per = (n / nsm) & ~3;
    const int piece = per < 4 ? 4 : per;
    const int blocks = (n + piece - 1) / piece;
    const int touched = piece / icols + 2;    // rows a piece can read
    const int band_rows = touched < rows ? touched : rows;
    int bar_at;
    const int bytes = stage_bytes(band_rows * cols, &bar_at);
    err = allow_smem(gather_axis_band, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    gather_axis_band<<<blocks, kBandThreads, bytes, s>>>(
        table, idx, out, rows, cols, irows, icols, 1, piece, bar_at);
  } else {
    const int bands = (cols + kBandCols - 1) / kBandCols;
    int chunks = (nsm + bands - 1) / bands;
    chunks = chunks < irows ? chunks : irows;
    const int per = (irows + chunks - 1) / chunks;
    const dim3 grid(bands, (irows + per - 1) / per);
    int bar_at;
    const int bytes =
        stage_bytes(rows * (cols < kBandCols ? cols : kBandCols), &bar_at);
    err = allow_smem(gather_axis_band, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    gather_axis_band<<<grid, kBandThreads, bytes, s>>>(
        table, idx, out, rows, cols, irows, icols, 2, per, bar_at);
  }
  return static_cast<int>(cudaGetLastError());
}

// G3: one block an SM. A table of the full 232,448 bytes leaves no room
// for the barrier: its blocks load it themselves.
extern "C" int slb_gather_smem_u16(const uint16_t* table, const int* idx,
                                   float* out, int n, int n_table, int nsm,
                                   void* stream) {
  if (nsm < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bar_at;
  const int bytes = stage_bytes((n_table + 1) / 2, &bar_at);
  const cudaError_t err = allow_smem(gather_smem_u16, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_smem_u16<<<stage_blocks(n, nsm), kStageThreads, bytes, s>>>(
      table, idx, out, n, n_table, bar_at);
  return static_cast<int>(cudaGetLastError());
}

// G4. share 0: the device-memory route (G1's grid); otherwise the staged
// route, every block staging the table's first `share` floats
// (launch_2d_staged). The wrapper picks the route and the share.
extern "C" int slb_gather_2d_f32(const float* table, const int* vi,
                                 const int* ui, float* out, int n, int rows,
                                 int cols, int share, int nsm,
                                 void* stream) {
  if (rows < 1 || cols < 1 || share < 0 || nsm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Idx2d src{vi, ui, rows, cols};
  if (share == 0)
    return static_cast<int>(launch_flat(table, src, out, n, nsm, s));
  return static_cast<int>(
      launch_2d_staged(table, src, out, rows * cols, share, n, nsm, s));
}
