// G1-G4: table gathers, the Hopper counterparts of the three Pallas
// gather probes in slambench_tpu/tools/mosaic_probe.py (P1
// probe_mosaic_gathers.try_kernel.run, P2 probe_mosaic_wide_gather.
// run_wide, P3 probe_mosaic_wide_gather.run_adv).
//
// On the TPU those kernels asked whether Mosaic could lower a gather from
// a VMEM-resident table at all. On Hopper every thread can load from any
// address, so the question becomes how fast the card serves a gather, and
// from which memory: device memory through L2 and the read-only path
// (G1, G4) or a table staged into shared memory (G2, G3).
//
// Bound: bytes. A lookup moves a 4-byte index in and a 4-byte value out
// and does no arithmetic (G3 one division), so the least time is
// (index + output + table once) / 3.35 TB/s. Random lookups touch a new
// 32-byte sector per table read; while the table fits the 50 MB L2 those
// reads stay on chip and only the index and output streams reach HBM.
// At P1's 32,768 lookups the bound (0.117 us) is far below an empty
// launch (~1.8 us): what a design there can remove is the time above it.
//
// G1 gather_flat (replaces P1's flat form and P2, mosaic_probe.py:56 and
// :217). A persistent grid (the SM count times the blocks an SM holds)
// walks the lookups kLookups at a time per thread: one 16-byte index load
// with a streaming hint (__ldcs), all kLookups table loads issued before
// any is used (__ldg), one 16-byte store with a streaming hint (__stcs),
// so the streams do not evict the table from L2. Warps of work go to
// different blocks first, so a small launch still uses every SM. A
// scalar head and tail take the lookups before idx is 16-byte aligned and
// after the last whole group; when idx and out sit at different offsets
// within 16 bytes, every lookup goes the scalar way, kLookups in flight a
// thread (the wrapper allocates out at idx's offset, so its own calls
// take the vector way). Measured on the H100 (PERF.md), what bounds G1 is
// the L2's rate of random 32-byte sectors, one a lookup, not latency:
// 1, 2, 4 or 8 lookups a thread take the same time; the hints keep a
// 32 MB table in L2 (8% at 16.7 M lookups).
//
// G2 gather_axis_smem (replaces P1, mosaic_probe.py:56). At P1's size a
// staged gather is bound by its rounds of staging and synchronisation
// above the launch, not by bytes, so every mode spreads over at least a
// block an SM and stages only what its outputs can read, by asynchronous
// copy completing on an mbarrier while the block loads its first indices:
//   * flat: thread-block clusters of kCluster; each block stages
//     1/kCluster of the table by one TMA bulk copy (cp.async.bulk) and a
//     lookup reads the owning block's share through distributed shared
//     memory (mapa, ld.shared::cluster) after a cluster barrier; a second
//     one keeps every share alive until the cluster's last read. The
//     remote reads and the cluster's barriers cost ~2 us above the lane
//     mode's time (PERF.md);
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
// Contracts (the plain twins in ops/hopper/gather.py are the reference):
//   * G1 gather_flat: out[i] = float(table[idx[i]]), table f32, int16 or
//     uint16 (the integer types widen exactly). clamp != 0 does what
//     JAX's mode="clip" does: an index in [-n_table, 0) first becomes
//     idx + n_table (NumPy-style), then the index is clipped to
//     [0, n_table - 1]; otherwise idx must be in range, as
//     mode="promise_in_bounds".
//   * G2 gather_axis_smem: an f32 [rows, cols] table (at most 232,448
//     bytes), mode 0 flat (take(t.ravel(), i)), 1 lane
//     (take_along_axis(t, i, axis=1)) or 2 sublane
//     (take_along_axis(t, i, axis=0)).
//   * G3 gather_smem_u16: the uint16 millimetre image in shared memory
//     (240x320 = 153,600 bytes; the f32 image, 307,200 bytes, does not
//     fit), each lookup converted as mm2meters does: float(mm) / 1000.0f.
//     Built without --use_fast_math, so the division is IEEE and the
//     result equals G1 on the f32 metre image bit for bit.
//   * G4 gather_2d: out[i] = table[vi[i] * cols + ui[i]], f32, in range.
// G2 and G3 clamp every index into the staged table (a negative one to
// 0), so a bad index reads a wrong value instead of faulting; in-range
// indices are exact.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kFlatThreads = 256;
constexpr int kBandThreads = 256;
constexpr int kSmemThreads = 1024;
// Consecutive lookups a thread serves (G1, G2 flat and lane): one 16-byte
// index load and one 16-byte store. tools/gather_sweep.py sweeps 1 / 2 /
// 4 / 8 on copies of this file (PERF.md).
constexpr int kLookups = 4;
constexpr int kCluster = 8;        // G2 flat: blocks sharing one table
constexpr int kBandCols = 4;       // G2 sublane: 16 bytes of a table row
// G3: lookups per thread that a staged block should serve before another
// block (and another copy of the table) is worth its staging cost.
constexpr int kLookupsPerThread = 8;
constexpr int kMaxSmemBytes = 232448;
constexpr int kDefaultSmemBytes = 48 * 1024;

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// JAX's mode="clip": an index in [-n, 0) wraps NumPy-style, then the
// result is clipped to [0, n - 1] (j + n cannot overflow: j < 0).
__device__ __forceinline__ int clip_index(int j, int n) {
  if (j < 0) j += n;
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
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

__device__ __forceinline__ void load_idx(int (&j)[kLookups],
                                         const int* p) {
#pragma unroll
  for (int v = 0; v < kLookups / kVec; ++v) {
    const IdxVec q = __ldcs(reinterpret_cast<const IdxVec*>(p) + v);
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

// Serves out[p] = fetch(idx[p], p) for p in [0, n) with the threads
// tid = 0..nthreads-1: groups of kLookups by 16-byte accesses where idx
// and out allow it, the rest one lookup at a time, kLookups in flight a
// thread. Each thread calls ready() once, after its first index load and
// before its first fetch (or at the end, if it has none): the staged
// kernels wait there for their stage, so the index loads overlap it.
template <typename Fetch, typename Ready>
__device__ __forceinline__ void serve(const int* __restrict__ idx,
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
      ((16 - (reinterpret_cast<uintptr_t>(idx) & 15)) & 15) / 4);
  head = head < n ? head : n;
  unsigned body_end = 0;          // [head, body_end): whole groups
  if (aligned16(out + head)) {
    const unsigned groups = (n - head) / kLookups;
    body_end = head + groups * kLookups;
    for (unsigned g = tid; g < groups; g += nthreads) {
      const unsigned p0 = head + g * kLookups;
      int j[kLookups];
      float v[kLookups];
      load_idx(j, idx + p0);
      go();
#pragma unroll
      for (int k = 0; k < kLookups; ++k) v[k] = fetch(j[k], p0 + k);
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
    int j[kLookups];
    float v[kLookups];
#pragma unroll
    for (int k = 0; k < kLookups; ++k) {
      const unsigned q = b + k * nthreads;
      p[k] = q < head ? q : body_end + (q - head);
      j[k] = q < rest ? __ldcs(idx + p[k]) : 0;
    }
    go();
#pragma unroll
    for (int k = 0; k < kLookups; ++k)
      if (b + k * nthreads < rest) v[k] = fetch(j[k], p[k]);
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

// Stages nrows segments of seg floats, src + k * stride -> dst + k * seg,
// into shared memory by asynchronous copy. Where every segment starts
// 16-byte aligned (src aligned; for several rows also seg and stride
// multiples of 4), the 16-byte multiple of one segment goes by one TMA
// bulk copy completing on bar, and several rows go by cp.async, one
// 16-byte request a chunk from all the threads (a TMA bulk copy would
// take one request a row, each as slow to issue as a whole band:
// PERF.md); the rest (all of it otherwise) by the threads' own loads. bar
// counts blockDim.x + 1 arrivals: thread 0's with the expected bytes, and
// every thread's once its own loads are stored or its cp.async requests
// have landed, so wait_stage(bar) returns once the whole stage is in
// shared memory. Called by every thread of the block, once a launch (the
// barrier is new each launch).
// A stage that leaves no room for the barrier's 8 bytes (a table of the
// full 232,448 bytes staged whole) comes with bar null: the threads load
// it all themselves and meet at __syncthreads.
__device__ void stage_rows(float* dst, const float* src, int nrows,
                           int seg, int stride, uint64_t* bar) {
  if (bar == nullptr) {
    for (int e = threadIdx.x; e < nrows * seg; e += blockDim.x) {
      const int k = e / seg;
      dst[e] = __ldg(src + static_cast<size_t>(k) * stride + (e - k * seg));
    }
    __syncthreads();
    return;
  }
  const bool aligned = seg > 0 && aligned16(src) &&
                       (nrows == 1 || (seg % 4 == 0 && stride % 4 == 0));
  const bool by_tma = aligned && nrows == 1;
  const bool by_lsu = aligned && !by_tma;
  const int seg_bulk = aligned ? seg & ~3 : 0;
  const uint32_t b = smem_u32(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(b), "r"(blockDim.x + 1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint32_t bytes =
        by_tma ? static_cast<uint32_t>(nrows) * seg_bulk * 4 : 0;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(bytes) : "memory");
  }
  __syncthreads();
  if (by_lsu) {
    const int chunks = seg_bulk / 4;           // 16-byte chunks a row
    for (int e = threadIdx.x; e < nrows * chunks; e += blockDim.x) {
      const int k = e / chunks;
      const int c = 4 * (e - k * chunks);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   :: "r"(smem_u32(dst + k * seg + c)),
                      "l"(src + static_cast<size_t>(k) * stride + c)
                   : "memory");
    }
    // seg is a multiple of 4 here: nothing is left for own loads.
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(b) : "memory");
    return;
  }
  if (by_tma) {
    for (int k = threadIdx.x; k < nrows; k += blockDim.x) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(smem_u32(dst + k * seg)),
             "l"(src + static_cast<size_t>(k) * stride),
             "r"(seg_bulk * 4), "r"(b)
          : "memory");
    }
  }
  const int rest = seg - seg_bulk;
  for (int e = threadIdx.x; e < nrows * rest; e += blockDim.x) {
    const int k = e / rest;
    const int c = seg_bulk + (e - k * rest);
    dst[k * seg + c] = __ldg(src + static_cast<size_t>(k) * stride + c);
  }
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(b)
               : "memory");
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

// A thread's rank in a grid-wide walk: consecutive warps of ranks go to
// different blocks first, so that a launch with fewer lookups than
// threads spreads them over every block (SM), while each warp's index
// and output accesses stay contiguous. blockDim.x is a multiple of 32.
__device__ __forceinline__ unsigned spread_rank() {
  return ((threadIdx.x >> 5) * gridDim.x + blockIdx.x) * 32 +
         (threadIdx.x & 31);
}

// Per-thread cluster barrier (not .aligned: threads reach it at
// different points of serve()).
__device__ __forceinline__ void cluster_sync_thread() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// ------------------------------ kernels ------------------------------- //

template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
gather_flat(const T* __restrict__ table, const int* __restrict__ idx,
            float* __restrict__ out, int n, int n_table, int clamp) {
  serve(idx, out, static_cast<unsigned>(n), spread_rank(),
        gridDim.x * kFlatThreads,
        [=](int j, unsigned) {
          if (clamp) j = clip_index(j, n_table);
          return static_cast<float>(__ldg(&table[j]));
        },
        [] {});
}

// G2 flat: rank r of each cluster stages table[r * share, (r + 1) *
// share); a lookup reads its owner's share through distributed shared
// memory.
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kBandThreads)
gather_flat_cluster(const float* __restrict__ table,
                    const int* __restrict__ idx, float* __restrict__ out,
                    int n_table, int share, int n) {
  extern __shared__ __align__(16) float stage[];
  uint64_t* bar = stage_barrier(stage, share);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lo = min(rank * share, n_table);
  stage_rows(stage, table + lo, 1, min(share, n_table - lo), 0, bar);
  serve(idx, out, static_cast<unsigned>(n), spread_rank(),
        gridDim.x * kBandThreads,
        [&](int j, unsigned) {
          j = clampi(j, n_table - 1);
          const int owner = j / share;
          return ld_cluster(stage + (j - owner * share), owner);
        },
        [&] {
          wait_stage(bar);
          cluster_sync_thread();
        });
  cluster_sync_thread();      // no share leaves while a peer reads it
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
    serve(idx + begin, out + begin, count, threadIdx.x, kBandThreads,
          [&](int j, unsigned p) {
            const int r = static_cast<int>((begin + p) / icols) - r0;
            return stage[r * cols + clampi(j, cols - 1)];
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
    for (int k = 0; k < kBandCols; ++k)
      v[k] = k < cw ? stage[clampi(j[k], rows - 1) * cw + k] : 0.0f;
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

__global__ void __launch_bounds__(kSmemThreads)
gather_smem_u16(const uint16_t* __restrict__ table, const int* __restrict__ idx,
                float* __restrict__ out, int n, int n_table) {
  extern __shared__ uint16_t mm[];
  for (int k = threadIdx.x; k < n_table; k += kSmemThreads)
    mm[k] = table[k];
  __syncthreads();
  for (int p = blockIdx.x * kSmemThreads + threadIdx.x; p < n;
       p += gridDim.x * kSmemThreads) {
    const int j = clampi(__ldg(&idx[p]), n_table - 1);
    out[p] = static_cast<float>(mm[j]) / 1000.0f;
  }
}

__global__ void __launch_bounds__(kFlatThreads)
gather_2d(const float* __restrict__ table, const int* __restrict__ vi,
          const int* __restrict__ ui, float* __restrict__ out, int n,
          int cols) {
  const int p = blockIdx.x * kFlatThreads + threadIdx.x;
  if (p >= n) return;
  out[p] = __ldg(&table[__ldg(&vi[p]) * cols + __ldg(&ui[p])]);
}

int flat_blocks(int n) { return (n + kFlatThreads - 1) / kFlatThreads; }

// Staged kernels: enough blocks for kLookupsPerThread lookups a thread,
// at most one per SM (a block's table fills most of an SM's shared memory).
int smem_blocks(int n, int nsm) {
  const int want = (n + kSmemThreads * kLookupsPerThread - 1) /
                   (kSmemThreads * kLookupsPerThread);
  return want < 1 ? 1 : (want > nsm ? nsm : want);
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
// table type, with the L1 cache given all of the SM's shared memory).
template <typename T>
cudaError_t launch_flat(const void* table, const int* idx, float* out,
                        int n, int n_table, int clamp, int nsm,
                        cudaStream_t s) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_flat<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxL1);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_flat<T>, kFlatThreads, 0);
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
  gather_flat<T><<<blocks < 1 ? 1 : blocks, kFlatThreads, 0, s>>>(
      static_cast<const T*>(table), idx, out, n, n_table, clamp);
  return cudaGetLastError();
}

}  // namespace

// table_type: 0 float32, 1 int16, 2 uint16.
extern "C" int slb_gather_flat(const void* table, int table_type,
                               const int* idx, float* out, int n, int n_table,
                               int clamp, int nsm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (table_type == 0) {
    err = launch_flat<float>(table, idx, out, n, n_table, clamp, nsm, s);
  } else if (table_type == 1) {
    err = launch_flat<int16_t>(table, idx, out, n, n_table, clamp, nsm, s);
  } else if (table_type == 2) {
    err = launch_flat<uint16_t>(table, idx, out, n, n_table, clamp, nsm, s);
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
    const int share = ((n_table + kCluster - 1) / kCluster + 3) & ~3;
    const int clusters = (nsm + kCluster - 1) / kCluster;
    // A share is at most 1/8 of the table plus 16 bytes: its barrier
    // always fits behind it, at float `share` (a multiple of 4).
    const int bytes = 4 * share + 8;
    err = allow_smem(gather_flat_cluster, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    gather_flat_cluster<<<clusters * kCluster, kBandThreads, bytes, s>>>(
        table, idx, out, n_table, share, n);
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

extern "C" int slb_gather_smem_u16(const uint16_t* table, const int* idx,
                                   float* out, int n, int n_table, int nsm,
                                   void* stream) {
  const int bytes = n_table * static_cast<int>(sizeof(uint16_t));
  cudaError_t err = allow_smem(gather_smem_u16, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_smem_u16<<<smem_blocks(n, nsm), kSmemThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      table, idx, out, n, n_table);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slb_gather_2d_f32(const float* table, const int* vi,
                                 const int* ui, float* out, int n, int cols,
                                 void* stream) {
  gather_2d<<<flat_blocks(n), kFlatThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(table, vi, ui, out, n,
                                                   cols);
  return static_cast<int>(cudaGetLastError());
}
