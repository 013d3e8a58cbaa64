// Variants of G3 and G4 that lost to the shipped kernels, kept so that
// tools/gather_sweep.py can time them again. This file is not built
// alone: the sweep appends it to a copy of ops/hopper/csrc/gather.cu, whose
// helpers (serve, stage_rows, the mbarrier and DSMEM accessors, ...) it
// uses. Each variant is checked against the plain twin bit for bit.
//
//   * slb_sweep_g3: G3 on `blocks` blocks (0: one an SM), in clusters of
//     `cluster` that share the stage's L2 traffic by TMA multicast: block r
//     of a cluster copies the r-th 1/cluster of the table into every block
//     of the cluster (cp.async.bulk ... .multicast::cluster). cluster 1
//     launches the shipped kernel on that grid.
//   * slb_sweep_cluster: G4 (ui given) or G2 flat (ui null) with the
//     table split over a cluster of `cluster` blocks, each block staging
//     1/cluster of it by TMA and a lookup reading its owner's share
//     through distributed shared memory (G2 flat's design; the design G4
//     was first built as). With `local_only`, every block of the cluster
//     walks all of the cluster's lookups and serves only those in its own
//     share: no read is remote and no cluster barrier is needed, at the
//     cost of reading each index once a block (the index streams must
//     start on 16 bytes).

namespace {

constexpr int kMaxCluster = 8;     // the portable cluster size

// One TMA bulk copy into every block of the cluster that `mask` names, at
// the same offset, completing on each block's barrier at bar's offset.
__device__ __forceinline__ void bulk_copy_multicast(void* dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// G3 with its stage shared across the cluster. The blocks first meet at a
// cluster barrier, so that no copy lands on a barrier not yet initialised;
// each block's barrier expects the whole 16-byte multiple, so a block
// leaves its wait only once every copy into it has landed.
__global__ void __launch_bounds__(kStageThreads)
g3_multicast(const uint16_t* __restrict__ table, const int* __restrict__ idx,
             float* __restrict__ out, int n, int n_table, int bar_at) {
  extern __shared__ __align__(16) float stage[];
  uint16_t* mm = reinterpret_cast<uint16_t*>(stage);
  uint64_t* bar = stage_barrier(stage, bar_at);
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int bulk = aligned16(table) ? (n_table * 2) & ~15 : 0;   // bytes
  const uint32_t b = smem_u32(bar);
  if (threadIdx.x == 0) mbar_init(b, blockDim.x + 1, bulk);
  cluster.sync();
  if (threadIdx.x == 0 && bulk > 0) {
    const int slice = (bulk / 16 + c - 1) / c * 16;
    const int lo = min(static_cast<int>(cluster.block_rank()) * slice, bulk);
    const int len = min(slice, bulk - lo);
    if (len > 0)
      bulk_copy_multicast(mm + lo / 2, table + lo / 2, len, b,
                          static_cast<uint16_t>((1 << c) - 1));
  }
  for (int e = bulk / 2 + threadIdx.x; e < n_table; e += blockDim.x)
    mm[e] = __ldg(table + e);
  mbar_arrive(b);
  serve(FlatIdx<false, kFill>{idx, n_table}, out, static_cast<unsigned>(n),
        spread_rank(), gridDim.x * kStageThreads,
        [&](int j, unsigned) {
          return or_nan(j, static_cast<float>(mm[j < 0 ? 0 : j]) / 1000.0f);
        },
        [&] { wait_stage(bar); });
}

// A grid of clusters of `cluster` blocks (1..kMaxCluster), enough for
// `blocks` blocks rounded up to whole clusters, but no more clusters than
// the card holds at once.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int cluster,
                            int blocks, int threads, int bytes,
                            cudaStream_t s, Args... args) {
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = (blocks + cluster - 1) / cluster;
  clusters = clusters < 1 ? 1 : clusters;
  cfg.gridDim = dim3(clusters * cluster);
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess || fit < 1) {
    cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
  }
  cfg.gridDim = dim3((clusters < fit ? clusters : fit) * cluster);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// G2 flat or G4 over a cluster: rank r stages table[r * share, (r + 1) *
// share).
template <typename Src, bool kLocalOnly>
__global__ void __launch_bounds__(kBandThreads)
cluster_gather(const float* __restrict__ table, Src src,
               float* __restrict__ out, int n_table, int share, int n) {
  extern __shared__ __align__(16) float stage[];
  uint64_t* bar = stage_barrier(stage, share);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lo = min(rank * share, n_table);
  stage_rows(stage, table + lo, 1, min(share, n_table - lo), 0, bar);
  if constexpr (!kLocalOnly) {
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
    cluster_sync_thread();    // no share leaves while a peer reads it
    return;
  }
  const unsigned per = cluster.num_blocks();
  const unsigned tid = spread_rank(per);
  const unsigned nthreads = gridDim.x / per * kBandThreads;
  const unsigned groups = static_cast<unsigned>(n) / kLookups;
  auto serve_own = [&](int j, unsigned p) {
    const int q = j < 0 ? 0 : j;
    if (q / share == rank)
      __stcs(out + p, or_nan(j, stage[q - rank * share]));
  };
  wait_stage(bar);
  for (unsigned g = tid; g < groups; g += nthreads) {
    Raw r[kLookups];
    src.group(r, g * kLookups);
#pragma unroll
    for (int k = 0; k < kLookups; ++k)
      serve_own(src.at(r[k]), g * kLookups + k);
  }
  for (unsigned p = groups * kLookups + tid; p < static_cast<unsigned>(n);
       p += nthreads)
    serve_own(src.at(src.one(p)), p);
}

template <typename Src>
cudaError_t launch_cluster_gather(const float* table, Src src, float* out,
                                  int n_table, int n, int cluster,
                                  int local_only, int nsm, cudaStream_t s) {
  const int share = ((n_table + cluster - 1) / cluster + 3) & ~3;
  const int bytes = 4 * share + 8;
  const int blocks = (nsm + cluster - 1) / cluster * cluster;
  return local_only
             ? launch_clusters(cluster_gather<Src, true>, cluster, blocks,
                               kBandThreads, bytes, s, table, src, out,
                               n_table, share, n)
             : launch_clusters(cluster_gather<Src, false>, cluster, blocks,
                               kBandThreads, bytes, s, table, src, out,
                               n_table, share, n);
}

}  // namespace

extern "C" int slb_sweep_g3(const uint16_t* table, const int* idx,
                            float* out, int n, int n_table, int cluster,
                            int blocks, int nsm, void* stream) {
  if (nsm < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bar_at;
  const int bytes = stage_bytes((n_table + 1) / 2, &bar_at);
  if (bar_at < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid =
      stage_blocks(n, blocks > 0 && blocks < nsm ? blocks : nsm);
  if (cluster != 1)
    return static_cast<int>(launch_clusters(
        g3_multicast, cluster, grid, kStageThreads, bytes, s, table, idx,
        out, n, n_table, bar_at));
  const cudaError_t err = allow_smem(gather_smem_u16, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_smem_u16<<<grid, kStageThreads, bytes, s>>>(table, idx, out, n,
                                                     n_table, bar_at);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slb_sweep_cluster(const float* table, const int* vi,
                                 const int* ui, float* out, int n, int rows,
                                 int cols, int cluster, int local_only,
                                 int nsm, void* stream) {
  auto on16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  if (rows < 1 || cols < 1 || nsm < 1 ||
      (local_only && !(on16(vi) && (ui == nullptr || on16(ui)))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_table = rows * cols;
  return static_cast<int>(
      ui == nullptr
          ? launch_cluster_gather(table, FlatIdx<true, kFill>{vi, n_table},
                                  out, n_table, n, cluster, local_only, nsm,
                                  s)
          : launch_cluster_gather(table, Idx2d{vi, ui, rows, cols}, out,
                                  n_table, n, cluster, local_only, nsm, s));
}
