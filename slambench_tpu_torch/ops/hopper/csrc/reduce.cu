// K2: the ICP normal-equations reduction, as two entry points that share
// one accumulate, block-reduce and finish path.
//
// Replaces slambench_tpu/ops/pallas/reduce.py:reduce_track_pallas (the
// reference's reduceKernel, kfusion/src/cpp/kernels.cpp:251-495) and, in
// the fused entry, the `track` step in front of it
// (slambench_tpu/ops/track.py:track_and_reduce). Both write the packed 32
// floats
//   [err^2, JTe(6), triu(JTJ)(21), n_valid, n_-4, n_-5, n_other]
// where only pixels with result >= 1 enter the Gram terms and n_other
// counts -4 < result < 1.
//
// slb_reduce_track_f32: the Pallas kernel's contract, TrackData {result
//   i32 [n], error f32 [n], J f32 [6, n]} in. A bounds check replaces the
//   Pallas kernel's -6 padding.
// slb_track_reduce_f32: the fused ICP data term. Each thread runs the whole
//   of ops/track.py:track for its pixel (transform, project, bounds test,
//   gather of the six reference channels, the result-code chain, error and
//   J) and adds the pixel straight into its 32 register sums. Error and J
//   never reach device memory; only the result code is written. A -1 or -2
//   pixel reads no reference map and forms no error or J (it reads its six
//   level-map values, as every pixel does). pose and view are device
//   pointers, loaded into shared memory once per block: the caller reads
//   nothing back to the host.
//
// One launch each. A grid-stride loop keeps 32 sums per thread; warps
// reduce with shuffles, the block through shared memory, and the block
// writes its [32] partial. Each block then fences and takes a ticket; the
// last block to arrive sums every partial in block order (warp w over
// blocks w, w + 8, ..., then warp 0 over the 8 warp sums), writes `out`
// and resets the ticket to 0 for the next launch on the stream. The order
// depends only on the grid, which the wrapper sizes from the pixel count,
// so two calls give the same bits.
//
// Track arithmetic: the plain twin is eager PyTorch, which rounds every
// multiply and add, while nvcc contracts a*b + c into an FMA by default.
// So the track step is written with __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn in the order of slambench_tpu_torch/geometry.py
// (transform row by row, left to right; dot3 as (a0*b0 + a1*b1) + a2*b2)
// and the pixel cast with __float2int_rz (.to(torch.int32) truncates), so
// every result code equals the twin's. The Gram sums may use FMA: their
// order differs from the twin's matmul anyway.
//
// Bound: bytes and launches, not operations. A tracked pixel moves 52
// bytes through the fused kernel (24 of level maps, 24 of gathered
// reference channels, 4 of result code), 128 bytes go out: at 240x320 at
// most 4.0 MB, 1.19 us at 3.35 TB/s; its ~150 f32 operations a pixel take
// 0.17 us at 67 TFLOP/s. The unfused kernel moves 32 bytes a pixel. The
// Gram product is 28 products a pixel into 32 sums in full f32 (TF32 is
// off in the port), so tensor cores are not the lever. What costs is the
// launch (~2.5 us) and the latency of the chain pose -> projection ->
// gather; the wrapper's grid gives about one pixel per thread at 240x320
// (300 blocks of 256) to keep enough gathers in flight.
//
// Threads a block: both entries are instantiated for 128, 256, 512 and
// 1024 threads and take the count as an argument (the work-group size
// that the reference's OCLWrapper tunes, thirdparty/OCLWrapper.cpp:
// 77-132; the port's stand-in for JAX's SLAMBENCH_TILE_ROWS). 256 is the
// default and the kernel of earlier versions; another count changes the
// grid and with it the order of the sums.

#include <cuda_runtime.h>

namespace {

constexpr int kOut = 32;
constexpr float kInvalid = -2.0f;  // params.INVALID

// One tracked pixel's row [e, J0..J5] into the sums.
__device__ __forceinline__ void add_row(float (&acc)[kOut], float e,
                                        const float (&j)[6]) {
  acc[0] += e * e;
#pragma unroll
  for (int c = 0; c < 6; ++c) acc[1 + c] += e * j[c];
  int k = 7;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) acc[k++] += j[a] * j[b];
  }
  acc[28] += 1.0f;
}

// A pixel that does not enter the Gram terms (result < 1).
__device__ __forceinline__ void add_rejected(float (&acc)[kOut], int r) {
  if (r == -4) {
    acc[29] += 1.0f;
  } else if (r == -5) {
    acc[30] += 1.0f;
  } else if (r > -4) {
    acc[31] += 1.0f;
  }
}

// Sums `acc` over the block of kThreads and writes the block's partial;
// the last block to arrive sums all partials in block order into `out`.
template <int kThreads>
__device__ __forceinline__ void block_finish(float (&acc)[kOut],
                                             float* __restrict__ partials,
                                             unsigned int* ticket,
                                             float* __restrict__ out) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float warp_sums[kWarps][kOut];
  __shared__ bool is_last;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kOut; ++k) warp_sums[warp][k] = acc[k];
  }
  __syncthreads();
  if (warp == 0) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += warp_sums[w][lane];
    partials[blockIdx.x * kOut + lane] = v;
  }
  // The barrier orders warp 0's stores before thread 0's fence, which
  // makes them visible device-wide before the ticket (the pattern of
  // cooperative groups' grid sync); the last block fences again before
  // it reads the other blocks' partials.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (is_last) __threadfence();
  }
  __syncthreads();
  if (!is_last) return;

  float v = 0.0f;
  for (int b = warp; b < static_cast<int>(gridDim.x); b += kWarps)
    v += __ldcg(&partials[b * kOut + lane]);
  warp_sums[warp][lane] = v;
  __syncthreads();
  if (warp == 0) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][lane];
    out[lane] = s;
    if (lane == 0) *ticket = 0u;
  }
}

template <int kThreads, class Pixel>
__device__ __forceinline__ void reduce_pixels(const Pixel& pixel, int n,
                                              float* partials,
                                              unsigned int* ticket,
                                              float* out) {
  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0f;
  const int stride = gridDim.x * blockDim.x;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride)
    pixel(p, acc);
  block_finish<kThreads>(acc, partials, ticket, out);
}

// ------------------------- unfused: TrackData in ------------------------ //

struct TrackDataPixel {
  const int* __restrict__ result;
  const float* __restrict__ error;
  const float* __restrict__ J;
  int n;

  __device__ __forceinline__ void operator()(int p,
                                             float (&acc)[kOut]) const {
    // All eight loads issued together: one round trip per pixel.
    const int r = __ldg(&result[p]);
    const float e = __ldg(&error[p]);
    float j[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) j[c] = __ldg(&J[c * n + p]);
    if (r >= 1) {
      add_row(acc, e, j);
    } else {
      add_rejected(acc, r);
    }
  }
};

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
reduce_track_kernel(TrackDataPixel src, float* partials,
                    unsigned int* ticket, float* out) {
  reduce_pixels<kThreads>(src, src.n, partials, ticket, out);
}

// ----------------------- fused: track, then reduce ---------------------- //

// (a0*b0 + a1*b1) + a2*b2, each step rounded (geometry.dot3).
__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// Row `m` of a Matrix4's linear part on (x, y, z) (geometry.rotate).
__device__ __forceinline__ float linear_row(const float* m, float x, float y,
                                            float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m[0], x), __fmul_rn(m[1], y)),
                   __fmul_rn(m[2], z));
}

// The same row plus its translation (geometry.transform).
__device__ __forceinline__ float affine_row(const float* m, float x, float y,
                                            float z) {
  return __fadd_rn(linear_row(m, x, y, z), m[3]);
}

struct TrackPixel {
  const float* __restrict__ in_vertex;   // [3, n]
  const float* __restrict__ in_normal;   // [3, n]
  const float* __restrict__ ref_vertex;  // [3, H * W]
  const float* __restrict__ ref_normal;  // [3, H * W]
  int* __restrict__ result;              // [n]
  const float* pose;                     // [16] in shared memory
  const float* view;                     // [16] in shared memory
  int n, H, W;
  float dist_threshold, normal_threshold;

  // The result code of ops/track.py:track, its conditions tested in the
  // priority order of the twin's chain; a tracked pixel also adds its row.
  // The six level-map values are loaded together, and the six reference
  // channels together, so a pixel waits on two rounds of loads.
  __device__ __forceinline__ int code(int p, float (&acc)[kOut]) const {
    const float n0 = __ldg(&in_normal[p]);
    const float n1 = __ldg(&in_normal[n + p]);
    const float n2 = __ldg(&in_normal[2 * n + p]);
    const float vx = __ldg(&in_vertex[p]);
    const float vy = __ldg(&in_vertex[n + p]);
    const float vz = __ldg(&in_vertex[2 * n + p]);
    if (n0 == kInvalid) return -1;
    const float pv0 = affine_row(pose, vx, vy, vz);
    const float pv1 = affine_row(pose + 4, vx, vy, vz);
    const float pv2 = affine_row(pose + 8, vx, vy, vz);
    const float pp0 = affine_row(view, pv0, pv1, pv2);
    const float pp1 = affine_row(view + 4, pv0, pv1, pv2);
    const float pp2 = affine_row(view + 8, pv0, pv1, pv2);
    const float px = __fadd_rn(__fdiv_rn(pp0, pp2), 0.5f);
    const float py = __fadd_rn(__fdiv_rn(pp1, pp2), 0.5f);
    // NaN fails every comparison and +-inf one of them: the twin's
    // isfinite terms add nothing here.
    if (!(px >= 0.0f && px <= static_cast<float>(W - 1) && py >= 0.0f &&
          py <= static_cast<float>(H - 1)))
      return -2;
    const int hw = H * W;
    const int flat = __float2int_rz(py) * W + __float2int_rz(px);
    const float rn0 = __ldg(&ref_normal[flat]);
    const float rn1 = __ldg(&ref_normal[hw + flat]);
    const float rn2 = __ldg(&ref_normal[2 * hw + flat]);
    const float rv0 = __ldg(&ref_vertex[flat]);
    const float rv1 = __ldg(&ref_vertex[hw + flat]);
    const float rv2 = __ldg(&ref_vertex[2 * hw + flat]);
    if (rn0 == kInvalid) return -3;
    const float d0 = __fsub_rn(rv0, pv0);
    const float d1 = __fsub_rn(rv1, pv1);
    const float d2 = __fsub_rn(rv2, pv2);
    if (__fsqrt_rn(dot3(d0, d1, d2, d0, d1, d2)) > dist_threshold) return -4;
    const float pn0 = linear_row(pose, n0, n1, n2);
    const float pn1 = linear_row(pose + 4, n0, n1, n2);
    const float pn2 = linear_row(pose + 8, n0, n1, n2);
    if (dot3(pn0, pn1, pn2, rn0, rn1, rn2) < normal_threshold) return -5;
    // error = dot3(ref_n, diff); J = [ref_n, cross3(proj_vertex, ref_n)].
    const float j[6] = {
        rn0, rn1, rn2,
        __fsub_rn(__fmul_rn(pv1, rn2), __fmul_rn(pv2, rn1)),
        __fsub_rn(__fmul_rn(pv2, rn0), __fmul_rn(pv0, rn2)),
        __fsub_rn(__fmul_rn(pv0, rn1), __fmul_rn(pv1, rn0))};
    add_row(acc, dot3(rn0, rn1, rn2, d0, d1, d2), j);
    return 1;
  }

  __device__ __forceinline__ void operator()(int p,
                                             float (&acc)[kOut]) const {
    const int r = code(p, acc);
    if (r < 1) add_rejected(acc, r);
    result[p] = r;
  }
};

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
track_reduce_kernel(TrackPixel src, const float* __restrict__ pose,
                    const float* __restrict__ view, float* partials,
                    unsigned int* ticket, float* out) {
  __shared__ float mats[32];
  if (threadIdx.x < 16) {
    mats[threadIdx.x] = pose[threadIdx.x];
  } else if (threadIdx.x < 32) {
    mats[threadIdx.x] = view[threadIdx.x - 16];
  }
  __syncthreads();
  TrackPixel px = src;
  px.pose = mats;
  px.view = mats + 16;
  reduce_pixels<kThreads>(px, px.n, partials, ticket, out);
}

// Launches `kernel<threads>` for threads in {128, 256, 512, 1024}; false
// for any other count.
template <template <int> class Launch, class... Args>
bool launch_threads(int threads, Args... args) {
  switch (threads) {
    case 128: Launch<128>::run(args...); return true;
    case 256: Launch<256>::run(args...); return true;
    case 512: Launch<512>::run(args...); return true;
    case 1024: Launch<1024>::run(args...); return true;
    default: return false;
  }
}

template <int kThreads>
struct LaunchReduce {
  static void run(int nblocks, cudaStream_t s, TrackDataPixel src,
                  float* partials, unsigned int* ticket, float* out) {
    reduce_track_kernel<kThreads><<<nblocks, kThreads, 0, s>>>(
        src, partials, ticket, out);
  }
};

template <int kThreads>
struct LaunchTrackReduce {
  static void run(int nblocks, cudaStream_t s, TrackPixel src,
                  const float* pose, const float* view, float* partials,
                  unsigned int* ticket, float* out) {
    track_reduce_kernel<kThreads><<<nblocks, kThreads, 0, s>>>(
        src, pose, view, partials, ticket, out);
  }
};

}  // namespace

// `partials` holds at least nblocks x 32 floats and `ticket` is 0 before
// the launch (the kernel leaves it 0); nblocks is 1..max_blocks, the
// partials' capacity; threads is 128, 256, 512 or 1024.
extern "C" int slb_reduce_track_f32(const int* result, const float* error,
                                    const float* J, float* partials,
                                    unsigned int* ticket, float* out, int n,
                                    int nblocks, int max_blocks, int threads,
                                    void* stream) {
  if (n < 0 || nblocks < 1 || nblocks > max_blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  TrackDataPixel src{result, error, J, n};
  if (!launch_threads<LaunchReduce>(threads, nblocks,
                                    static_cast<cudaStream_t>(stream), src,
                                    partials, ticket, out))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// ev_start / ev_end: CUDA events (or null) recorded on the stream right
// before and after the launch, so that a KERNEL_TIMINGS span holds the
// kernel and not the caller's host work.
extern "C" int slb_track_reduce_f32(
    const float* in_vertex, const float* in_normal, const float* ref_vertex,
    const float* ref_normal, const float* pose, const float* view,
    int* result, float* partials, unsigned int* ticket, float* out, int n,
    int H, int W, float dist_threshold, float normal_threshold, int nblocks,
    int max_blocks, int threads, void* stream, void* ev_start,
    void* ev_end) {
  if (n < 0 || H < 1 || W < 1 || nblocks < 1 || nblocks > max_blocks ||
      (threads != 128 && threads != 256 && threads != 512 &&
       threads != 1024))
    return static_cast<int>(cudaErrorInvalidValue);
  TrackPixel src{in_vertex, in_normal, ref_vertex, ref_normal, result,
                 nullptr, nullptr, n, H, W, dist_threshold,
                 normal_threshold};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ev_start) {
    const cudaError_t err =
        cudaEventRecord(static_cast<cudaEvent_t>(ev_start), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  launch_threads<LaunchTrackReduce>(threads, nblocks, s, src, pose, view,
                                    partials, ticket, out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !ev_end) return static_cast<int>(err);
  return static_cast<int>(
      cudaEventRecord(static_cast<cudaEvent_t>(ev_end), s));
}
