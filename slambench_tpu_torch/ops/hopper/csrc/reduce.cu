// K2: the ICP normal-equations reduction over per-pixel TrackData.
//
// Replaces slambench_tpu/ops/pallas/reduce.py:reduce_track_pallas (the
// reference's reduceKernel, kfusion/src/cpp/kernels.cpp:251-495). Same
// contract as the Pallas kernel: it takes TrackData {result i32 [n],
// error f32 [n], J f32 [6, n]} and writes the packed 32 floats
//   [err^2, JTe(6), triu(JTJ)(21), n_valid, n_-4, n_-5, n_other]
// where only pixels with result >= 1 enter the Gram terms and n_other
// counts -4 < result < 1.
//
// Stage 1: a grid-stride loop, one pixel per thread per step; each thread
// keeps the 32 running sums in registers. A bounds check replaces the
// Pallas kernel's -6 padding. Warps reduce with __shfl_down_sync, then
// warp 0 sums the block's warps from shared memory and the block writes
// one [32] partial to a [nblocks, 32] scratch.
// Stage 2: one block of 32 threads sums the partials, each lane one
// output slot, in block order. The sum order is fixed: the result is
// deterministic run to run (no atomics).
//
// Bound: latency and launch overhead. At the pyramid's 76,800 / 19,200 /
// 4,800 pixels the kernel reads 32 bytes per pixel (2.5 MB at most) and
// does ~60 flops per pixel; two launches of a few microseconds each
// dominate. Fusing `track` into stage 1 is a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kOut = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
reduce_stage1(const int* __restrict__ result, const float* __restrict__ error,
              const float* __restrict__ J, float* __restrict__ partials,
              int n) {
  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0f;

  const int stride = gridDim.x * blockDim.x;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    const int r = __ldg(&result[p]);
    if (r >= 1) {
      const float e = __ldg(&error[p]);
      float j[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) j[c] = __ldg(&J[c * n + p]);
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
    } else if (r == -4) {
      acc[29] += 1.0f;
    } else if (r == -5) {
      acc[30] += 1.0f;
    } else if (r > -4) {
      acc[31] += 1.0f;
    }
  }

#pragma unroll
  for (int k = 0; k < kOut; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
  }

  __shared__ float warp_sums[kWarps][kOut];
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
}

__global__ void reduce_stage2(const float* __restrict__ partials,
                              float* __restrict__ out, int nblocks) {
  const int k = threadIdx.x;
  float v = 0.0f;
  for (int b = 0; b < nblocks; ++b) v += partials[b * kOut + k];
  out[k] = v;
}

}  // namespace

extern "C" int slb_reduce_track_f32(const int* result, const float* error,
                                    const float* J, float* partials,
                                    float* out, int n, int nblocks,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  reduce_stage1<<<nblocks, kThreads, 0, s>>>(result, error, J, partials, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_stage2<<<1, kOut, 0, s>>>(partials, out, nblocks);
  return static_cast<int>(cudaGetLastError());
}
