// K1: 5x5 bilateral filter of metre depth, one thread per output pixel.
//
// Replaces slambench_tpu/ops/pallas/bilateral.py:bilateral_filter_pallas
// (the reference's bilateralFilterKernel, kfusion/src/cpp/kernels.cpp:
// 159-198). Semantics, tap order and arithmetic follow the JAX version:
//   * taps run y offset outer, x offset inner, each accumulating
//     t += f * cur, s += f with f = (g[i] * g[j]) * expf(-mod / e2);
//   * neighbours with depth <= 0 are left out of both sums;
//   * the border is the reference's unsigned-wrap clamp: an index below 0
//     or above size-1 reads size-1, per axis;
//   * depth == 0 outputs 0; otherwise t / s (s == 0 gives NaN, as in JAX).
//
// Bound: memory traffic, about 25 four-byte reads per pixel, almost all
// served from L1/L2 because neighbouring threads read overlapping
// windows; the 240x320 frame is 300 KB. The taps go through __ldg (the
// read-only path); a shared-memory tile with an apron is left for later.
// Built without --use_fast_math so expf and the division are IEEE and
// match torch.exp / torch.div.

#include <cuda_runtime.h>

namespace {

struct Lut5 {
  float g[5];
};

__device__ __forceinline__ int uintwrap(int i, int size) {
  return (i < 0 || i > size - 1) ? size - 1 : i;
}

__global__ void bilateral_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, int H, int W,
                                 Lut5 lut, float e2) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const float center = __ldg(&in[y * W + x]);
  float t = 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int j = -2; j <= 2; ++j) {
    const int cy = uintwrap(y + j, H);
#pragma unroll
    for (int i = -2; i <= 2; ++i) {
      const int cx = uintwrap(x + i, W);
      const float cur = __ldg(&in[cy * W + cx]);
      const float d = cur - center;
      const float mod = d * d;
      const float gg = lut.g[i + 2] * lut.g[j + 2];
      const float factor = gg * expf(-mod / e2);
      if (cur > 0.0f) {
        t = t + factor * cur;
        s = s + factor;
      }
    }
  }
  out[y * W + x] = (center == 0.0f) ? 0.0f : t / s;
}

}  // namespace

extern "C" int slb_bilateral_f32(const float* in, float* out, int H, int W,
                                 const float* lut5, float e2,
                                 void* stream) {
  Lut5 lut;
  for (int k = 0; k < 5; ++k) lut.g[k] = lut5[k];
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  bilateral_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, H, W, lut, e2);
  return static_cast<int>(cudaGetLastError());
}
