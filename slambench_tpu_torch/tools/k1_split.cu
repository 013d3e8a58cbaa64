// Variants of the one-thread-per-pixel bilateral kernel that K1 was until
// its tiled redesign (csrc/bilateral.cu), for tools/k1_split.py: each
// drops part of the work, so that their times split the kernel's.
//   mode 0: an empty kernel on the same grid (launch and block schedule);
//   mode 1: the 25 clamped __ldg loads per pixel and the masked sums;
//   mode 2: mode 1 plus the range weight expf(mod * -1/e2);
//   mode 3: the kernel as it was: mode 2 with the IEEE division -mod/e2.

#include <cuda_runtime.h>

namespace {

struct Lut5 {
  float g[5];
};

__device__ __forceinline__ int uintwrap(int i, int size) {
  return (i < 0 || i > size - 1) ? size - 1 : i;
}

template <int kMode>
__global__ void split_kernel(const float* __restrict__ in,
                             float* __restrict__ out, int H, int W, Lut5 lut,
                             float e2, float neg_inv_e2) {
  if (kMode == 0) return;
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
      float factor = 1.0f;
      if (kMode == 2) factor = lut.g[i + 2] * lut.g[j + 2] *
                               expf(mod * neg_inv_e2);
      if (kMode == 3) factor = lut.g[i + 2] * lut.g[j + 2] *
                               expf(-mod / e2);
      if (cur > 0.0f) {
        t = t + factor * cur;
        s = s + factor;
      }
    }
  }
  out[y * W + x] = (center == 0.0f) ? 0.0f : t / s;
}

}  // namespace

extern "C" int slb_k1_split(int mode, const float* in, float* out, int H,
                            int W, const float* lut5, float e2,
                            void* stream) {
  Lut5 lut;
  for (int k = 0; k < 5; ++k) lut.g[k] = lut5[k];
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float neg_inv_e2 = -1.0f / e2;
  switch (mode) {
    case 0: split_kernel<0><<<grid, block, 0, st>>>(in, out, H, W, lut, e2,
                                                    neg_inv_e2); break;
    case 1: split_kernel<1><<<grid, block, 0, st>>>(in, out, H, W, lut, e2,
                                                    neg_inv_e2); break;
    case 2: split_kernel<2><<<grid, block, 0, st>>>(in, out, H, W, lut, e2,
                                                    neg_inv_e2); break;
    case 3: split_kernel<3><<<grid, block, 0, st>>>(in, out, H, W, lut, e2,
                                                    neg_inv_e2); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
