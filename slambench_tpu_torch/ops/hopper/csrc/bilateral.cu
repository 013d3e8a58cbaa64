// K1 and K1F: the 5x5 bilateral filter of metre depth from a
// shared-memory tile, alone (K1) and fused with mm2meters (K1F).
//
// Replaces slambench_tpu/ops/pallas/bilateral.py:bilateral_filter_pallas
// (the reference's bilateralFilterKernel, kfusion/src/cpp/kernels.cpp:
// 159-198) and, in K1F, the mm2metersKernel in front of it
// (kernels.cpp:562-589). Two entry points share one device body:
//   * slb_bilateral_f32: metre depth in, filtered depth out (the Pallas
//     contract; tools/mosaic_probe.py uses it);
//   * slb_mm2m_bilateral_f32: the int32 millimetre frame in, read at
//     stride `ratio`; out float_depth = mm / 1000 (IEEE, numpy's bits)
//     and the filtered depth, ceil(in / ratio) per axis. The frame step
//     calls it once a frame, so the metre image is never read back.
//
// Semantics and tap order follow the JAX version:
//   * taps run y offset outer, x offset inner, each accumulating
//     t += f * cur, s += f with f = (g[i] * g[j]) * exp(-mod / e2);
//   * neighbours with depth <= 0 are left out of both sums;
//   * the border is the reference's unsigned-wrap clamp on the OUTPUT
//     grid (before any scaling by ratio): an index below 0 or above
//     size-1 reads size-1, per axis, so a left or top tile's apron holds
//     the far column or row;
//   * depth == 0 outputs 0; otherwise t / s (s == 0 gives NaN, as in JAX).
//
// Design. Each block stages its 8x32 output tile plus a 2-pixel apron
// (12x36 floats) in shared memory, converted to metres once, then each
// thread filters two neighbouring outputs of one row from a 5x6 window
// read as float2 triples (a half-warp reads one 128-byte row: no bank
// conflict). That loads each input once per tile instead of 25 times per
// pixel, amortises the index and clamp arithmetic over two outputs and
// gives the scheduler two independent sums per thread. Two outputs, not
// four: at 240x320 the frame is only 2,400 warps of one output each over
// the card's 528 schedulers, and the larger a warp's share, the more
// uneven the last round (PERF.md has the times of 1, 2 and 4). The tile
// is filled with plain loads, not TMA or cp.async: the uint-wrap clamp
// and the integer-to-metre division happen per element on the way in
// (TMA's out-of-bounds fill is zeros), and the tile is 1.7 KB, one round
// of about four loads per thread.
//
// Range weight: exp(-mod / e2) is computed as exp2f(mod * c2) with
// c2 = -log2(e) / e2 taken once on the host, which replaces the IEEE
// division and the range reduction of expf (the old kernel spent half
// its time in the division). The argument carries about two more
// roundings, a relative error near 2e-7, so a weight that matters
// (argument above -30) moves by under 5e-6 of itself, and the filtered
// depth by under 1e-6 m on the frame path's data: inside K1_TOL (1e-5).
// exp2f is the accurate libdevice version (no --use_fast_math).
//
// Bound: bytes. K1F reads one int32 per output (a 32-byte sector of
// every row it touches at stride 2) and writes two f32 maps; its 25
// exponentials per pixel run on the SFU at a quarter of the f32 rate.

#include <cuda_runtime.h>

namespace {

constexpr int R = 2;                    // filter radius
constexpr int TW = 32;                  // output tile columns
constexpr int TH = 8;                   // output tile rows
constexpr int MX = 2;                   // outputs per thread, along x
constexpr int PW = TW + 2 * R;          // tile pitch
constexpr int PH = TH + 2 * R;
constexpr int THREADS = (TW / MX) * TH;  // 128
constexpr int CELLS = PH * PW;
static_assert(MX == 2 && PW % 2 == 0, "the window is read as float2");

struct Taps {
  float gg[25];                         // f32 products g[j] * g[i], [j][i]
};

__device__ __forceinline__ int uintwrap(int i, int size) {
  return (i < 0 || i > size - 1) ? size - 1 : i;
}

// Output-grid pixel (y, x), in range, as metres.
struct MetreSource {
  const float* in;
  int W;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return __ldg(&in[y * W + x]);
  }
};

struct MillimetreSource {
  const int* in;
  int pitch;                            // input row length
  int ratio;
  __device__ __forceinline__ float operator()(int y, int x) const {
    const int mm = __ldg(&in[(y * ratio) * pitch + x * ratio]);
    return __fdiv_rn(__int2float_rn(mm), 1000.0f);
  }
};

template <class Source, bool kWriteMetres>
__device__ __forceinline__ void filter_tile(Source src,
                                            float* __restrict__ metres,
                                            float* __restrict__ out, int H,
                                            int W, const Taps& taps,
                                            float c2) {
  __shared__ __align__(16) float tile[CELLS];
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.x;
  // Cell (cy, cx) holds output pixel (wrap(y0 + cy - R), wrap(x0 + cx - R)).
#pragma unroll
  for (int k = 0; k < (CELLS + THREADS - 1) / THREADS; ++k) {
    const int c = tid + k * THREADS;
    if (c < CELLS) {
      const int cy = c / PW;
      const int cx = c - cy * PW;
      tile[c] = src(uintwrap(y0 + cy - R, H), uintwrap(x0 + cx - R, W));
    }
  }
  __syncthreads();

  // Outputs (y0 + ty, x0 + tx + k), k < MX; window cells tx .. tx + 5.
  const int ty = tid / (TW / MX);
  const int tx = (tid % (TW / MX)) * MX;
  float centre[MX], t[MX], s[MX];
#pragma unroll
  for (int k = 0; k < MX; ++k) {
    centre[k] = tile[(ty + R) * PW + tx + R + k];
    t[k] = 0.0f;
    s[k] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 2 * R + 1; ++j) {
    const float* row = &tile[(ty + j) * PW + tx];
    const float2 a = *reinterpret_cast<const float2*>(row);
    const float2 b = *reinterpret_cast<const float2*>(row + 2);
    const float2 c = *reinterpret_cast<const float2*>(row + 4);
    const float v[MX + 2 * R] = {a.x, a.y, b.x, b.y, c.x, c.y};
#pragma unroll
    for (int i = 0; i < 2 * R + 1; ++i) {
      const float gg = taps.gg[j * (2 * R + 1) + i];
#pragma unroll
      for (int k = 0; k < MX; ++k) {
        const float cur = v[k + i];
        const float d = cur - centre[k];
        const float factor = gg * exp2f(d * d * c2);
        if (cur > 0.0f) {
          t[k] = t[k] + factor * cur;
          s[k] = s[k] + factor;
        }
      }
    }
  }
  const int y = y0 + ty;
  if (y >= H) return;
#pragma unroll
  for (int k = 0; k < MX; ++k) {
    const int x = x0 + tx + k;
    if (x < W) {
      out[y * W + x] = (centre[k] == 0.0f) ? 0.0f : t[k] / s[k];
      if (kWriteMetres) metres[y * W + x] = centre[k];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
metre_bilateral_kernel(const float* __restrict__ in, float* __restrict__ out,
                       int H, int W, Taps taps, float c2) {
  filter_tile<MetreSource, false>(MetreSource{in, W}, nullptr, out, H, W,
                                  taps, c2);
}

__global__ void __launch_bounds__(THREADS)
mm2m_bilateral_kernel(const int* __restrict__ mm, float* __restrict__ metres,
                      float* __restrict__ out, int pitch, int ratio, int H,
                      int W, Taps taps, float c2) {
  filter_tile<MillimetreSource, true>(MillimetreSource{mm, pitch, ratio},
                                      metres, out, H, W, taps, c2);
}

Taps make_taps(const float* lut5) {
  Taps taps;
  for (int j = 0; j < 5; ++j)
    for (int i = 0; i < 5; ++i) taps.gg[j * 5 + i] = lut5[i] * lut5[j];
  return taps;
}

// c2 = -log2(e) / e2, so that exp(-mod / e2) = exp2(mod * c2).
float range_scale(float e2) {
  return static_cast<float>(-1.4426950408889634 / e2);
}

dim3 grid_for(int H, int W) {
  return dim3((W + TW - 1) / TW, (H + TH - 1) / TH);
}

}  // namespace

extern "C" int slb_bilateral_f32(const float* in, float* out, int H, int W,
                                 const float* lut5, float e2,
                                 void* stream) {
  metre_bilateral_kernel<<<grid_for(H, W), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      in, out, H, W, make_taps(lut5), range_scale(e2));
  return static_cast<int>(cudaGetLastError());
}

// mm: int32 [Hin, Win] millimetres; metres, out: f32 [H, W] with
// H = ceil(Hin / ratio), W = ceil(Win / ratio).
// ev_start / ev_end: CUDA events (or null) recorded on the stream right
// before and after the launch, so that a KERNEL_TIMINGS span holds the
// kernel and not the caller's host work.
extern "C" int slb_mm2m_bilateral_f32(const int* mm, float* metres,
                                      float* out, int Hin, int Win,
                                      int ratio, const float* lut5, float e2,
                                      void* stream, void* ev_start,
                                      void* ev_end) {
  const int H = (Hin + ratio - 1) / ratio;
  const int W = (Win + ratio - 1) / ratio;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Taps taps = make_taps(lut5);
  const float c2 = range_scale(e2);
  if (ev_start) {
    const cudaError_t err =
        cudaEventRecord(static_cast<cudaEvent_t>(ev_start), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mm2m_bilateral_kernel<<<grid_for(H, W), THREADS, 0, s>>>(
      mm, metres, out, Win, ratio, H, W, taps, c2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !ev_end) return static_cast<int>(err);
  return static_cast<int>(
      cudaEventRecord(static_cast<cudaEvent_t>(ev_end), s));
}
