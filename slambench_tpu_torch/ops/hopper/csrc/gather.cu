// G1-G4: table gathers, the Hopper counterparts of the three Pallas
// gather probes in slambench_tpu/tools/mosaic_probe.py (P1
// probe_mosaic_gathers.try_kernel.run, P2 probe_mosaic_wide_gather.
// run_wide, P3 probe_mosaic_wide_gather.run_adv).
//
// On the TPU those kernels asked whether Mosaic could lower a gather from
// a VMEM-resident table at all. On Hopper every thread can load from any
// address, so the question becomes how fast the card serves a gather, and
// from which memory: device memory through L2 and the read-only path
// (G1, G4) or a table staged whole into shared memory (G2, G3).
//
// Bound: bytes. A lookup moves a 4-byte index in and a 4-byte value out
// and does no arithmetic (G3 one division), so the least time is
// (index + output + table once) / 3.35 TB/s. Random lookups touch a new
// 32-byte sector per table read; while the table fits the 50 MB L2 those
// reads stay on chip and only the index and output streams reach HBM.
// Indices and outputs are read and written coalesced, one lookup per
// thread (G1, G4) or per step of a grid-stride loop (G2, G3).
//
// Contracts (the plain twins in ops/hopper/gather.py are the reference):
//   * G1 gather_flat: out[i] = float(table[idx[i]]), table f32, int16 or
//     uint16 (the integer types widen exactly). clamp != 0 clamps idx to
//     [0, n_table - 1] as JAX's mode="clip"; otherwise idx must be in
//     range, as mode="promise_in_bounds".
//   * G2 gather_axis_smem: the whole f32 [rows, cols] table in dynamic
//     shared memory (at most 232,448 bytes), then mode 0 flat
//     (take(t.ravel(), i)), 1 lane (take_along_axis(t, i, axis=1)) or 2
//     sublane (take_along_axis(t, i, axis=0)).
//   * G3 gather_smem_u16: the uint16 millimetre image in shared memory
//     (240x320 = 153,600 bytes; the f32 image, 307,200 bytes, does not
//     fit), each lookup converted as mm2meters does: float(mm) / 1000.0f.
//     Built without --use_fast_math, so the division is IEEE and the
//     result equals G1 on the f32 metre image bit for bit.
//   * G4 gather_2d: out[i] = table[vi[i] * cols + ui[i]], f32, in range.
// G2 and G3 clamp every index into the staged table, so a bad index reads
// a wrong value instead of faulting; in-range indices are exact.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFlatThreads = 256;
constexpr int kSmemThreads = 1024;
// Lookups per thread that a staged block should serve before another
// block (and another copy of the table) is worth its staging cost.
constexpr int kLookupsPerThread = 8;
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
gather_flat(const T* __restrict__ table, const int* __restrict__ idx,
            float* __restrict__ out, int n, int n_table, int clamp) {
  const int p = blockIdx.x * kFlatThreads + threadIdx.x;
  if (p >= n) return;
  int j = __ldg(&idx[p]);
  if (clamp) j = clampi(j, n_table - 1);
  out[p] = static_cast<float>(__ldg(&table[j]));
}

__global__ void __launch_bounds__(kSmemThreads)
gather_axis_smem(const float* __restrict__ table, const int* __restrict__ idx,
                 float* __restrict__ out, int rows, int cols, int irows,
                 int icols, int mode) {
  extern __shared__ float tab[];
  const int n_table = rows * cols;
  for (int k = threadIdx.x; k < n_table; k += kSmemThreads)
    tab[k] = __ldg(&table[k]);
  __syncthreads();
  const int n = irows * icols;
  for (int p = blockIdx.x * kSmemThreads + threadIdx.x; p < n;
       p += gridDim.x * kSmemThreads) {
    const int j = __ldg(&idx[p]);
    const int r = p / icols;
    const int c = p - r * icols;
    int off;
    if (mode == 0) {
      off = clampi(j, n_table - 1);
    } else if (mode == 1) {
      off = r * cols + clampi(j, cols - 1);
    } else {
      off = clampi(j, rows - 1) * cols + c;
    }
    out[p] = tab[off];
  }
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
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// table_type: 0 float32, 1 int16, 2 uint16.
extern "C" int slb_gather_flat(const void* table, int table_type,
                               const int* idx, float* out, int n, int n_table,
                               int clamp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = flat_blocks(n);
  if (table_type == 0) {
    gather_flat<float><<<blocks, kFlatThreads, 0, s>>>(
        static_cast<const float*>(table), idx, out, n, n_table, clamp);
  } else if (table_type == 1) {
    gather_flat<int16_t><<<blocks, kFlatThreads, 0, s>>>(
        static_cast<const int16_t*>(table), idx, out, n, n_table, clamp);
  } else if (table_type == 2) {
    gather_flat<uint16_t><<<blocks, kFlatThreads, 0, s>>>(
        static_cast<const uint16_t*>(table), idx, out, n, n_table, clamp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slb_gather_axis_smem_f32(const float* table, const int* idx,
                                        float* out, int rows, int cols,
                                        int irows, int icols, int mode,
                                        int nsm, void* stream) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = rows * cols * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem(gather_axis_smem, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_axis_smem<<<smem_blocks(irows * icols, nsm), kSmemThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      table, idx, out, rows, cols, irows, icols, mode);
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
