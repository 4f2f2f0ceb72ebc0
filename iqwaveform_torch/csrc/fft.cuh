// Shared device code of the port's kernels: complex arithmetic and an
// in-place radix-2 FFT in shared memory.
//
// Each kernel computes its DFT in its own body, as the TPU kernels it
// replaces do (they run the DFT as matmuls against constant planes). The
// FFT here is the plain iterative radix-2 decimation-in-time form: input in
// bit-reversed order, output in natural order, one __syncthreads per
// stage. Twiddles come from a float32 table rounded from float64 on the
// host, so the transform's error is that of float32 butterflies alone.
#pragma once

#include <cuda_runtime.h>

namespace iqt {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// index j with its low log2n bits reversed
__device__ __forceinline__ int bitrev(int j, int log2n) {
  return static_cast<int>(__brev(static_cast<unsigned>(j)) >> (32 - log2n));
}

// In-place FFT of n = 2^log2n points in shared memory `a`, which holds the
// input in bit-reversed order; leaves the output in natural order. `tw` is
// exp(-2 pi i k / n) for k < n/2. inverse=true conjugates the twiddles
// (no 1/n scaling). Synchronizes the block on entry and after each stage.
__device__ inline void fft_radix2(float2* a, const float2* __restrict__ tw,
                                  int log2n, bool inverse) {
  const int nb = 1 << (log2n - 1);  // butterflies per stage
  __syncthreads();
  for (int s = 0; s < log2n; ++s) {
    const int half = 1 << s;
    const int tshift = log2n - 1 - s;  // twiddle stride n / (2 half)
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      const int k = b & (half - 1);
      const int i = ((b >> s) << (s + 1)) + k;
      const int j = i + half;
      float2 w = __ldg(&tw[k << tshift]);
      if (inverse) w.y = -w.y;
      const float2 u = a[i];
      const float2 v = cmul(a[j], w);
      a[i] = make_float2(u.x + v.x, u.y + v.y);
      a[j] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }
}

// opt a kernel into `bytes` of dynamic shared memory (needed above 48 KiB)
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace iqt
