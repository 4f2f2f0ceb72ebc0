// Shared device code of the port's kernels: complex arithmetic, an in-place
// radix-2 FFT in shared memory, and an in-place mixed-radix (2, 3, 4, 5, 7)
// one for sizes 2^a 3^b 5^c 7^d.
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

// ---- mixed-radix (2, 3, 4, 5, 7) in-place FFT ---------------------------
//
// n = r_0 r_1 ... r_{S-1}. The input sits in shared memory in the plan's
// digit-reversed order (the host's permutation table: input sample i goes
// to position d_0 + r_0 (d_1 + r_1 (d_2 + ...)), where d_{S-1} = i mod
// r_{S-1}, d_{S-2} = (i / r_{S-1}) mod r_{S-2}, ...). Stage s combines r_s
// neighbouring sub-transforms of length m = r_0 ... r_{s-1} into one of
// length L = r_s m: each butterfly reads and writes the same r_s positions,
// so the transform stays in place with one barrier per stage. `tw` is
// exp(-2 pi i t / n) for t < n. The output is in natural order.

// the plan of one size: S stages, radix of stage s in bits [3s, 3s + 3)
struct FftPlan {
  int n;
  int stages;
  int code;
};

template <int R>
__device__ __forceinline__ void dft_small(float2* v, bool inverse);

template <>
__device__ __forceinline__ void dft_small<2>(float2* v, bool) {
  const float2 a = v[0], b = v[1];
  v[0] = make_float2(a.x + b.x, a.y + b.y);
  v[1] = make_float2(a.x - b.x, a.y - b.y);
}

// -i z (forward) or +i z (inverse)
__device__ __forceinline__ float2 rot90(float2 z, bool inverse) {
  return inverse ? make_float2(-z.y, z.x) : make_float2(z.y, -z.x);
}

template <>
__device__ __forceinline__ void dft_small<4>(float2* v, bool inverse) {
  const float2 t0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
  const float2 t1 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
  const float2 t2 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
  const float2 t3 = rot90(make_float2(v[1].x - v[3].x, v[1].y - v[3].y), inverse);
  v[0] = make_float2(t0.x + t2.x, t0.y + t2.y);
  v[2] = make_float2(t0.x - t2.x, t0.y - t2.y);
  v[1] = make_float2(t1.x + t3.x, t1.y + t3.y);
  v[3] = make_float2(t1.x - t3.x, t1.y - t3.y);
}

template <>
__device__ __forceinline__ void dft_small<3>(float2* v, bool inverse) {
  constexpr float c = -0.5f;
  constexpr float s = 0.86602540378443864676f;  // sin(2 pi / 3)
  const float2 t = make_float2(v[1].x + v[2].x, v[1].y + v[2].y);
  const float2 d = rot90(make_float2(s * (v[1].x - v[2].x), s * (v[1].y - v[2].y)), inverse);
  const float2 a = make_float2(v[0].x + c * t.x, v[0].y + c * t.y);
  v[0] = make_float2(v[0].x + t.x, v[0].y + t.y);
  v[1] = make_float2(a.x + d.x, a.y + d.y);
  v[2] = make_float2(a.x - d.x, a.y - d.y);
}

template <>
__device__ __forceinline__ void dft_small<5>(float2* v, bool inverse) {
  constexpr float c1 = 0.30901699437494742410f;   // cos(2 pi / 5)
  constexpr float c2 = -0.80901699437494742410f;  // cos(4 pi / 5)
  constexpr float s1 = 0.95105651629515357212f;   // sin(2 pi / 5)
  constexpr float s2 = 0.58778525229247312917f;   // sin(4 pi / 5)
  const float2 t1 = make_float2(v[1].x + v[4].x, v[1].y + v[4].y);
  const float2 d1 = make_float2(v[1].x - v[4].x, v[1].y - v[4].y);
  const float2 t2 = make_float2(v[2].x + v[3].x, v[2].y + v[3].y);
  const float2 d2 = make_float2(v[2].x - v[3].x, v[2].y - v[3].y);
  const float2 a1 = make_float2(v[0].x + c1 * t1.x + c2 * t2.x, v[0].y + c1 * t1.y + c2 * t2.y);
  const float2 a2 = make_float2(v[0].x + c2 * t1.x + c1 * t2.x, v[0].y + c2 * t1.y + c1 * t2.y);
  // y1 = a1 - i (s1 d1 + s2 d2), y2 = a2 - i (s2 d1 - s1 d2) (forward)
  const float2 b1 = rot90(make_float2(s1 * d1.x + s2 * d2.x, s1 * d1.y + s2 * d2.y), inverse);
  const float2 b2 = rot90(make_float2(s2 * d1.x - s1 * d2.x, s2 * d1.y - s1 * d2.y), inverse);
  v[0] = make_float2(v[0].x + t1.x + t2.x, v[0].y + t1.y + t2.y);
  v[1] = make_float2(a1.x + b1.x, a1.y + b1.y);
  v[4] = make_float2(a1.x - b1.x, a1.y - b1.y);
  v[2] = make_float2(a2.x + b2.x, a2.y + b2.y);
  v[3] = make_float2(a2.x - b2.x, a2.y - b2.y);
}

// cos and sin of 2 pi j / 7, j = 1, 2, 3
__host__ __device__ constexpr float cos7(int j) {
  return j == 1 ? 0.62348980185873353053f : (j == 2 ? -0.22252093395631440429f
                                                    : -0.90096886790241912624f);
}
__host__ __device__ constexpr float sin7(int j) {
  return j == 1 ? 0.78183148246802980871f : (j == 2 ? 0.97492791218182360702f
                                                    : 0.43388373911755812048f);
}

// y_m = a_m + b_m and y_{7-m} = a_m - b_m (m = 1, 2, 3), with t_k = v_k +
// v_{7-k}, d_k = v_k - v_{7-k}, a_m = v_0 + sum_k cos(2 pi m k / 7) t_k
// and b_m = -i sum_k sin(2 pi m k / 7) d_k (forward; +i inverse); m k mod
// 7 folds onto 1, 2, 3 with the sine's sign
template <>
__device__ __forceinline__ void dft_small<7>(float2* v, bool inverse) {
  float2 t[4], d[4];
#pragma unroll
  for (int k = 1; k <= 3; ++k) {
    t[k] = make_float2(v[k].x + v[7 - k].x, v[k].y + v[7 - k].y);
    d[k] = make_float2(v[k].x - v[7 - k].x, v[k].y - v[7 - k].y);
  }
  const float2 v0 = v[0];
#pragma unroll
  for (int m = 1; m <= 3; ++m) {
    float2 a = v0, b = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 1; k <= 3; ++k) {
      const int j = (m * k) % 7;
      const float c = cos7(j <= 3 ? j : 7 - j);
      const float s = j <= 3 ? sin7(j) : -sin7(7 - j);
      a = make_float2(a.x + c * t[k].x, a.y + c * t[k].y);
      b = make_float2(b.x + s * d[k].x, b.y + s * d[k].y);
    }
    b = rot90(b, inverse);
    v[m] = make_float2(a.x + b.x, a.y + b.y);
    v[7 - m] = make_float2(a.x - b.x, a.y - b.y);
  }
  v[0] = make_float2(v0.x + t[1].x + t[2].x + t[3].x, v0.y + t[1].y + t[2].y + t[3].y);
}

// the multiple of B below A B that is 1 mod A (A, B coprime)
__host__ __device__ constexpr int crt_unit(int a, int b) {
  int e = 0;
  while ((e * b) % a != 1) ++e;
  return e * b;
}

// DFT of A B points, A and B coprime, by the prime-factor (Good-Thomas)
// split, with no twiddles: input n = (B a + A b) mod A B goes through B
// A-point DFTs, then A B-point DFTs, and output (k1, k2) lands at k =
// (crt_unit(A, B) k1 + crt_unit(B, A) k2) mod A B (k = k1 mod A, k = k2
// mod B). Every index is a compile-time constant once unrolled.
template <int A, int B>
__device__ __forceinline__ void dft_pfa(float2* v, bool inverse) {
  constexpr int N = A * B;
  constexpr int e1 = crt_unit(A, B), e2 = crt_unit(B, A);
  float2 t[B][A];
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int a = 0; a < A; ++a) t[b][a] = v[(B * a + A * b) % N];
    dft_small<A>(t[b], inverse);
  }
#pragma unroll
  for (int k1 = 0; k1 < A; ++k1) {
    float2 u[B];
#pragma unroll
    for (int b = 0; b < B; ++b) u[b] = t[b][k1];
    dft_small<B>(u, inverse);
#pragma unroll
    for (int k2 = 0; k2 < B; ++k2) v[(e1 * k1 + e2 * k2) % N] = u[k2];
  }
}

// the radix-6, -10 and -15 steps: a cluster of 6 blocks
// (csrc/fused_ola.cu), the last pass of 10240 = 16.16.4.10 and 15360 =
// 16.16.4.15 (csrc/fft_reg.cuh)
template <>
__device__ __forceinline__ void dft_small<6>(float2* v, bool inverse) {
  dft_pfa<2, 3>(v, inverse);
}
template <>
__device__ __forceinline__ void dft_small<10>(float2* v, bool inverse) {
  dft_pfa<2, 5>(v, inverse);
}
template <>
__device__ __forceinline__ void dft_small<15>(float2* v, bool inverse) {
  dft_pfa<3, 5>(v, inverse);
}

// one radix-R stage: sub-transforms of length m become ones of length R m
template <int R>
__device__ __forceinline__ void fft_stage(float2* a, const float2* __restrict__ tw,
                                          int n, int m, bool inverse) {
  const int len = R * m;
  const int tstride = n / len;
  const int nb = n / R;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int blk = b / m;
    const int k = b - blk * m;
    const int base = blk * len + k;
    float2 v[R];
    v[0] = a[base];
#pragma unroll
    for (int j = 1; j < R; ++j) {
      float2 w = __ldg(&tw[j * k * tstride]);
      if (inverse) w.y = -w.y;
      v[j] = cmul(a[base + j * m], w);
    }
    dft_small<R>(v, inverse);
#pragma unroll
    for (int q = 0; q < R; ++q) a[base + q * m] = v[q];
  }
}

// In-place FFT of plan.n points in shared memory (input digit-reversed,
// output natural; inverse=true conjugates, no 1/n scaling). Synchronizes
// the block on entry and after each stage.
__device__ inline void fft_mixed(float2* a, const float2* __restrict__ tw,
                                 FftPlan plan, bool inverse) {
  __syncthreads();
  int m = 1;
  for (int s = 0; s < plan.stages; ++s) {
    const int r = (plan.code >> (3 * s)) & 7;
    switch (r) {
      case 2: fft_stage<2>(a, tw, plan.n, m, inverse); break;
      case 3: fft_stage<3>(a, tw, plan.n, m, inverse); break;
      case 4: fft_stage<4>(a, tw, plan.n, m, inverse); break;
      case 7: fft_stage<7>(a, tw, plan.n, m, inverse); break;
      default: fft_stage<5>(a, tw, plan.n, m, inverse); break;
    }
    m *= r;
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

// whether p is a prime (the radices of the split routes' generic pass and of
// csrc/fft_plan.cuh pass_prime)
__host__ __device__ constexpr bool is_prime(int p) {
  if (p < 2) return false;
  for (int q = 2; q * q <= p; ++q)
    if (p % q == 0) return false;
  return true;
}

}  // namespace iqt
