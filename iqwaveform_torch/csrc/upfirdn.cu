// Polyphase upsample, FIR filter and downsample, with the semantics of
// scipy.signal.upfirdn on the last axis.
//
// Replaces: iqwaveform_tpu/ops/pallas/upfirdn_pallas.py upfirdn_pallas
//   (_upfirdn_pallas_real, a banded block-Toeplitz matmul whose operator
//   must fit the TPU's VMEM; it refuses a 4001-tap filter at 2:1). This is
//   instead a per-output gather-MAC, as in the reference's own CUDA
//   kernel, which has no such cap.
//
// For output n, with t = n * down, phase p = t mod up and i0 = t div up:
//   y[n] = sum_j h[p + j * up] * x[i0 - j],   x = 0 outside [0, n_in).
// With g = gcd(up, down), P = up / g and D = down / g, the outputs
// n = n0 + c + P k (n0 a multiple of P) share the phase p_c = (c down) mod
// up, and their i0 advances by D per step of k: a phase class is a plain
// correlation of the taps h[p_c::up] with the stride-D samples of x.
//
// Both kernels below: a block owns P * k_blk consecutive outputs of one
// batch row (blockIdx.y). It stages the taps and the input span those
// outputs read in shared memory, the span split by residue mod D, so that
// x[i0 - j] for consecutive k of one class are consecutive words of one
// residue stream. Sums are float32, FMAs only.
//
// What bounds them on an H100: operations. At BASELINE config #2 (10^8
// complex64 samples, 4001 real taps, up 1, down 2) the work is 5e7 x 4001
// x 2 float32 FMAs, 11.9 ms at 67 TFLOP/s, against 0.36 ms for its bytes.
//
// upfirdn_kernel (the generic kernel): each lane accumulates kOpt = 4
// outputs 32 apart; per tap j (in the order j = 0, 1, ...) a warp loads
// the tap (a broadcast) and kOpt samples, for 2 kOpt FMAs. That is one
// shared-memory load per FMA pair, so the shared-memory port, not the FMA
// units, sets its pace (4.6x over the FMA bound on an H100).
//
// upfirdn_reg_kernel (the register-windowed kernel, routed wherever its
// blocking fits; ops/kernels/upfirdn.py upfirdn_route): split the taps of
// class c by residue j' = j mod D, j = j' + D i. For fixed j' the sum over
// i is a 1-D correlation of g_i = h[p_c + (j' + D i) up] with one residue
// stream z of the span: y_k += sum_i g_i z[s0 + k - i]. A lane owns kRegM
// consecutive outputs k .. k + kRegM - 1 and keeps a window of kRegM
// stream samples in registers; each step i loads one new sample and one
// tap (a broadcast) and issues kRegM complex x real MACs, so the FMA units
// set the pace. The loop is unrolled by kRegM, so the window moves by
// register renaming (slot (m - i) mod kRegM holds z[s0 + k - i + m]), and
// a last unrolled round with a guard takes the steps that are left. Lanes
// read the stream kRegM words (float) or float2 apart; kRegM is odd, so
// the 32 loads of one step fall on distinct banks (each half-warp's 16
// float2 on distinct bank pairs). The taps are regrouped on load into one
// zero-padded row per (c, j'). Sums run by j', then by i.
#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOpt = 4;             // outputs per lane per work item
constexpr int kChunk = 32 * kOpt;   // outputs of one phase class per item

template <bool C>
struct Elem {
  using T = float;
};
template <>
struct Elem<true> {
  using T = float2;
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }

__device__ __forceinline__ void mac(float& acc, float h, float x) {
  acc = fmaf(h, x, acc);
}
__device__ __forceinline__ void mac(float2& acc, float h, float2 x) {
  acc.x = fmaf(h, x.x, acc.x);
  acc.y = fmaf(h, x.y, acc.y);
}
__device__ __forceinline__ void mac(float2& acc, float2 h, float x) {
  acc.x = fmaf(h.x, x, acc.x);
  acc.y = fmaf(h.y, x, acc.y);
}
__device__ __forceinline__ void mac(float2& acc, float2 h, float2 x) {
  acc.x = fmaf(h.x, x.x, acc.x);
  acc.x = fmaf(-h.y, x.y, acc.x);
  acc.y = fmaf(h.x, x.y, acc.y);
  acc.y = fmaf(h.y, x.x, acc.y);
}

template <bool XC, bool HC>
__global__ void __launch_bounds__(kThreads)
upfirdn_kernel(const typename Elem<XC>::T* __restrict__ x,
               const typename Elem<HC>::T* __restrict__ h,
               typename Elem<XC || HC>::T* __restrict__ y, int n_in,
               long long n_out, int len_h, int up, int down, int P, int D,
               int j_max, int k_blk, int span, int span_d, int taps_bytes) {
  using XT = typename Elem<XC>::T;
  using HT = typename Elem<HC>::T;
  using YT = typename Elem<XC || HC>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  HT* hs = reinterpret_cast<HT*>(smem);
  XT* xs = reinterpret_cast<XT*>(smem + taps_bytes);

  const long long n0 = static_cast<long long>(blockIdx.x) * P * k_blk;
  // first input sample of the block's outputs, less the filter's reach
  const long long lo = static_cast<long long>(blockIdx.x) * k_blk * D - (j_max - 1);
  const XT* xr = x + static_cast<long long>(blockIdx.y) * n_in;
  YT* yr = y + static_cast<long long>(blockIdx.y) * n_out;

  for (int t = threadIdx.x; t < len_h; t += blockDim.x) hs[t] = h[t];
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const long long i = lo + t;
    const XT v = (i >= 0 && i < n_in) ? xr[i] : zero<XT>();
    const int q = t / D;
    xs[(t - q * D) * span_d + q] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = k_blk / kChunk;
  for (int item = warp; item < P * chunks; item += kWarps) {
    const int c = item / chunks;
    const int kc = (item - c * chunks) * kChunk;
    const int p = (c * down) % up;
    const int e = (c * down) / up;
    const int taps = p < len_h ? (len_h - p + up - 1) / up : 0;
    YT acc[kOpt];
#pragma unroll
    for (int q = 0; q < kOpt; ++q) acc[q] = zero<YT>();
    // span position of x[i0 - j] for k = 0: residue r, index s (mod D)
    const int base = j_max - 1 + e;
    int r = base % D;
    int s = base / D;
    for (int j = 0; j < taps; ++j) {
      const HT hv = hs[p + j * up];
      const XT* row = xs + r * span_d + s + kc + lane;
#pragma unroll
      for (int q = 0; q < kOpt; ++q) mac(acc[q], hv, row[32 * q]);
      if (--r < 0) {
        r = D - 1;
        --s;
      }
    }
#pragma unroll
    for (int q = 0; q < kOpt; ++q) {
      const long long n = n0 + c + static_cast<long long>(P) * (kc + lane + 32 * q);
      if (n < n_out) yr[n] = acc[q];
    }
  }
}

constexpr int kRegM = 15;              // outputs per lane, odd (banks)
constexpr int kRegItem = 32 * kRegM;   // outputs of one phase class per item

// one residue j' of one work item: acc[m] += sum_i g[i] z[k - i + m] over
// i < n_i, with zp = &z[k] (z the residue stream) and g the (c, j') row of
// regrouped taps. Slot (m - i) mod kRegM of `win` holds z[k - i + m].
template <typename XT, typename HT, typename YT>
__device__ __forceinline__ void window_mac(YT (&acc)[kRegM], const XT* zp,
                                           const HT* gp, int n_i) {
  XT win[kRegM];
#pragma unroll
  for (int m = 1; m < kRegM; ++m) win[m] = zp[m];
  int i = 0;
  for (; i + kRegM <= n_i; i += kRegM) {
#pragma unroll
    for (int u = 0; u < kRegM; ++u) {
      win[(kRegM - u) % kRegM] = zp[-(i + u)];
      const HT hv = gp[i + u];
#pragma unroll
      for (int m = 0; m < kRegM; ++m) mac(acc[m], hv, win[(m - u + kRegM) % kRegM]);
    }
  }
  // i is a multiple of kRegM here, so step i + u still uses slot phase u
#pragma unroll
  for (int u = 0; u < kRegM; ++u) {
    if (i + u < n_i) {
      win[(kRegM - u) % kRegM] = zp[-(i + u)];
      const HT hv = gp[i + u];
#pragma unroll
      for (int m = 0; m < kRegM; ++m) mac(acc[m], hv, win[(m - u + kRegM) % kRegM]);
    }
  }
}

// k_blk is a multiple of kRegItem; shared memory holds the P * D tap rows
// of `tstride` entries (taps_bytes, a multiple of 16) and then the span.
template <bool XC, bool HC>
__global__ void __launch_bounds__(kThreads, 2)
upfirdn_reg_kernel(const typename Elem<XC>::T* __restrict__ x,
                   const typename Elem<HC>::T* __restrict__ h,
                   typename Elem<XC || HC>::T* __restrict__ y, int n_in,
                   long long n_out, int len_h, int up, int down, int P, int D,
                   int j_max, int k_blk, int span, int span_d, int tstride,
                   int taps_bytes) {
  using XT = typename Elem<XC>::T;
  using HT = typename Elem<HC>::T;
  using YT = typename Elem<XC || HC>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  HT* hs = reinterpret_cast<HT*>(smem);
  XT* xs = reinterpret_cast<XT*>(smem + taps_bytes);

  const long long n0 = static_cast<long long>(blockIdx.x) * P * k_blk;
  const long long lo = static_cast<long long>(blockIdx.x) * k_blk * D - (j_max - 1);
  const XT* xr = x + static_cast<long long>(blockIdx.y) * n_in;
  YT* yr = y + static_cast<long long>(blockIdx.y) * n_out;

  // row (c, j') = c D + j': g_i = h[p_c + (j' + D i) up], zero past the taps
  for (int t = threadIdx.x; t < P * D * tstride; t += blockDim.x) {
    const int row = t / tstride;
    const int c = row / D;
    const int tap = (c * down) % up + (row - c * D + D * (t - row * tstride)) * up;
    hs[t] = tap < len_h ? h[tap] : zero<HT>();
  }
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const long long i = lo + t;
    const XT v = (i >= 0 && i < n_in) ? xr[i] : zero<XT>();
    const int q = t / D;
    xs[(t - q * D) * span_d + q] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int items = k_blk / kRegItem;
  for (int item = warp; item < P * items; item += kWarps) {
    const int c = item / items;
    const int k = (item - c * items) * kRegItem + lane * kRegM;
    const int p = (c * down) % up;
    const int taps = p < len_h ? (len_h - p + up - 1) / up : 0;
    // span position of x[i0 - j] for k = 0 is base - j
    const int base = j_max - 1 + (c * down) / up;
    YT acc[kRegM];
#pragma unroll
    for (int m = 0; m < kRegM; ++m) acc[m] = zero<YT>();
    for (int jr = 0; jr < D && jr < taps; ++jr) {
      const int s0 = (base - jr) / D;
      const int r = base - jr - s0 * D;
      window_mac(acc, xs + r * span_d + s0 + k, hs + (c * D + jr) * tstride,
                 (taps - jr + D - 1) / D);
    }
#pragma unroll
    for (int m = 0; m < kRegM; ++m) {
      const long long n = n0 + c + static_cast<long long>(P) * (k + m);
      if (n < n_out) yr[n] = acc[m];
    }
  }
}

template <bool XC, bool HC>
cudaError_t launch_reg(dim3 grid, int smem, cudaStream_t stream, const void* x,
                       const void* h, void* y, int n_in, long long n_out,
                       int len_h, int up, int down, int P, int D, int j_max,
                       int k_blk, int span, int span_d, int tstride,
                       int taps_bytes) {
  upfirdn_reg_kernel<XC, HC><<<grid, kThreads, smem, stream>>>(
      static_cast<const typename Elem<XC>::T*>(x),
      static_cast<const typename Elem<HC>::T*>(h),
      static_cast<typename Elem<XC || HC>::T*>(y), n_in, n_out, len_h, up,
      down, P, D, j_max, k_blk, span, span_d, tstride, taps_bytes);
  return cudaGetLastError();
}

template <bool XC, bool HC>
cudaError_t launch(dim3 grid, int smem, cudaStream_t stream, const void* x,
                   const void* h, void* y, int n_in, long long n_out,
                   int len_h, int up, int down, int P, int D, int j_max,
                   int k_blk, int span, int span_d, int taps_bytes) {
  upfirdn_kernel<XC, HC><<<grid, kThreads, smem, stream>>>(
      static_cast<const typename Elem<XC>::T*>(x),
      static_cast<const typename Elem<HC>::T*>(h),
      static_cast<typename Elem<XC || HC>::T*>(y), n_in, n_out, len_h, up,
      down, P, D, j_max, k_blk, span, span_d, taps_bytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int iqt_upfirdn_prepare(int max_smem) {
  cudaError_t err;
  if ((err = iqt::allow_smem(upfirdn_kernel<false, false>, max_smem))) return err;
  if ((err = iqt::allow_smem(upfirdn_kernel<false, true>, max_smem))) return err;
  if ((err = iqt::allow_smem(upfirdn_kernel<true, false>, max_smem))) return err;
  if ((err = iqt::allow_smem(upfirdn_kernel<true, true>, max_smem))) return err;
  if ((err = iqt::allow_smem(upfirdn_reg_kernel<false, false>, max_smem))) return err;
  if ((err = iqt::allow_smem(upfirdn_reg_kernel<false, true>, max_smem))) return err;
  if ((err = iqt::allow_smem(upfirdn_reg_kernel<true, false>, max_smem))) return err;
  return iqt::allow_smem(upfirdn_reg_kernel<true, true>, max_smem);
}

// x: (batch, n_in) float32 or complex64; h: (len_h,) float32 or complex64;
// y: (batch, n_out), complex64 when either is complex. The blocking
// (k_blk outputs per phase class and block, a multiple of 128; the span
// and its per-residue length span_d; the taps' bytes, a multiple of 16;
// smem in all) is computed by the caller.
extern "C" int iqt_upfirdn(const void* x, const void* h, void* y, int batch,
                           int n_in, long long n_out, int len_h, int up,
                           int down, int P, int D, int j_max, int k_blk,
                           int span, int span_d, int taps_bytes, int smem,
                           int x_complex, int h_complex, void* stream) {
  const long long per_block = static_cast<long long>(P) * k_blk;
  const dim3 grid(static_cast<unsigned>((n_out + per_block - 1) / per_block), batch);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_complex && h_complex)
    return launch<true, true>(grid, smem, s, x, h, y, n_in, n_out, len_h, up,
                              down, P, D, j_max, k_blk, span, span_d, taps_bytes);
  if (x_complex)
    return launch<true, false>(grid, smem, s, x, h, y, n_in, n_out, len_h, up,
                               down, P, D, j_max, k_blk, span, span_d, taps_bytes);
  if (h_complex)
    return launch<false, true>(grid, smem, s, x, h, y, n_in, n_out, len_h, up,
                               down, P, D, j_max, k_blk, span, span_d, taps_bytes);
  return launch<false, false>(grid, smem, s, x, h, y, n_in, n_out, len_h, up,
                              down, P, D, j_max, k_blk, span, span_d, taps_bytes);
}

// the register-windowed kernel: arguments as for iqt_upfirdn, with the
// regrouped taps' row length tstride (taps_bytes their padded size) and
// k_blk a multiple of 32 * kRegM (ops/kernels/upfirdn.py _reg_blocking)
extern "C" int iqt_upfirdn_reg(const void* x, const void* h, void* y, int batch,
                               int n_in, long long n_out, int len_h, int up,
                               int down, int P, int D, int j_max, int k_blk,
                               int span, int span_d, int tstride, int taps_bytes,
                               int smem, int x_complex, int h_complex, void* stream) {
  if (k_blk % kRegItem) return cudaErrorInvalidValue;
  const long long per_block = static_cast<long long>(P) * k_blk;
  const dim3 grid(static_cast<unsigned>((n_out + per_block - 1) / per_block), batch);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_complex && h_complex)
    return launch_reg<true, true>(grid, smem, s, x, h, y, n_in, n_out, len_h, up, down,
                                  P, D, j_max, k_blk, span, span_d, tstride, taps_bytes);
  if (x_complex)
    return launch_reg<true, false>(grid, smem, s, x, h, y, n_in, n_out, len_h, up, down,
                                   P, D, j_max, k_blk, span, span_d, tstride, taps_bytes);
  if (h_complex)
    return launch_reg<false, true>(grid, smem, s, x, h, y, n_in, n_out, len_h, up, down,
                                   P, D, j_max, k_blk, span, span_d, tstride, taps_bytes);
  return launch_reg<false, false>(grid, smem, s, x, h, y, n_in, n_out, len_h, up, down,
                                  P, D, j_max, k_blk, span, span_d, tstride, taps_bytes);
}
