// Fused OLA bandpass + rational resample, one block per OLA frame.
//
// Replaces: iqwaveform_tpu/ops/pallas/fused_ola_pallas.py
//   fused_ola_strided (_fused_ola_strided_kernel); its per-frame chain is
//   also that of fused_ola_packed and fused_ola_pallas.
//
// Per frame m (block m, batch row blockIdx.y):
//   1. load x[m*hop_in : m*hop_in + nfft], zero past the row's end (the
//      single-device 'extend' halo), times the complex analysis window
//      (fftshift delay, 1/sum|w[::hop]| and the input scale baked in),
//      into bit-reversed order in shared memory;
//   2. forward FFT of nfft points;
//   3. keep the bins in [zero_lo, zero_hi), copy source bins [in_lo, in_hi)
//      to output bins [out_lo, out_hi) of an nfft_out-bin spectrum that is
//      zero elsewhere;
//   4. inverse FFT of nfft_out points, times 1/nfft_out and w_out;
//   5. overlap-add into y at m*hop_out with atomicAdd; samples past the
//      row's n_out (the last frame's dangling tail) are dropped.
//
// Determinism: at 2:1 overlap every output sample receives exactly two
// contributions onto zero, and fl(0 + a + b) == fl(0 + b + a), so the
// result does not depend on the order in which blocks finish.
//
// What bounds it on an H100: device memory traffic is one read of the
// input (8 B/sample) and one write of the output (8 B per output sample),
// about 200 MB at the flagship 2^24-sample step, ~60 us at 3.35 TB/s; the
// ~3.4 GFLOP of float32 FFT work is below that. The design keeps every
// intermediate (frame, both spectra) in shared memory: a 16384-point frame
// is 128 KiB of the SM's 227 KiB, so one block of 1024 threads holds an SM.
// What this simple version pays instead is shared-memory bandwidth and one
// block-wide barrier per radix-2 stage (27 stages per flagship frame);
// radix-4/8 stages in registers are the next step.
#include "fft.cuh"

namespace {

constexpr int kThreads = 1024;

// PT = output-spectrum bins per thread (nfft_out / kThreads, at least 1):
// the trimmed spectrum passes through registers so that it can overwrite
// the input spectrum in place.
template <int PT>
__global__ void __launch_bounds__(kThreads)
fused_ola_kernel(const float2* __restrict__ x, const float2* __restrict__ w_in,
                 const float2* __restrict__ tw_in,
                 const float2* __restrict__ w_out,
                 const float2* __restrict__ tw_out, float* __restrict__ y,
                 int n_in, int n_out, int log2_nfft, int log2_nfft_out,
                 int hop_in, int hop_out, int zero_lo, int zero_hi, int in_lo,
                 int out_lo, int out_hi) {
  extern __shared__ float2 buf[];
  const int nfft = 1 << log2_nfft;
  const int nfft_out = 1 << log2_nfft_out;
  const int m = blockIdx.x;
  const float2* xr = x + static_cast<long long>(blockIdx.y) * n_in;
  float* yr = y + 2 * static_cast<long long>(blockIdx.y) * n_out;

  const long long start = static_cast<long long>(m) * hop_in;
  for (int n = threadIdx.x; n < nfft; n += blockDim.x) {
    const long long idx = start + n;
    const float2 v = idx < n_in ? xr[idx] : make_float2(0.f, 0.f);
    buf[iqt::bitrev(n, log2_nfft)] = iqt::cmul(v, w_in[n]);
  }
  iqt::fft_radix2(buf, tw_in, log2_nfft, false);

  float2 z[PT];
#pragma unroll
  for (int r = 0; r < PT; ++r) {
    const int j = threadIdx.x + r * kThreads;
    float2 v = make_float2(0.f, 0.f);
    if (j < nfft_out && j >= out_lo && j < out_hi) {
      const int k = in_lo + (j - out_lo);
      if (k >= zero_lo && k < zero_hi) v = buf[k];
    }
    z[r] = v;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < PT; ++r) {
    const int j = threadIdx.x + r * kThreads;
    if (j < nfft_out) buf[iqt::bitrev(j, log2_nfft_out)] = z[r];
  }
  iqt::fft_radix2(buf, tw_out, log2_nfft_out, true);

  const float scale = 1.0f / static_cast<float>(nfft_out);
  const long long out0 = static_cast<long long>(m) * hop_out;
  for (int n = threadIdx.x; n < nfft_out; n += blockDim.x) {
    const long long o = out0 + n;
    if (o < n_out) {
      float2 v = buf[n];
      v = iqt::cmul(make_float2(v.x * scale, v.y * scale), w_out[n]);
      atomicAdd(&yr[2 * o], v.x);
      atomicAdd(&yr[2 * o + 1], v.y);
    }
  }
}

template <int PT>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const float2* x, const float2* w_in, const float2* tw_in,
                   const float2* w_out, const float2* tw_out, float* y,
                   int n_in, int n_out, int log2_nfft, int log2_nfft_out,
                   int hop_in, int hop_out, int zero_lo, int zero_hi,
                   int in_lo, int out_lo, int out_hi) {
  fused_ola_kernel<PT><<<grid, kThreads, smem, stream>>>(
      x, w_in, tw_in, w_out, tw_out, y, n_in, n_out, log2_nfft,
      log2_nfft_out, hop_in, hop_out, zero_lo, zero_hi, in_lo, out_lo,
      out_hi);
  return cudaGetLastError();
}

// ---- the frame-batch entry --------------------------------------------
//
// Replaces: iqwaveform_tpu/ops/pallas/fused_ola_pallas.py fused_ola_pallas
//   ((M, nfft) complex64 frames -> (M, nfft_out) complex64) and
//   fused_ola_packed (the same per-frame chain on float32 planes, which
//   the monitor's grouped overlap-add at R = nfft / hop > 2 runs).
//
// One block per frame (blockIdx.x = m, blockIdx.y = batch row b): frame
// (b, m) starts at x + b * batch_stride + m * frame_stride, so the same
// kernel takes a contiguous (M, nfft) batch or a strided view of a capture
// (frame_stride = hop) without a copy of the frames. The chain is that of
// fused_ola_kernel above, on the mixed-radix FFT of fft.cuh (sizes
// 2^a 3^b 5^c): times w_in, forward FFT, the [zero_lo, zero_hi) mask, the
// copy of [in_lo, ...) to [out_lo, out_hi) of an nfft_out-bin spectrum,
// inverse FFT, times w_out / nfft_out. Each frame is written whole to
// y[b, m, :]; there are no atomics. The overlap-add of R frames per
// output sample stays outside, as a sum of R groups in a fixed order
// (float atomics are order-independent for two contributions only).
//
// What bounds it on an H100: memory. At BASELINE config #2 (16384 -> 8192
// on 10^8 samples) it must read the capture once (0.8 GB) and write every
// frame's nfft_out outputs (0.8 GB): about 0.48 ms at 3.35 TB/s, while
// the FFT work (~2.1e10 flop) takes 0.31 ms at 67 TFLOP/s. At 2:1 the
// overlapping frames read each sample twice, mostly from L2. As in the 2:1 kernel, the frame stays in shared memory
// from load to store; this simple version pays a barrier and a
// shared-memory round trip per radix-4/2/3/5 stage (8 stages for the
// 16384 -> 8192 pair) and a host-built permutation table for the
// digit-reversed load.
template <int PT>
__global__ void __launch_bounds__(kThreads, 1)
fused_ola_frames_kernel(const float2* __restrict__ x, long long batch_stride,
                        long long frame_stride, const float2* __restrict__ w_in,
                        const float2* __restrict__ tw_in,
                        const int* __restrict__ perm_in,
                        const float2* __restrict__ w_out,
                        const float2* __restrict__ tw_out,
                        const int* __restrict__ perm_out,
                        float2* __restrict__ y, int n_frames, iqt::FftPlan plan_in,
                        iqt::FftPlan plan_out, int zero_lo, int zero_hi,
                        int in_lo, int out_lo, int out_hi) {
  extern __shared__ float2 buf[];
  const int nfft = plan_in.n;
  const int nfft_out = plan_out.n;
  const int m = blockIdx.x;
  const float2* xf = x + blockIdx.y * batch_stride + m * frame_stride;

  for (int n = threadIdx.x; n < nfft; n += blockDim.x) {
    buf[__ldg(&perm_in[n])] = iqt::cmul(xf[n], w_in[n]);
  }
  iqt::fft_mixed(buf, tw_in, plan_in, false);

  float2 z[PT];
#pragma unroll
  for (int r = 0; r < PT; ++r) {
    const int j = threadIdx.x + r * kThreads;
    float2 v = make_float2(0.f, 0.f);
    if (j < nfft_out && j >= out_lo && j < out_hi) {
      const int k = in_lo + (j - out_lo);
      if (k >= zero_lo && k < zero_hi) v = buf[k];
    }
    z[r] = v;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < PT; ++r) {
    const int j = threadIdx.x + r * kThreads;
    if (j < nfft_out) buf[__ldg(&perm_out[j])] = z[r];
  }
  iqt::fft_mixed(buf, tw_out, plan_out, true);

  const float scale = 1.0f / static_cast<float>(nfft_out);
  float2* yf = y + (static_cast<long long>(blockIdx.y) * n_frames + m) * nfft_out;
  for (int n = threadIdx.x; n < nfft_out; n += blockDim.x) {
    const float2 v = buf[n];
    yf[n] = iqt::cmul(make_float2(v.x * scale, v.y * scale), w_out[n]);
  }
}

template <int PT>
cudaError_t launch_frames(dim3 grid, size_t smem, cudaStream_t stream,
                          const float2* x, long long batch_stride,
                          long long frame_stride, const float2* w_in,
                          const float2* tw_in, const int* perm_in,
                          const float2* w_out, const float2* tw_out,
                          const int* perm_out, float2* y, int n_frames,
                          iqt::FftPlan plan_in, iqt::FftPlan plan_out,
                          int zero_lo, int zero_hi, int in_lo, int out_lo,
                          int out_hi) {
  fused_ola_frames_kernel<PT><<<grid, kThreads, smem, stream>>>(
      x, batch_stride, frame_stride, w_in, tw_in, perm_in, w_out, tw_out,
      perm_out, y, n_frames, plan_in, plan_out, zero_lo, zero_hi, in_lo,
      out_lo, out_hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" int iqt_fused_ola_frames_prepare(int max_smem) {
  cudaError_t err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<1>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<2>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<4>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<8>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<16>, max_smem))) return err;
  return iqt::allow_smem(fused_ola_frames_kernel<32>, max_smem);
}

// frames (batch, n_frames, nfft) complex64 at the given element strides
// (the last one 1); y: (batch, n_frames, nfft_out) complex64, contiguous.
// Each plan is (stages, radix code) of its size; perm_* the digit-reversal
// tables, tw_* the full twiddle tables exp(-2 pi i t / n), t < n.
extern "C" int iqt_fused_ola_frames(
    const void* x, long long batch_stride, long long frame_stride,
    const void* w_in, const void* tw_in, const void* perm_in,
    const void* w_out, const void* tw_out, const void* perm_out, void* y,
    int batch, int n_frames, int nfft, int stages_in, int code_in,
    int nfft_out, int stages_out, int code_out, int zero_lo, int zero_hi,
    int in_lo, int out_lo, int out_hi, void* stream) {
  const int nmax = nfft > nfft_out ? nfft : nfft_out;
  const size_t smem = static_cast<size_t>(nmax) * sizeof(float2);
  const int need = (nfft_out + kThreads - 1) / kThreads;
  const dim3 grid(n_frames, batch);
  const iqt::FftPlan pin{nfft, stages_in, code_in};
  const iqt::FftPlan pout{nfft_out, stages_out, code_out};
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float2*>(x);
  auto wi = static_cast<const float2*>(w_in);
  auto ti = static_cast<const float2*>(tw_in);
  auto pi = static_cast<const int*>(perm_in);
  auto wo = static_cast<const float2*>(w_out);
  auto to = static_cast<const float2*>(tw_out);
  auto po = static_cast<const int*>(perm_out);
  auto yp = static_cast<float2*>(y);
#define IQT_FRAMES(P)                                                        \
  if (need <= P)                                                             \
    return launch_frames<P>(grid, smem, s, xp, batch_stride, frame_stride,   \
                            wi, ti, pi, wo, to, po, yp, n_frames, pin, pout, \
                            zero_lo, zero_hi, in_lo, out_lo, out_hi);
  IQT_FRAMES(1)
  IQT_FRAMES(2)
  IQT_FRAMES(4)
  IQT_FRAMES(8)
  IQT_FRAMES(16)
  IQT_FRAMES(32)
#undef IQT_FRAMES
  return cudaErrorInvalidValue;
}

// once per device, before the first launch: allow up to `max_smem` bytes
// of dynamic shared memory (the larger of the two frames)
extern "C" int iqt_fused_ola_prepare(int max_smem) {
  cudaError_t err;
  if ((err = iqt::allow_smem(fused_ola_kernel<1>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_kernel<2>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_kernel<4>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_kernel<8>, max_smem))) return err;
  return iqt::allow_smem(fused_ola_kernel<16>, max_smem);
}

// x: (batch, n_in) complex64; y: (batch, n_out) complex64, zeroed by the
// caller; n_frames frames per row. Sizes are powers of two up to 16384.
extern "C" int iqt_fused_ola(const void* x, const void* w_in,
                             const void* tw_in, const void* w_out,
                             const void* tw_out, void* y, int batch,
                             int n_in, int n_frames, int n_out,
                             int log2_nfft, int log2_nfft_out, int hop_in,
                             int hop_out, int zero_lo, int zero_hi,
                             int in_lo, int out_lo, int out_hi,
                             void* stream) {
  const int nmax = 1 << (log2_nfft > log2_nfft_out ? log2_nfft : log2_nfft_out);
  const size_t smem = static_cast<size_t>(nmax) * sizeof(float2);
  const int pt = (1 << log2_nfft_out) > kThreads ? (1 << log2_nfft_out) / kThreads : 1;
  const dim3 grid(n_frames, batch);
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float2*>(x);
  auto wi = static_cast<const float2*>(w_in);
  auto ti = static_cast<const float2*>(tw_in);
  auto wo = static_cast<const float2*>(w_out);
  auto to = static_cast<const float2*>(tw_out);
  auto yp = static_cast<float*>(y);
#define IQT_OLA(P)                                                        \
  case P:                                                                 \
    return launch<P>(grid, smem, s, xp, wi, ti, wo, to, yp, n_in, n_out,  \
                     log2_nfft, log2_nfft_out, hop_in, hop_out, zero_lo,  \
                     zero_hi, in_lo, out_lo, out_hi);
  switch (pt) {
    IQT_OLA(1)
    IQT_OLA(2)
    IQT_OLA(4)
    IQT_OLA(8)
    IQT_OLA(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef IQT_OLA
}
