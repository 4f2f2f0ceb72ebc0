// Fused OLA bandpass + rational resample, one block per OLA frame (one
// thread-block cluster per frame above one block's shared memory).
//
// Replaces: iqwaveform_tpu/ops/pallas/fused_ola_pallas.py
//   fused_ola_strided (_fused_ola_strided_kernel); its per-frame chain is
//   also that of fused_ola_packed and fused_ola_pallas.
//
// Per frame m (block m, batch row blockIdx.y) of the 2:1 kernels:
//   1. load x[m*hop_in : m*hop_in + nfft] (interleaved complex64, or (2, n)
//      planes of float32, int16 or bfloat16 dequantized on load: Src
//      below); samples past the row's end come from the halo (the next
//      chunk's or shard's head) where the caller gives one, else zero (the
//      single-device 'extend' halo); times the complex analysis window
//      (fftshift delay, 1/sum|w[::hop]| and the input scale baked in),
//      into bit-reversed order in shared memory;
//   2. forward FFT of nfft points;
//   3. keep the bins in [zero_lo, zero_hi), copy source bins [in_lo, in_hi)
//      to output bins [out_lo, out_hi) of an nfft_out-bin spectrum that is
//      zero elsewhere;
//   4. inverse FFT of nfft_out points, times 1/nfft_out and w_out;
//   5. overlap-add into y at m*hop_out with atomicAdd; samples past the
//      row's n_out (the last frame's dangling second half) go to the row's
//      tail where the caller asks for it (one frame writes each, a plain
//      store), else are dropped.
//
// Determinism: at 2:1 overlap every output sample receives exactly two
// contributions onto zero, and fl(0 + a + b) == fl(0 + b + a), so the
// result does not depend on the order in which blocks finish.
//
// What bounds it on an H100: device memory traffic is one read of the
// input (8 B/sample complex64 or float32 planes, 4 B at int16 or bfloat16)
// and one write of the output (8 B per output sample), about 200 MB at the
// flagship 2^24-sample step, ~60 us at 3.35 TB/s; the ~3.4 GFLOP of
// float32 FFT work is below that. The design keeps every intermediate
// (frame, both spectra) in shared memory: a 16384-point frame is 128 KiB
// of the SM's 227 KiB, so one block of 1024 threads holds an SM. What this
// simple version pays instead is shared-memory bandwidth and one
// block-wide barrier per radix-2 stage (27 stages per flagship frame); at
// the flagship pair fused_ola_reg_kernel below takes its place.
#include <cuda_bf16.h>

#include "fft.cuh"
#include "fft_cluster.cuh"
#include "fft_reg.cuh"

namespace {

constexpr int kThreads = 1024;

// ---- the 2:1 kernels' input ----------------------------------------------
//
// Src<E> reads sample i of a row whose elements are of type E: (2, n)
// planes of float32, int16 or bfloat16 (a row's real plane, then its
// imaginary plane n elements further: imag(p, n) points there),
// dequantized to float on load (every int16 and bfloat16 value is exact in
// float32), or, for E = float2, interleaved complex64. A row of n samples
// holds kRows * n elements. The storage tiers round on the host
// (ops/kernels/fused_ola.py to_storage); the kernels read what they are
// given.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(short v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class E>
struct Src {
  static constexpr int kRows = 2;
  __device__ static const E* imag(const E* p, int n) { return p + n; }
  __device__ static float2 read(const E* __restrict__ re, const E* __restrict__ im, int i) {
    return make_float2(to_float(re[i]), to_float(im[i]));
  }
};
template <>
struct Src<float2> {
  static constexpr int kRows = 1;
  __device__ static const float2* imag(const float2* p, int) { return p; }
  __device__ static float2 read(const float2* __restrict__ p, const float2*, int i) {
    return p[i];
  }
};

// sample i of a frame whose first `valid` samples lie at x (a row of n_in
// samples), the next ones in the halo h (n_halo samples) up to `end`, zero
// after
template <class E>
__device__ __forceinline__ float2 frame_sample(const E* x, int n_in, const E* h, int n_halo,
                                               int valid, int end, int i) {
  if (i < valid) return Src<E>::read(x, Src<E>::imag(x, n_in), i);
  if (i < end) return Src<E>::read(h, Src<E>::imag(h, n_halo), i - valid);
  return make_float2(0.f, 0.f);
}

// PT = output-spectrum bins per thread (nfft_out / kThreads, at least 1):
// the trimmed spectrum passes through registers so that it can overwrite
// the input spectrum in place. E: the input's element type (Src).
template <int PT, class E>
__global__ void __launch_bounds__(kThreads)
fused_ola_kernel(const E* __restrict__ x, const E* __restrict__ halo, int n_halo,
                 const float2* __restrict__ w_in, const float2* __restrict__ tw_in,
                 const float2* __restrict__ w_out, const float2* __restrict__ tw_out,
                 float* __restrict__ y, float2* __restrict__ tail, int n_in, int n_out,
                 int log2_nfft, int log2_nfft_out, int hop_in, int hop_out, int zero_lo,
                 int zero_hi, int in_lo, int out_lo, int out_hi) {
  extern __shared__ float2 buf[];
  const int nfft = 1 << log2_nfft;
  const int nfft_out = 1 << log2_nfft_out;
  const int m = blockIdx.x;
  // m * hop_in < n_in (the host sizes the grid)
  const int start = m * hop_in;
  const int valid = min(n_in - start, nfft);
  const int end = min(valid + n_halo, nfft);
  const E* xf = x + static_cast<long long>(blockIdx.y) * Src<E>::kRows * n_in + start;
  const E* hr = halo + static_cast<long long>(blockIdx.y) * Src<E>::kRows * n_halo;
  float* yr = y + 2 * static_cast<long long>(blockIdx.y) * n_out;

  for (int n = threadIdx.x; n < nfft; n += blockDim.x) {
    const float2 v = frame_sample<E>(xf, n_in, hr, n_halo, valid, end, n);
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
  // at 2:1 only the row's last frame reaches past n_out, by at most
  // nfft_out - hop_out samples: the tail
  const long long out0 = static_cast<long long>(m) * hop_out;
  for (int n = threadIdx.x; n < nfft_out; n += blockDim.x) {
    const long long o = out0 + n;
    float2 v = buf[n];
    v = iqt::cmul(make_float2(v.x * scale, v.y * scale), w_out[n]);
    if (o < n_out) {
      atomicAdd(&yr[2 * o], v.x);
      atomicAdd(&yr[2 * o + 1], v.y);
    } else if (tail != nullptr) {
      tail[static_cast<long long>(blockIdx.y) * (nfft_out - hop_out) + (o - n_out)] = v;
    }
  }
}

template <int PT, class E>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const void* x, const void* halo,
                   int n_halo, const float2* w_in, const float2* tw_in, const float2* w_out,
                   const float2* tw_out, float* y, float2* tail, int n_in, int n_out,
                   int log2_nfft, int log2_nfft_out, int hop_in, int hop_out, int zero_lo,
                   int zero_hi, int in_lo, int out_lo, int out_hi) {
  fused_ola_kernel<PT, E><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(halo), n_halo, w_in, tw_in, w_out, tw_out,
      y, tail, n_in, n_out, log2_nfft, log2_nfft_out, hop_in, hop_out, zero_lo, zero_hi, in_lo,
      out_lo, out_hi);
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

// ---- the frame-batch entry at its main-path sizes ------------------------
//
// Replaces the same TPU kernels as fused_ola_frames_kernel above
// (fused_ola_pallas.py fused_ola_pallas and fused_ola_packed), with the
// same contract, at the size pairs its paths run: 16384 -> 8192
// (ola_filter / oaresample at BASELINE config #2), 12288 -> 6144 (the
// monitor's blackman design, R = 3) and 12288 -> 4096 (hamming at 122.88 ->
// 40.96 MS/s, min_fft_size=4095). Every other one-block size keeps the
// generic kernel; the host route (ops/kernels/fused_ola.py frames_route)
// picks by size before the launch.
//
// Bound on an H100 (device memory: each input sample read once, each
// output written once, 8 B each): 1.6 GB, 0.4776 ms at 3.35 TB/s for
// 12206 frames of 16384 -> 8192 on a 99,999,744-sample capture; 0.1002 ms
// for 4098 frames of 12288 -> 6144. The FFT work (about 2.1e10 flop at
// 16384) is below that at 67 TFLOP/s.
//
// What held the generic kernel back, and what this one does about it:
// - one block-wide barrier per radix-4/2/3/5 stage, about 14 per frame:
//   here four radix-16 passes (the last radix 4, 3 or 2; 16.16.8.3 at
//   6144) per transform, with a barrier before and after each exchange;
// - a shared-memory round trip per element per stage, with bank conflicts
//   at the early strides: here one per pass, the exchange padded by one
//   float2 in 16 so that every half-warp access is conflict-free;
// - twiddles gathered per butterfly from the full n-point table in device
//   memory: here two small tables per pass in shared memory (1952 float2
//   for both transforms at 16384 -> 8192), copied in once per block from a
//   table the host builds in float64;
// - an integer division per butterfly by a runtime stage length: here the
//   sizes are template arguments, so every index is a shift or a mask;
// - a host-built permutation gather per loaded sample (perm_in, perm_out):
//   the autosort passes need none. Pass 0 reads the strided frame straight
//   from device memory, coalesced, times w_in in registers; the trim is
//   folded into the inverse's first load (bin j reads forward bin
//   in_lo + j - out_lo, masked by [zero_lo, zero_hi) and [out_lo,
//   out_hi)); the inverse's last pass writes y in natural order, coalesced,
//   times w_shift_out / nfft_out.
// 512 threads hold up to 32 points each (the forward at 16384: two
// radix-16 butterflies per pass) within the 128 registers a thread may
// take; the exchange buffer takes 136 KiB at 16384, so one block runs per
// SM, one block per frame. (A persistent grid that walks the frames keeps
// index math live across its loop, and ptxas spills it.) Fixed-order
// arithmetic, no atomics: the output is deterministic. Not done here:
// overlapping the next frame's load with this frame's passes (TMA or
// cp.async into a ring), and two blocks per SM through a real / imaginary
// split of the exchange.
template <int N1, int N2>
struct RegShape {
  // float2 of both transforms' twiddle tables, forward (N1) then inverse
  static constexpr int tw_count = iqt::reg::table_total<N1>() + iqt::reg::table_total<N2>();
  static constexpr size_t smem =
      static_cast<size_t>(iqt::reg::padded_size(N1) + tw_count) * sizeof(float2);
};

// the pairs whose inverse reads the lane anew at each pass (reg::fft_fresh):
// at 16384 -> 4096 (a 4096-point inverse, half of the 512 threads idle)
// the compiler kept two values of the forward's index math live into the
// inverse and spilled them (16-20 bytes a thread in the 2:1 kernel)
template <int N1, int N2>
struct FreshInverse {
  static constexpr bool value = false;
};
template <>
struct FreshInverse<16384, 4096> {
  static constexpr bool value = true;
};

// The per-frame chain of the register-resident kernels, by a block of T
// threads: copy the RegShape tables (`tw`, built on the host from float64:
// ops/kernels/fused_ola.py reg_twiddles) into shared memory after the
// exchange buffer, the forward N1-point transform of load(i) (the frame
// sample i times w_in), the trim folded into the inverse's first load
// (output bin j reads forward bin in_lo + j - out_lo, masked by [zero_lo,
// zero_hi) and [out_lo, out_hi)), the inverse N2-point transform, and
// store(n, v) of each output sample times w_out[n] / N2, in natural order.
// STAGED: the caller has stored the windowed frame into the exchange
// buffer (load is not called), and pass 0 reads it from there.
template <int N1, int N2, int T, bool STAGED = false, class Load, class Store>
__device__ __forceinline__ void reg_frame_chain(float2* smem, const float2* __restrict__ tw,
                                                const float2* __restrict__ w_out, int zero_lo,
                                                int zero_hi, int in_lo, int out_lo, int out_hi,
                                                Load load, Store store) {
  namespace R = iqt::reg;
  float2* buf = smem;
  float2* tw_fwd = smem + R::padded_size(N1);
  float2* tw_inv = tw_fwd + R::table_total<N1>();
  // pass 0 reads no table; the barrier after it orders these stores
  // before the first table read
  for (int e = threadIdx.x; e < RegShape<N1, N2>::tw_count; e += T) tw_fwd[e] = __ldg(&tw[e]);

  const float scale = 1.0f / static_cast<float>(N2);
  if constexpr (STAGED) {
    // the windowed frame is in `buf` already: the forward pass 0 reads it
    // after every thread has stored its share, and stores after every
    // thread has read
    __syncthreads();
    R::fft<N1, false, T, true>(buf, tw_fwd, [buf](int i) { return buf[R::pad(i)]; },
                               [buf](int i, float2 v) { buf[R::pad(i)] = v; });
  } else {
    R::fft<N1, false, T, false>(buf, tw_fwd, load,
                                [buf](int i, float2 v) { buf[R::pad(i)] = v; });
  }
  __syncthreads();
  const auto trim = [=](int j) {
    float2 v = make_float2(0.f, 0.f);
    if (j >= out_lo && j < out_hi) {
      const int k = in_lo + (j - out_lo);
      if (k >= zero_lo && k < zero_hi) v = buf[R::pad(k)];
    }
    return v;
  };
  const auto out = [=](int n, float2 v) {
    store(n, iqt::cmul(make_float2(v.x * scale, v.y * scale), __ldg(&w_out[n])));
  };
  if constexpr (FreshInverse<N1, N2>::value) {
    R::fft_fresh<N2, true, T, true>(buf, tw_inv, trim, out);
  } else {
    R::fft<N2, true, T, true>(buf, tw_inv, trim, out);
  }
}

// One block per frame (blockIdx.x = m, blockIdx.y = batch row b), frames
// addressed as in fused_ola_frames_kernel, each written whole to y[b, m, :].
template <int N1, int N2, int T>
__global__ void __launch_bounds__(T, 1)
fused_ola_frames_reg_kernel(const float2* __restrict__ x, long long batch_stride,
                            long long frame_stride, const float2* __restrict__ w_in,
                            const float2* __restrict__ w_out,
                            const float2* __restrict__ tw, float2* __restrict__ y,
                            int n_frames, int zero_lo, int zero_hi, int in_lo,
                            int out_lo, int out_hi) {
  extern __shared__ float2 smem[];
  const int m = blockIdx.x;
  const float2* xf = x + blockIdx.y * batch_stride + m * frame_stride;
  float2* yf = y + (static_cast<long long>(blockIdx.y) * n_frames + m) * N2;
  reg_frame_chain<N1, N2, T>(
      smem, tw, w_out, zero_lo, zero_hi, in_lo, out_lo, out_hi,
      [xf, w_in](int i) { return iqt::cmul(xf[i], __ldg(&w_in[i])); },
      [yf](int n, float2 v) { yf[n] = v; });
}

template <int N1, int N2, int T>
cudaError_t launch_frames_reg(dim3 grid, cudaStream_t stream, const float2* x,
                              long long batch_stride, long long frame_stride,
                              const float2* w_in, const float2* w_out, const float2* tw,
                              int n_tw, float2* y, int n_frames, int zero_lo, int zero_hi,
                              int in_lo, int out_lo, int out_hi) {
  if (n_tw != RegShape<N1, N2>::tw_count) return cudaErrorInvalidValue;
  fused_ola_frames_reg_kernel<N1, N2, T><<<grid, T, RegShape<N1, N2>::smem, stream>>>(
      x, batch_stride, frame_stride, w_in, w_out, tw, y, n_frames, zero_lo, zero_hi, in_lo,
      out_lo, out_hi);
  return cudaGetLastError();
}

// ---- the frame-batch entry above one block's shared memory --------------
//
// Replaces the same TPU kernels as fused_ola_frames_kernel above
// (fused_ola_pallas.py fused_ola_packed and fused_ola_pallas), with the
// same contract, at frames no block can hold: 8 bytes a point, 49152 ->
// 24576 is 384 KiB, above an H100 block's 227 KiB (and, below it, the
// blackman and hamming frames 24576 -> 12288 and 24576 -> 8192 on two
// blocks, in place of the generic kernel). These are the monitor's
// frames at the blackman and blackmanharris designs of the flagship rates
// (R = 3 and 5, the grouped overlap-add in torch), the blackman design of
// 122.88 -> 30.72 MS/s (98304 -> 24576 on C = 6) and ola_filter's at such
// windows; the host route (ops/kernels/fused_ola.py frames_route) picks
// this kernel at the pairs it is compiled for (CLUSTER_PAIRS). The radix-6
// step is the prime-factor DFT of csrc/fft.cuh. Every instance stays
// within the portable cluster size of 8 (163840 -> 40960 on 10 blocks lost
// to the split route, csrc/ola_split.cu, and 36864 -> 12288 on 3 and 40960
// -> 20480 on 5 tied with it: none of them is compiled).
//
// One frame runs on a thread-block cluster of C blocks (launched with
// cudaLaunchKernelEx and a cluster dimension of C; blockIdx.x = C m +
// rank), each holding M1 = N1 / C, then M2 = N2 / C points in its own
// padded exchange buffer, on the register-resident M-point passes of
// csrc/fft_reg.cuh (csrc/fft_cluster.cuh sets out the split):
//   1. cluster barrier: every block has begun;
//   2. the forward radix-C step: block `rank` owns frame offsets n of its
//      slice of [0, M1): it reads samples c M1 + n (c < C) times w_in,
//      coalesced, takes their C-point DFT in registers, and stores output
//      r times exp(-2 pi i r n / N1) at n in block r's buffer;  cluster
//      barrier;
//   3. block r's M1-point forward passes, in its own buffer: bins X[C k +
//      r];  cluster barrier;
//   4. the trim as the inverse's pass-0 load: inverse bin j = C i + r of
//      block r reads forward bin k = in_lo + j - out_lo, masked by
//      [zero_lo, zero_hi) and [out_lo, out_hi), which lies in one block,
//      (r + in_lo - out_lo) mod C, at a fixed offset from i: a gather from
//      that block's buffer (cluster barrier before the stores); block r's
//      M2-point inverse passes, times exp(+2 pi i r n / N2), into its
//      buffer;  cluster barrier;
//   5. the inverse radix-C step: block `rank` owns offsets n of its slice
//      of [0, M2): it reads point n of every block's buffer, takes their
//      C-point inverse DFT, and writes output sample s M2 + n times w_out /
//      N2, coalesced;  cluster barrier, so that no block exits while
//      another reads its buffer.
//
// Bound on an H100 (device memory: each input sample read once, each
// output written once, 8 B each): 0.1002 ms at 3.35 TB/s for the 1024
// frames of 49152 -> 24576 on 2^24 samples; the FFT work (about 5.8e9
// flop) takes 0.086 ms at 67 TFLOP/s. This first version is simple and
// right: one frame a cluster, six cluster barriers a frame, the cross
// twiddles read from device memory (L2) and not from shared memory (a
// block's buffer and pass tables leave no room for them), each block's
// exchange buffer shared by both transforms. Distributed shared memory is
// slower than a block's own: each radix-C step has one block touch each
// point of every part once (it owns the point), rather than every block
// read every part. Not done here: overlapping the next frame's load with
// this frame's passes, and the radix-C steps inside the neighbouring
// passes.
template <int N1, int N2, int C>
struct ClusterShape {
  static constexpr int m1 = N1 / C, m2 = N2 / C;
  static_assert(m1 * C == N1 && m2 * C == N2, "C divides both sizes");
  static_assert(C >= 2 && C <= 8, "a portable cluster size");
  static constexpr int m_max = m1 > m2 ? m1 : m2;
  // the host table (fused_ola.py _cluster_tables): both transforms' pass
  // tables, then the cross twiddles of the forward (C x M1) and inverse
  // (C x M2)
  static constexpr int passes = iqt::reg::table_total<m1>() + iqt::reg::table_total<m2>();
  static constexpr int fwd_cross = passes;
  static constexpr int inv_cross = fwd_cross + C * m1;
  static constexpr int tw_count = inv_cross + C * m2;
  static constexpr size_t smem =
      static_cast<size_t>(iqt::reg::padded_size(m_max) + passes) * sizeof(float2);
};

template <int N1, int N2, int C, int T>
__global__ void __launch_bounds__(T, 1)
fused_ola_frames_cluster_kernel(const float2* __restrict__ x, long long batch_stride,
                                long long frame_stride, const float2* __restrict__ w_in,
                                const float2* __restrict__ w_out,
                                const float2* __restrict__ tw, float2* __restrict__ y,
                                int n_frames, int zero_lo, int zero_hi, int in_lo, int out_lo,
                                int out_hi) {
  namespace R = iqt::reg;
  namespace CL = iqt::cluster;
  using S = ClusterShape<N1, N2, C>;
  constexpr int M1 = S::m1, M2 = S::m2;
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tw_fwd = smem + R::padded_size(S::m_max);
  float2* tw_inv = tw_fwd + R::table_total<M1>();
  CL::cg::cluster_group cluster = CL::cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int m = blockIdx.x / C;
  const float2* xf = x + blockIdx.y * batch_stride + m * frame_stride;
  float2* yf = y + (static_cast<long long>(blockIdx.y) * n_frames + m) * N2;
  // block c's exchange buffer, mapped where it is used: an array of C
  // mapped pointers held across the passes costs 2 C registers
  const auto part = [&cluster, buf](int c) { return cluster.map_shared_rank(buf, c); };

  // 1. the pass tables, read after the barriers below; every block begun
  for (int e = threadIdx.x; e < S::passes; e += T) tw_fwd[e] = __ldg(&tw[e]);
  cluster.sync();

  // 2. the forward radix-C step over this block's slice of offsets
  for (int n = CL::slice_lo(M1, rank, C) + threadIdx.x; n < CL::slice_lo(M1, rank + 1, C);
       n += T) {
    float2 v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = iqt::cmul(xf[c * M1 + n], __ldg(&w_in[c * M1 + n]));
    iqt::dft_small<C>(v, false);
    part(0)[R::pad(n)] = v[0];
#pragma unroll
    for (int r = 1; r < C; ++r)
      part(r)[R::pad(n)] = iqt::cmul(v[r], __ldg(&tw[S::fwd_cross + r * M1 + n]));
  }
  cluster.sync();

  // 3. the M1-point forward passes in this block's buffer
  R::fft<M1, false, T, true>(
      buf, tw_fwd, [buf](int i) { return buf[R::pad(i)]; },
      [buf](int k, float2 v) { buf[R::pad(k)] = v; });
  cluster.sync();

  // 4. inverse: bins C i + rank, gathered from the one block that holds
  // each, M2 points, the cross twiddle
  const int shift = rank + in_lo - out_lo;
  const int src = ((shift % C) + C) % C;
  const int q = (shift - src) / C;
  const float2* from = part(src);
  const float2* cross_inv = tw + S::inv_cross + rank * M2;
  CL::fft<M2, true, T>(
      buf, tw_inv,
      [=](int i) {
        const int j = C * i + rank;
        const int k = in_lo + (j - out_lo);
        float2 v = make_float2(0.f, 0.f);
        if (j >= out_lo && j < out_hi && k >= zero_lo && k < zero_hi) v = from[R::pad(i + q)];
        return v;
      },
      [buf, cross_inv](int n, float2 v) { buf[R::pad(n)] = iqt::cmul(v, __ldg(&cross_inv[n])); },
      [&cluster] { cluster.sync(); });
  cluster.sync();

  // 5. the inverse radix-C step over this block's slice, scaled, windowed
  const float scale = 1.0f / static_cast<float>(N2);
  for (int n = CL::slice_lo(M2, rank, C) + threadIdx.x; n < CL::slice_lo(M2, rank + 1, C);
       n += T) {
    float2 v[C];
#pragma unroll
    for (int r = 0; r < C; ++r) v[r] = part(r)[R::pad(n)];
    iqt::dft_small<C>(v, true);
#pragma unroll
    for (int s = 0; s < C; ++s)
      yf[s * M2 + n] =
          iqt::cmul(make_float2(v[s].x * scale, v[s].y * scale), __ldg(&w_out[s * M2 + n]));
  }
  cluster.sync();
}

template <int N1, int N2, int C, int T>
cudaLaunchConfig_t cluster_config(dim3 grid, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = ClusterShape<N1, N2, C>::smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int N1, int N2, int C, int T>
cudaError_t launch_frames_cluster(int batch, int n_frames, cudaStream_t stream, const float2* x,
                                  long long batch_stride, long long frame_stride,
                                  const float2* w_in, const float2* w_out, const float2* tw,
                                  int n_tw, float2* y, int zero_lo, int zero_hi, int in_lo,
                                  int out_lo, int out_hi) {
  if (n_tw != ClusterShape<N1, N2, C>::tw_count) return cudaErrorInvalidValue;
  if (static_cast<long long>(n_frames) * C >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config<N1, N2, C, T>(dim3(n_frames * C, batch), stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fused_ola_frames_cluster_kernel<N1, N2, C, T>, x, batch_stride, frame_stride, w_in,
      w_out, tw, y, n_frames, zero_lo, zero_hi, in_lo, out_lo, out_hi);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the clusters of one instance a device can hold at once
template <int N1, int N2, int C, int T>
cudaError_t cluster_occupancy(int* out) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<N1, N2, C, T>(dim3(C), nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, fused_ola_frames_cluster_kernel<N1, N2, C, T>, &cfg);
}

constexpr int kClusterThreads = 512;

// the compiled one-block frame pairs (ops/kernels/fused_ola.py
// REG_PAIRS): F(N1, N2)
#define IQT_FRAMES_REG_PAIRS(F) \
  F(16384, 8192)                \
  F(12288, 6144)                \
  F(12288, 4096)

// the compiled pairs (ops/kernels/fused_ola.py CLUSTER_PAIRS): F(N1, N2, C)
#define IQT_CLUSTER_PAIRS(F) \
  F(49152, 24576, 3)         \
  F(81920, 40960, 5)         \
  F(40960, 40960, 5)         \
  F(32768, 8192, 2)          \
  F(32768, 16384, 2)         \
  F(98304, 24576, 6)         \
  F(24576, 12288, 2)         \
  F(24576, 8192, 2)

// ---- the 2:1 entry at the hamming pairs ----------------------------------
//
// Replaces the same TPU kernel as fused_ola_kernel above
// (fused_ola_pallas.py fused_ola_strided), with the same contract, at the
// size pairs of IQT_OLA_REG_PAIRS below: the flagship monitor step's
// 16384 -> 8192 at 2:1 (the hamming COLA design), 8192 -> 4096 and 16384
// -> 4096. Every other pair keeps fused_ola_kernel; the host route
// (ops/kernels/fused_ola.py ola_route) picks by size before the launch.
//
// Per frame m of batch row b (block m, blockIdx.y = b): the chain of
// fused_ola_frames_reg_kernel (reg_frame_chain above) on the frame at
// x[b, m * hop_in] (any input of Src: complex64, or planes of float32,
// int16 or bfloat16), whose samples at and past the row's n_in come from
// the row's halo while it lasts, then read as zero (the 'extend' halo:
// pass 0 masks its load, coalesced, straight from device memory); the
// last pass overlap-adds each output sample into y[b, m * hop_out + n]
// with a float2 atomicAdd (one vector reduction per sample; compute
// capability 9.0 and CUDA 12.x) onto the zeroed y, and stores the samples
// at and past n_out (the last frame's dangling second half) into the row's
// tail, or drops them where the caller gives none. Determinism: each float
// of the pair is added atomically on its own; at 2:1 overlap every output
// float receives exactly two contributions onto zero, and fl(0 + a + b) ==
// fl(0 + b + a), so the result does not depend on the order in which
// blocks finish. One frame writes each tail sample.
//
// Bound on an H100 (device memory: each input sample read once, each
// output written once): 201 MB, 0.0602 ms at 3.35 TB/s for the flagship
// step's 2048 frames on 2^24 complex64 samples (8 B in, 8 B out); 134 MB,
// 0.0401 ms from int16 or bfloat16 planes (4 B a sample in); its FFT work
// (about 3.4e9 flop) is below that at 67 TFLOP/s.
//
// What held fused_ola_kernel back, and what this one does about it:
// - one block-wide barrier and a shared-memory round trip per radix-2
//   stage, 14 + 13 = 27 per frame: here four register-resident radix-16
//   Stockham passes per transform (csrc/fft_reg.cuh), a barrier before
//   and after each exchange, the exchange padded so that every half-warp
//   access is conflict-free;
// - twiddles gathered per butterfly from device memory: here the two
//   small tables per pass of fused_ola_frames_reg_kernel, copied into
//   shared memory once per block (1952 float2, the same host table);
// - a bit-reversed scatter of the windowed frame into shared memory and a
//   copy pass for the trim: here pass 0 reads the frame in natural order
//   and the trim is the inverse's first load;
// - runtime sizes (shifts by a runtime log2, a loop over stages): here the
//   sizes are template arguments.
// The atomics stay, one float2 reduction per sample where
// fused_ola_kernel issues two float ones: two contributions per output
// float onto zero are deterministic, and the alternative (each frame's
// halves to scratch, summed by a second pass) writes and reads the output
// twice more. 512 threads, the exchange buffer and both tables take
// RegShape<16384, 8192>::smem = 151 KiB: one block per SM, one block per
// frame.
//
// Input types (E, see Src): at complex64, pass 0 reads the frame from
// device memory as above. The plane instances (float32, int16, bfloat16:
// the storage tiers of fused_ola_strided) read two values a sample from
// two planes, which costs pass 0 the registers it does not have (128 a
// thread; ptxas spilled 20 bytes): they first stage the windowed frame
// into the exchange buffer, a coalesced loop, and pass 0 reads it back
// from there after a barrier (reg_frame_chain's STAGED). That is one more
// shared-memory round trip and barrier a frame; the input's bytes in
// device memory halve at int16 and bfloat16. A row's last frame, which
// reads the halo and writes the tail, takes an EDGE path of its own
// (reg_ola_frame below), staged at every input type.

// The block's row index, read anew where it is used, through asm the
// compiler may not hoist: the halo and tail addresses are computed inside
// the branches that only a row's last frame takes, so that they hold no
// register across the passes (the kernel has none to spare: 128 a thread).
__device__ __forceinline__ int fresh_block_y() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(v));
  return v;
}

// The staging of a whole frame of planes (valid == N1) by 16-byte loads:
// each thread reads 16 / sizeof(E) consecutive values of each plane at once
// (four rounds a frame for int16 and bfloat16, eight for float32, where
// the scalar loop takes 32), times w_in, into the padded exchange buffer
__device__ __forceinline__ bool vector_aligned(const void* a, const void* b) {
  return ((reinterpret_cast<unsigned long long>(a) | reinterpret_cast<unsigned long long>(b)) &
          15) == 0;
}

template <int N1, int T, class E>
__device__ __forceinline__ void stage_vectors(float2* buf, const E* __restrict__ re,
                                              const E* __restrict__ im,
                                              const float2* __restrict__ w_in) {
  constexpr int V = 16 / sizeof(E);
  static_assert(N1 % (T * V) == 0, "whole rounds of 16-byte loads");
#pragma unroll 1
  for (int base = threadIdx.x * V; base < N1; base += T * V) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(re + base));
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(im + base));
    const E* rv = reinterpret_cast<const E*>(&r);
    const E* qv = reinterpret_cast<const E*>(&q);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float2 v = make_float2(to_float(rv[k]), to_float(qv[k]));
      buf[iqt::reg::pad(base + k)] = iqt::cmul(v, __ldg(&w_in[base + k]));
    }
  }
}

// Frame m of row b = blockIdx.y of the 2:1 chain: EDGE the row's last
// frame, which reads the halo past the row's end and
// stores its second half into the tail; every other frame without that
// code (its branches around the loads and stores cost the other frames 40 %
// of their time: 420 us against 299 at the flagship step).
template <int N1, int N2, int T, class E, bool EDGE>
__device__ __forceinline__ void reg_ola_frame(
    float2* smem, int m, const E* __restrict__ x, const E* __restrict__ halo, int n_halo,
    const float2* __restrict__ w_in, const float2* __restrict__ w_out,
    const float2* __restrict__ tw, float* __restrict__ y, float2* __restrict__ tail, int n_in,
    int n_out, int hop_in, int hop_out, int zero_lo, int zero_hi, int in_lo, int out_lo,
    int out_hi) {
  // m * hop_in < n_in and m * hop_out < n_out (the host sizes the grid)
  const int start = m * hop_in;
  const int valid = min(n_in - start, N1);
  const int room = min(n_out - m * hop_out, N2);
  const E* xf = x + static_cast<long long>(blockIdx.y) * Src<E>::kRows * n_in + start;
  float* yf = y + 2 * (static_cast<long long>(blockIdx.y) * n_out + m * hop_out);
  const auto load = [=](int i) {
    if constexpr (!EDGE) {
      return i < valid ? iqt::cmul(Src<E>::read(xf, Src<E>::imag(xf, n_in), i), __ldg(&w_in[i]))
                       : make_float2(0.f, 0.f);
    } else {
      float2 v = make_float2(0.f, 0.f);
      if (i < valid) {
        v = Src<E>::read(xf, Src<E>::imag(xf, n_in), i);
      } else if (i - valid < n_halo) {
        // the samples past the row's end, from the halo
        const E* hr = halo + static_cast<long long>(fresh_block_y()) * Src<E>::kRows * n_halo;
        v = Src<E>::read(hr, Src<E>::imag(hr, n_halo), i - valid);
      }
      return iqt::cmul(v, __ldg(&w_in[i]));
    }
  };
  const auto store = [=](int n, float2 v) {
    if (n < room) {
      atomicAdd(reinterpret_cast<float2*>(yf) + n, v);
    } else if constexpr (EDGE) {
      // the frame's second half past n_out: the row's tail
      if (tail != nullptr)
        tail[static_cast<long long>(fresh_block_y()) * (N2 - hop_out) + (n - room)] = v;
    }
  };
  if constexpr (Src<E>::kRows == 2 || EDGE) {
    // planes (two loads a point from two planes) and the edge frame (the
    // halo branch) leave pass 0 too few of the 128 registers a thread may
    // hold, and the passes spill; the windowed frame is staged into the
    // exchange buffer first, coalesced, and pass 0 reads it from there:
    // a whole frame of aligned planes by 16-byte loads (stage_vectors),
    // any other one sample at a time, two rounds of the loop in flight
    // (one or four, and some instance spills, by ptxas)
    bool staged = false;
    if constexpr (!EDGE) {
      if (valid == N1 && vector_aligned(xf, Src<E>::imag(xf, n_in))) {
        stage_vectors<N1, T>(smem, xf, Src<E>::imag(xf, n_in), w_in);
        staged = true;
      }
    }
    if (!staged) {
#pragma unroll 2
      for (int i = threadIdx.x; i < N1; i += T) smem[iqt::reg::pad(i)] = load(i);
    }
    reg_frame_chain<N1, N2, T, true>(smem, tw, w_out, zero_lo, zero_hi, in_lo, out_lo, out_hi,
                                     load, store);
  } else {
    reg_frame_chain<N1, N2, T>(smem, tw, w_out, zero_lo, zero_hi, in_lo, out_lo, out_hi, load,
                               store);
  }
}

template <int N1, int N2, int T, class E>
__global__ void __launch_bounds__(T, 1)
fused_ola_reg_kernel(const E* __restrict__ x, const E* __restrict__ halo, int n_halo,
                     const float2* __restrict__ w_in, const float2* __restrict__ w_out,
                     const float2* __restrict__ tw, float* __restrict__ y,
                     float2* __restrict__ tail, int n_in, int n_out, int hop_in, int hop_out,
                     int edge, int zero_lo, int zero_hi, int in_lo, int out_lo, int out_hi) {
  extern __shared__ float2 smem[];
  // with an edge, block 0 takes the row's last frame, so that its longer
  // path starts in the first wave and not alone after the others
  if (edge && blockIdx.x == 0) {
    reg_ola_frame<N1, N2, T, E, true>(smem, gridDim.x - 1, x, halo, n_halo, w_in, w_out, tw, y,
                                      tail, n_in, n_out, hop_in, hop_out, zero_lo, zero_hi,
                                      in_lo, out_lo, out_hi);
  } else {
    reg_ola_frame<N1, N2, T, E, false>(smem, blockIdx.x - edge, x, halo, n_halo, w_in, w_out,
                                       tw, y, tail, n_in, n_out, hop_in, hop_out, zero_lo,
                                       zero_hi, in_lo, out_lo, out_hi);
  }
}

// the 2:1 kernels' input layouts, by the code the host passes
// (ops/kernels/fused_ola.py LAYOUTS): F(code, element type)
#define IQT_LAYOUTS(F) \
  F(0, float2)         \
  F(1, float)          \
  F(2, short)          \
  F(3, __nv_bfloat16)

// every frame of the rows in one grid, in `layout`'s element type (any
// other layout: cudaErrorInvalidValue); with a halo or a tail, each row's
// last frame takes the EDGE path
template <int N1, int N2>
cudaError_t launch_reg(int layout, int n_frames, int batch, cudaStream_t stream, const void* x,
                       const void* halo, int n_halo, const float2* w_in, const float2* w_out,
                       const float2* tw, float* y, float2* tail, int n_in, int n_out,
                       int hop_in, int hop_out, int zero_lo, int zero_hi, int in_lo, int out_lo,
                       int out_hi) {
  const int edge = halo != nullptr || tail != nullptr;
#define IQT_REG(CODE, E)                                                                        \
  if (layout == CODE) {                                                                         \
    fused_ola_reg_kernel<N1, N2, 512, E><<<dim3(n_frames, batch), 512, RegShape<N1, N2>::smem,  \
                                           stream>>>(                                           \
        static_cast<const E*>(x), static_cast<const E*>(halo), n_halo, w_in, w_out, tw, y, tail, \
        n_in, n_out, hop_in, hop_out, edge, zero_lo, zero_hi, in_lo, out_lo, out_hi);          \
    return cudaGetLastError();                                                                  \
  }
  IQT_LAYOUTS(IQT_REG)
#undef IQT_REG
  return cudaErrorInvalidValue;
}

// allow the pair's 2:1 kernel of every layout its shared memory
template <int N1, int N2>
cudaError_t allow_reg() {
  cudaError_t err;
#define IQT_ALLOW_LAYOUT(CODE, E)                                                              \
  if ((err = iqt::allow_smem(fused_ola_reg_kernel<N1, N2, 512, E>, RegShape<N1, N2>::smem))) \
    return err;
  IQT_LAYOUTS(IQT_ALLOW_LAYOUT)
#undef IQT_ALLOW_LAYOUT
  return cudaSuccess;
}

// the compiled 2:1 pairs (ops/kernels/fused_ola.py OLA_REG_PAIRS): the
// flagship design's 16384 -> 8192, and hamming at 122.88 -> 61.44 MS/s and
// 122.88 -> 30.72 MS/s with min_fft_size=4095: 8192 -> 4096, 16384 ->
// 4096 (the 4096-point inverse leaves half of the 512 threads idle in each
// pass: 256 radix-16 butterflies)
#define IQT_OLA_REG_PAIRS(F) \
  F(16384, 8192)             \
  F(8192, 4096)              \
  F(16384, 4096)

}  // namespace

extern "C" int iqt_fused_ola_frames_prepare(int max_smem) {
  cudaError_t err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<1>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<2>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<4>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<8>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<16>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<32>, max_smem))) return err;
#define IQT_ALLOW_FRAMES_REG(N1, N2)                                                          \
  if ((err = iqt::allow_smem(fused_ola_frames_reg_kernel<N1, N2, 512>, RegShape<N1, N2>::smem))) \
    return err;
  IQT_FRAMES_REG_PAIRS(IQT_ALLOW_FRAMES_REG)
#undef IQT_ALLOW_FRAMES_REG
#define IQT_ALLOW(N1, N2, C)                                                              \
  if ((err = iqt::allow_smem(fused_ola_frames_cluster_kernel<N1, N2, C, kClusterThreads>, \
                             ClusterShape<N1, N2, C>::smem)))                             \
    return err;
  IQT_CLUSTER_PAIRS(IQT_ALLOW)
#undef IQT_ALLOW
  return cudaSuccess;
}

// the frame-batch chain at a pair of IQT_CLUSTER_PAIRS, by
// fused_ola_frames_cluster_kernel: arguments as for iqt_fused_ola_frames_reg,
// tw the n_tw entries of the pair's cluster table. Any other pair, or
// another table length: cudaErrorInvalidValue; a cluster the card refuses:
// the launch's own error.
extern "C" int iqt_fused_ola_frames_cluster(
    const void* x, long long batch_stride, long long frame_stride,
    const void* w_in, const void* w_out, const void* tw, void* y, int n_tw,
    int batch, int n_frames, int nfft, int nfft_out, int zero_lo, int zero_hi,
    int in_lo, int out_lo, int out_hi, void* stream) {
#define IQT_LAUNCH(N1, N2, C)                                                               \
  if (nfft == N1 && nfft_out == N2)                                                          \
    return launch_frames_cluster<N1, N2, C, kClusterThreads>(                                \
        batch, n_frames, static_cast<cudaStream_t>(stream), static_cast<const float2*>(x),   \
        batch_stride, frame_stride, static_cast<const float2*>(w_in),                        \
        static_cast<const float2*>(w_out), static_cast<const float2*>(tw), n_tw,             \
        static_cast<float2*>(y), zero_lo, zero_hi, in_lo, out_lo, out_hi);
  IQT_CLUSTER_PAIRS(IQT_LAUNCH)
#undef IQT_LAUNCH
  return cudaErrorInvalidValue;
}

// out[0] = the clusters of the pair's kernel the current device can hold
// at once (0: it cannot launch one); after iqt_fused_ola_frames_prepare
extern "C" int iqt_fused_ola_frames_cluster_occupancy(int nfft, int nfft_out, int* out) {
#define IQT_OCCUPANCY(N1, N2, C) \
  if (nfft == N1 && nfft_out == N2) return cluster_occupancy<N1, N2, C, kClusterThreads>(out);
  IQT_CLUSTER_PAIRS(IQT_OCCUPANCY)
#undef IQT_OCCUPANCY
  return cudaErrorInvalidValue;
}

// the frame-batch chain at a pair of IQT_FRAMES_REG_PAIRS, by
// fused_ola_frames_reg_kernel: frames and y as for iqt_fused_ola_frames;
// tw: the n_tw twiddle-table entries of the pair. Any other pair, or
// another table length: cudaErrorInvalidValue.
extern "C" int iqt_fused_ola_frames_reg(
    const void* x, long long batch_stride, long long frame_stride,
    const void* w_in, const void* w_out, const void* tw, void* y, int n_tw,
    int batch, int n_frames, int nfft, int nfft_out, int zero_lo, int zero_hi,
    int in_lo, int out_lo, int out_hi, void* stream) {
#define IQT_LAUNCH_FRAMES_REG(N1, N2)                                                          \
  if (nfft == N1 && nfft_out == N2)                                                            \
    return launch_frames_reg<N1, N2, 512>(                                                     \
        dim3(n_frames, batch), static_cast<cudaStream_t>(stream), static_cast<const float2*>(x), \
        batch_stride, frame_stride, static_cast<const float2*>(w_in),                          \
        static_cast<const float2*>(w_out), static_cast<const float2*>(tw), n_tw,               \
        static_cast<float2*>(y), n_frames, zero_lo, zero_hi, in_lo, out_lo, out_hi);
  IQT_FRAMES_REG_PAIRS(IQT_LAUNCH_FRAMES_REG)
#undef IQT_LAUNCH_FRAMES_REG
  return cudaErrorInvalidValue;
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
#define IQT_ALLOW(CODE, E)                                                                   \
  if ((err = iqt::allow_smem(fused_ola_kernel<1, E>, max_smem))) return err;                 \
  if ((err = iqt::allow_smem(fused_ola_kernel<2, E>, max_smem))) return err;                 \
  if ((err = iqt::allow_smem(fused_ola_kernel<4, E>, max_smem))) return err;                 \
  if ((err = iqt::allow_smem(fused_ola_kernel<8, E>, max_smem))) return err;                 \
  if ((err = iqt::allow_smem(fused_ola_kernel<16, E>, max_smem))) return err;
  IQT_LAYOUTS(IQT_ALLOW)
#undef IQT_ALLOW
#define IQT_ALLOW_REG(N1, N2) \
  if ((err = allow_reg<N1, N2>())) return err;
  IQT_OLA_REG_PAIRS(IQT_ALLOW_REG)
#undef IQT_ALLOW_REG
  return cudaSuccess;
}

// the 2:1 chain at a pair of IQT_OLA_REG_PAIRS, by fused_ola_reg_kernel:
// arguments as for iqt_fused_ola; tw: the n_tw twiddle-table entries of
// the pair (those of iqt_fused_ola_frames_reg's layout). Any other pair,
// layout or table length: cudaErrorInvalidValue.
extern "C" int iqt_fused_ola_reg(const void* x, int layout, const void* halo, int n_halo,
                                 const void* w_in, const void* w_out, const void* tw, void* y,
                                 void* tail, int n_tw, int batch, int n_in, int n_frames,
                                 int n_out, int nfft, int nfft_out, int hop_in, int hop_out,
                                 int zero_lo, int zero_hi, int in_lo, int out_lo, int out_hi,
                                 void* stream) {
#define IQT_REG_PAIR(N1, N2)                                                                     \
  if (nfft == N1 && nfft_out == N2) {                                                            \
    if (n_tw != RegShape<N1, N2>::tw_count) return cudaErrorInvalidValue;                        \
    return launch_reg<N1, N2>(layout, n_frames, batch, static_cast<cudaStream_t>(stream), x,     \
                              halo, n_halo, static_cast<const float2*>(w_in),                    \
                              static_cast<const float2*>(w_out), static_cast<const float2*>(tw), \
                              static_cast<float*>(y), static_cast<float2*>(tail), n_in, n_out,   \
                              hop_in, hop_out, zero_lo, zero_hi, in_lo, out_lo, out_hi);         \
  }
  IQT_OLA_REG_PAIRS(IQT_REG_PAIR)
#undef IQT_REG_PAIR
  return cudaErrorInvalidValue;
}

// x: (batch, n_in) complex64 (layout 0) or (batch, 2, n_in) planes of
// float32, int16 or bfloat16 (layouts 1-3); halo: n_halo samples a row in
// the same layout (nullptr and 0: zeros); y: (batch, n_out) complex64,
// zeroed by the caller; tail: (batch, nfft_out - hop_out) complex64, or
// nullptr to drop the last frame's dangling half. n_frames frames per row.
// Sizes are powers of two up to 16384.
extern "C" int iqt_fused_ola(const void* x, int layout, const void* halo, int n_halo,
                             const void* w_in, const void* tw_in, const void* w_out,
                             const void* tw_out, void* y, void* tail, int batch, int n_in,
                             int n_frames, int n_out, int log2_nfft, int log2_nfft_out,
                             int hop_in, int hop_out, int zero_lo, int zero_hi, int in_lo,
                             int out_lo, int out_hi, void* stream) {
  const int nmax = 1 << (log2_nfft > log2_nfft_out ? log2_nfft : log2_nfft_out);
  const size_t smem = static_cast<size_t>(nmax) * sizeof(float2);
  const int pt = (1 << log2_nfft_out) > kThreads ? (1 << log2_nfft_out) / kThreads : 1;
  const dim3 grid(n_frames, batch);
  auto s = static_cast<cudaStream_t>(stream);
  auto wi = static_cast<const float2*>(w_in);
  auto ti = static_cast<const float2*>(tw_in);
  auto wo = static_cast<const float2*>(w_out);
  auto to = static_cast<const float2*>(tw_out);
  auto yp = static_cast<float*>(y);
  auto tp = static_cast<float2*>(tail);
#define IQT_OLA(P, E)                                                                        \
  if (pt == P)                                                                               \
    return launch<P, E>(grid, smem, s, x, halo, n_halo, wi, ti, wo, to, yp, tp, n_in, n_out, \
                        log2_nfft, log2_nfft_out, hop_in, hop_out, zero_lo, zero_hi, in_lo,  \
                        out_lo, out_hi);
#define IQT_OLA_LAYOUT(CODE, E) \
  if (layout == CODE) {         \
    IQT_OLA(1, E)               \
    IQT_OLA(2, E)               \
    IQT_OLA(4, E)               \
    IQT_OLA(8, E)               \
    IQT_OLA(16, E)              \
  }
  IQT_LAYOUTS(IQT_OLA_LAYOUT)
#undef IQT_OLA_LAYOUT
#undef IQT_OLA
  return cudaErrorInvalidValue;
}
