// Fused OLA bandpass + rational resample, one block per OLA frame (one
// thread-block cluster per frame above one block's shared memory).
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
// block-wide barrier per radix-2 stage (27 stages per flagship frame); at
// the flagship pair fused_ola_reg_kernel below takes its place.
#include "fft.cuh"
#include "fft_cluster.cuh"
#include "fft_reg.cuh"

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

// ---- the frame-batch entry at its two main-path sizes -------------------
//
// Replaces the same TPU kernels as fused_ola_frames_kernel above
// (fused_ola_pallas.py fused_ola_pallas and fused_ola_packed), with the
// same contract, at the two size pairs its paths run: 16384 -> 8192
// (ola_filter / oaresample at BASELINE config #2) and 12288 -> 6144 (the
// monitor's blackman design, R = 3). Every other size keeps the generic
// kernel; the host route (ops/kernels/fused_ola.py frames_route) picks by
// size before the launch.
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

// The per-frame chain of the register-resident kernels, by a block of T
// threads: copy the RegShape tables (`tw`, built on the host from float64:
// ops/kernels/fused_ola.py reg_twiddles) into shared memory after the
// exchange buffer, the forward N1-point transform of load(i) (the frame
// sample i times w_in), the trim folded into the inverse's first load
// (output bin j reads forward bin in_lo + j - out_lo, masked by [zero_lo,
// zero_hi) and [out_lo, out_hi)), the inverse N2-point transform, and
// store(n, v) of each output sample times w_out[n] / N2, in natural order.
template <int N1, int N2, int T, class Load, class Store>
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
  R::fft<N1, false, T, false>(buf, tw_fwd, load, [buf](int i, float2 v) { buf[R::pad(i)] = v; });
  __syncthreads();
  R::fft<N2, true, T, true>(
      buf, tw_inv,
      [=](int j) {
        float2 v = make_float2(0.f, 0.f);
        if (j >= out_lo && j < out_hi) {
          const int k = in_lo + (j - out_lo);
          if (k >= zero_lo && k < zero_hi) v = buf[R::pad(k)];
        }
        return v;
      },
      [=](int n, float2 v) {
        store(n, iqt::cmul(make_float2(v.x * scale, v.y * scale), __ldg(&w_out[n])));
      });
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
// 24576 is 384 KiB, above an H100 block's 227 KiB. These are the monitor's
// frames at the blackman and blackmanharris designs of the flagship rates
// (R = 3 and 5, the grouped overlap-add in torch), of 122.88 -> 30.72 MS/s
// (98304 -> 24576 on C = 6 and 163840 -> 40960 on C = 10) and ola_filter's
// at such windows; the host route (ops/kernels/fused_ola.py frames_route)
// picks this kernel at the pairs it is compiled for (CLUSTER_PAIRS). The
// radix-6 and -10 steps are the prime-factor DFTs of csrc/fft.cuh; C = 10
// is above the portable cluster size of 8, so that instance opts in to a
// non-portable one (allow_cluster_size) before any occupancy query or
// launch.
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

// a cluster above the portable 8 blocks (C = 10) is refused at the launch
// and by cudaOccupancyMaxActiveClusters unless the kernel opts in
template <int C, typename Kernel>
cudaError_t allow_cluster_size(Kernel kernel) {
  if (C <= 8) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// the compiled pairs (ops/kernels/fused_ola.py CLUSTER_PAIRS): F(N1, N2, C)
#define IQT_CLUSTER_PAIRS(F) \
  F(49152, 24576, 3)         \
  F(81920, 40960, 5)         \
  F(40960, 20480, 5)         \
  F(40960, 40960, 5)         \
  F(32768, 8192, 2)          \
  F(32768, 16384, 2)         \
  F(36864, 12288, 3)         \
  F(98304, 24576, 6)         \
  F(163840, 40960, 10)

// ---- the 2:1 entry at the flagship pair ----------------------------------
//
// Replaces the same TPU kernel as fused_ola_kernel above
// (fused_ola_pallas.py fused_ola_strided), with the same contract, at the
// size pair the flagship monitor step runs: 16384 -> 8192 at 2:1 (the
// hamming COLA design). Every other pair keeps fused_ola_kernel; the host
// route (ops/kernels/fused_ola.py ola_route) picks by size before the
// launch.
//
// Per frame m of batch row b (block m, blockIdx.y = b): the chain of
// fused_ola_frames_reg_kernel (reg_frame_chain above) on the frame at
// x[b, m * hop_in], whose samples at and past the row's n_in read as zero
// (the 'extend' halo: pass 0 masks its load, coalesced, straight from
// device memory); the last pass overlap-adds each output sample into
// y[b, m * hop_out + n] with a float2 atomicAdd (one vector reduction
// per sample; compute capability 9.0 and CUDA 12.x) onto the zeroed y,
// dropping the samples at and past n_out (the last frame's dangling
// tail). Determinism: each float of the pair is added atomically on its
// own; at 2:1 overlap every output float receives exactly two
// contributions onto zero, and fl(0 + a + b) == fl(0 + b + a), so the
// result does not depend on the order in which blocks finish.
//
// Bound on an H100 (device memory: each input sample read once, each
// output written once, 8 B each): 201 MB, 0.0602 ms at 3.35 TB/s for the
// flagship step's 2048 frames on 2^24 samples; its FFT work (about
// 3.4e9 flop) is below that at 67 TFLOP/s.
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
template <int N1, int N2, int T>
__global__ void __launch_bounds__(T, 1)
fused_ola_reg_kernel(const float2* __restrict__ x, const float2* __restrict__ w_in,
                     const float2* __restrict__ w_out, const float2* __restrict__ tw,
                     float* __restrict__ y, int n_in, int n_out, int hop_in, int hop_out,
                     int zero_lo, int zero_hi, int in_lo, int out_lo, int out_hi) {
  extern __shared__ float2 smem[];
  const int m = blockIdx.x;
  // m * hop_in < n_in and m * hop_out < n_out (the host sizes the grid)
  const int start = m * hop_in;
  const int valid = min(n_in - start, N1);
  const int room = min(n_out - m * hop_out, N2);
  const float2* xf = x + static_cast<long long>(blockIdx.y) * n_in + start;
  float* yf = y + 2 * (static_cast<long long>(blockIdx.y) * n_out + m * hop_out);
  reg_frame_chain<N1, N2, T>(
      smem, tw, w_out, zero_lo, zero_hi, in_lo, out_lo, out_hi,
      [=](int i) {
        return i < valid ? iqt::cmul(xf[i], __ldg(&w_in[i])) : make_float2(0.f, 0.f);
      },
      [=](int n, float2 v) {
        if (n < room) atomicAdd(reinterpret_cast<float2*>(yf) + n, v);
      });
}

}  // namespace

extern "C" int iqt_fused_ola_frames_prepare(int max_smem) {
  cudaError_t err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<1>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<2>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<4>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<8>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<16>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<32>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_reg_kernel<16384, 8192, 512>,
                             RegShape<16384, 8192>::smem)))
    return err;
  if ((err = iqt::allow_smem(fused_ola_frames_reg_kernel<12288, 6144, 512>,
                             RegShape<12288, 6144>::smem)))
    return err;
#define IQT_ALLOW(N1, N2, C)                                                              \
  if ((err = iqt::allow_smem(fused_ola_frames_cluster_kernel<N1, N2, C, kClusterThreads>, \
                             ClusterShape<N1, N2, C>::smem)))                             \
    return err;                                                                           \
  if ((err = allow_cluster_size<C>(fused_ola_frames_cluster_kernel<N1, N2, C, kClusterThreads>))) \
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

// the frame-batch chain at (nfft, nfft_out) = (16384, 8192) or (12288,
// 6144), by fused_ola_frames_reg_kernel: frames and y as for
// iqt_fused_ola_frames; tw: the n_tw twiddle-table entries of the pair.
// Any other pair, or another table length: cudaErrorInvalidValue.
extern "C" int iqt_fused_ola_frames_reg(
    const void* x, long long batch_stride, long long frame_stride,
    const void* w_in, const void* w_out, const void* tw, void* y, int n_tw,
    int batch, int n_frames, int nfft, int nfft_out, int zero_lo, int zero_hi,
    int in_lo, int out_lo, int out_hi, void* stream) {
  const dim3 grid(n_frames, batch);
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float2*>(x);
  auto wi = static_cast<const float2*>(w_in);
  auto wo = static_cast<const float2*>(w_out);
  auto tp = static_cast<const float2*>(tw);
  auto yp = static_cast<float2*>(y);
  if (nfft == 16384 && nfft_out == 8192)
    return launch_frames_reg<16384, 8192, 512>(grid, s, xp, batch_stride, frame_stride, wi, wo,
                                               tp, n_tw, yp, n_frames, zero_lo, zero_hi, in_lo,
                                               out_lo, out_hi);
  if (nfft == 12288 && nfft_out == 6144)
    return launch_frames_reg<12288, 6144, 512>(grid, s, xp, batch_stride, frame_stride, wi, wo,
                                               tp, n_tw, yp, n_frames, zero_lo, zero_hi, in_lo,
                                               out_lo, out_hi);
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
  if ((err = iqt::allow_smem(fused_ola_kernel<1>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_kernel<2>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_kernel<4>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_kernel<8>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_kernel<16>, max_smem))) return err;
  return iqt::allow_smem(fused_ola_reg_kernel<16384, 8192, 512>, RegShape<16384, 8192>::smem);
}

// the 2:1 chain at (nfft, nfft_out) = (16384, 8192), by
// fused_ola_reg_kernel: x, y and the bounds as for iqt_fused_ola; tw: the
// n_tw twiddle-table entries of the pair (those of
// iqt_fused_ola_frames_reg). Any other pair, or another table length:
// cudaErrorInvalidValue.
extern "C" int iqt_fused_ola_reg(const void* x, const void* w_in, const void* w_out,
                                 const void* tw, void* y, int n_tw, int batch, int n_in,
                                 int n_frames, int n_out, int nfft, int nfft_out, int hop_in,
                                 int hop_out, int zero_lo, int zero_hi, int in_lo, int out_lo,
                                 int out_hi, void* stream) {
  if (nfft != 16384 || nfft_out != 8192 || n_tw != RegShape<16384, 8192>::tw_count)
    return cudaErrorInvalidValue;
  fused_ola_reg_kernel<16384, 8192, 512>
      <<<dim3(n_frames, batch), 512, RegShape<16384, 8192>::smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float2*>(x), static_cast<const float2*>(w_in),
          static_cast<const float2*>(w_out), static_cast<const float2*>(tw),
          static_cast<float*>(y), n_in, n_out, hop_in, hop_out, zero_lo, zero_hi, in_lo, out_lo,
          out_hi);
  return cudaGetLastError();
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
