// The frame-batch OLA kernels (rows 2-3 of the port's kernel table) and the
// pieces the 2:1 kernels of csrc/fused_ola.cu share with them: the input
// loader of every storage tier (Src) and the register-resident per-frame
// chain (reg_frame_chain).
//
// Each kernel is a template on E, the element type of the frames it reads
// (Src below): interleaved complex64 (E = float2), or (2, n) planes of
// float32, int16 or bfloat16, dequantized on load. The host launchers
// (frames_generic, frames_reg, frames_plan, frames_plan_cluster,
// frames_cluster) are templates on E too; csrc/fused_ola.cu calls them
// through its C entries and takes every element type's from a source of
// its own, csrc/fused_ola_c64.cu, fused_ola_f32.cu, fused_ola_i16.cu and
// fused_ola_bf16.cu (IQT_FRAMES_INSTANCES), so that nvcc compiles the four
// element types and the 2:1 kernels in parallel.
#pragma once

#include <cuda_bf16.h>

#include "fft.cuh"
#include "fft_cluster.cuh"
#include "fft_plan.cuh"
#include "fft_reg.cuh"

namespace iqt {
namespace ola {

// ---- the input of every OLA kernel ---------------------------------------
//
// Src<E> reads sample i of a frame or row whose elements are of type E:
// (2, n) planes of float32, int16 or bfloat16 (the real plane, then the
// imaginary plane `plane` elements further: imag(p, plane) points there),
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
  __device__ static const E* imag(const E* p, long long plane) { return p + plane; }
  __device__ static float2 read(const E* __restrict__ re, const E* __restrict__ im, int i) {
    return make_float2(to_float(re[i]), to_float(im[i]));
  }
};
template <>
struct Src<float2> {
  static constexpr int kRows = 1;
  __device__ static const float2* imag(const float2* p, long long) { return p; }
  __device__ static float2 read(const float2* __restrict__ p, const float2*, int i) {
    return p[i];
  }
};

// ---- a row's end and the halo past it -------------------------------------
//
// Edge<E> lets a frame kernel read its frames straight from rows of n_in
// samples, frame m of row b starting at sample m frame_stride of the row
// (the 2:1 route of ops/kernels/fused_ola.py reads every frame of a row at
// hop_in = nfft / 2 so, the last one reaching hop_in samples past the
// row's end): the samples at and past n_in come from the row's halo (n_halo
// samples at halo + b halo_batch, the next chunk's or shard's head; its
// imaginary plane halo_plane elements further), zeros after it, as
// csrc/fused_ola.cu frame_sample reads them for the older 2:1 kernels.
// n_in = 0: no edge, every frame lies inside its row (the launches of
// fused_ola_frames and ola_filter), and the kernels load as they did.
template <class E>
struct Edge {
  const E* halo;
  long long halo_batch, halo_plane;
  int n_in, n_halo;
  // whether the n-sample frame starting at sample `start` of its row reaches
  // past the row's end (block-uniform: one test a frame)
  __device__ bool reaches(long long start, long long n) const {
    return n_in > 0 && start + n > n_in;
  }
  // sample i of the frame at xf (its imaginary plane at xi) that starts at
  // sample `start` of row b
  __device__ float2 read(const E* __restrict__ xf, const E* __restrict__ xi, long long start,
                         int i, int b) const {
    const long long p = start + i;
    if (p < n_in) return Src<E>::read(xf, xi, i);
    const long long h = p - n_in;
    if (h >= n_halo) return make_float2(0.f, 0.f);
    const E* hr = halo + b * halo_batch;
    return Src<E>::read(hr, Src<E>::imag(hr, halo_plane), static_cast<int>(h));
  }
};

// The staging of a whole frame of planes by 16-byte loads: each thread
// reads 16 / sizeof(E) consecutive values of each plane at once (four
// rounds a 16384-point frame for int16 and bfloat16, eight for float32,
// where the scalar loop takes 32), times w_in, into the padded exchange
// buffer
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

// The windowed frame of planes at (re, im) into the padded exchange
// buffer: by 16-byte loads where both planes are aligned, else one sample a
// thread at a time, two rounds of the loop in flight
template <int N1, int T, class E>
__device__ __forceinline__ void stage_planes(float2* buf, const E* __restrict__ re,
                                             const E* __restrict__ im,
                                             const float2* __restrict__ w_in) {
  if (vector_aligned(re, im)) {
    stage_vectors<N1, T>(buf, re, im, w_in);
    return;
  }
#pragma unroll 2
  for (int i = threadIdx.x; i < N1; i += T)
    buf[iqt::reg::pad(i)] = iqt::cmul(Src<E>::read(re, im, i), __ldg(&w_in[i]));
}

// ---- the frame-batch entry --------------------------------------------
//
// Replaces: iqwaveform_tpu/ops/pallas/fused_ola_pallas.py fused_ola_pallas
//   ((M, nfft) complex frames, stored as float32, int16 or bfloat16 planes
//   -> (M, nfft_out) complex64) and fused_ola_packed (the same per-frame
//   chain on float32, int16 or bfloat16 planes, which the monitor's grouped
//   overlap-add at R = nfft / hop > 2 runs).
//
// One block per frame (blockIdx.x = m, blockIdx.y = batch row b): frame
// (b, m) starts at x + b * batch_stride + m * frame_stride (its imaginary
// plane `plane_stride` elements further, for planes), so the same kernel
// takes a contiguous (M, nfft) batch or a strided view of a capture
// (frame_stride = hop) without a copy of the frames. The chain is that of
// the 2:1 fused_ola_kernel (csrc/fused_ola.cu), on the mixed-radix FFT of
// fft.cuh (sizes 2^a 3^b 5^c 7^d): times w_in, forward FFT, the [zero_lo,
// zero_hi) mask, the copy of [in_lo, ...) to [out_lo, out_hi) of an
// nfft_out-bin spectrum, inverse FFT, times w_out / nfft_out. Each frame is
// written whole to y[b, m, :]; there are no atomics. The overlap-add of R
// frames per output sample stays outside, as a sum of R groups in a fixed
// order (float atomics are order-independent for two contributions only).
//
// What bounds it on an H100: memory. At BASELINE config #2 (16384 -> 8192
// on 10^8 samples) it must read the capture once (0.8 GB) and write every
// frame's nfft_out outputs (0.8 GB): about 0.48 ms at 3.35 TB/s, while
// the FFT work (~2.1e10 flop) takes 0.31 ms at 67 TFLOP/s. At 2:1 the
// overlapping frames read each sample twice, mostly from L2. As in the 2:1
// kernel, the frame stays in shared memory from load to store; this simple
// version pays a barrier and a shared-memory round trip per radix-4/2/3/5/7
// stage (8 stages for the 16384 -> 8192 pair) and a host-built permutation
// table for the digit-reversed load. It took 1.2-2x the torch.fft chain's
// time at every one-block pair it ran (PERF.md), and since the plan kernel
// (frames up to 16384 points), the two-block plan kernel below (the even
// one-block frames above) and the split route (one-block frames above 8192
// points whose forward transform splits) it routes only where none of the
// others holds the pair (sizes of one pass of radix 2-7, odd sizes above
// 16384 points: ops/kernels/fused_ola.py frames_route 'generic'; a prime
// factor above 7, which it has no pass for, takes the plan kernels' prime
// pass or the split route); elsewhere it is the yardstick of the others
// (_fused_ola_frames_generic).
constexpr int kFrameThreads = 1024;

template <int PT, class E>
__global__ void __launch_bounds__(kFrameThreads, 1)
fused_ola_frames_kernel(const E* __restrict__ x, long long batch_stride, long long frame_stride,
                        long long plane_stride, Edge<E> edge, const float2* __restrict__ w_in,
                        const float2* __restrict__ tw_in, const int* __restrict__ perm_in,
                        const float2* __restrict__ w_out, const float2* __restrict__ tw_out,
                        const int* __restrict__ perm_out, float2* __restrict__ y, int n_frames,
                        iqt::FftPlan plan_in, iqt::FftPlan plan_out, int zero_lo, int zero_hi,
                        int in_lo, int out_lo, int out_hi) {
  extern __shared__ float2 buf[];
  const int nfft = plan_in.n;
  const int nfft_out = plan_out.n;
  const int m = blockIdx.x;
  const long long start = m * frame_stride;
  const E* xf = x + blockIdx.y * batch_stride + start;
  const E* xi = Src<E>::imag(xf, plane_stride);

  if (edge.reaches(start, nfft)) {
    for (int n = threadIdx.x; n < nfft; n += blockDim.x)
      buf[__ldg(&perm_in[n])] = iqt::cmul(edge.read(xf, xi, start, n, blockIdx.y), w_in[n]);
  } else {
    for (int n = threadIdx.x; n < nfft; n += blockDim.x) {
      buf[__ldg(&perm_in[n])] = iqt::cmul(Src<E>::read(xf, xi, n), w_in[n]);
    }
  }
  iqt::fft_mixed(buf, tw_in, plan_in, false);

  float2 z[PT];
#pragma unroll
  for (int r = 0; r < PT; ++r) {
    const int j = threadIdx.x + r * kFrameThreads;
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
    const int j = threadIdx.x + r * kFrameThreads;
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

// ---- the frame-batch entry at its main-path sizes ------------------------
//
// Replaces the same TPU kernels as fused_ola_frames_kernel above
// (fused_ola_pallas.py fused_ola_pallas and fused_ola_packed), with the
// same contract, at the size pairs its paths run: 16384 -> 8192
// (ola_filter / oaresample at BASELINE config #2), 12288 -> 6144 (the
// monitor's blackman design, R = 3) and 12288 -> 4096 (hamming at 122.88 ->
// 40.96 MS/s, min_fft_size=4095). Every other one-block pair takes the plan
// kernel below (the same chain on a plan chosen at run time), the generic
// kernel only where that does not hold the pair; the host route
// (ops/kernels/fused_ola.py frames_route) picks by size before the launch.
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
//
// The plane instances (float32, int16, bfloat16) stage the windowed frame
// into the exchange buffer first (stage_planes, 16-byte loads where both
// planes are aligned) and pass 0 reads it back after a barrier, as the 2:1
// kernel's plane instances do: two loads a point from two planes leave
// pass 0 too few registers. One more shared-memory round trip and barrier
// a frame; half the input's bytes at int16 and bfloat16.
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
template <int N1, int N2, int T, class E>
__global__ void __launch_bounds__(T, 1)
fused_ola_frames_reg_kernel(const E* __restrict__ x, long long batch_stride,
                            long long frame_stride, long long plane_stride, Edge<E> edge,
                            const float2* __restrict__ w_in, const float2* __restrict__ w_out,
                            const float2* __restrict__ tw, float2* __restrict__ y, int n_frames,
                            int zero_lo, int zero_hi, int in_lo, int out_lo, int out_hi) {
  extern __shared__ float2 smem[];
  const int m = blockIdx.x;
  const long long start = m * frame_stride;
  const E* xf = x + blockIdx.y * batch_stride + start;
  float2* yf = y + (static_cast<long long>(blockIdx.y) * n_frames + m) * N2;
  const auto store = [yf](int n, float2 v) { yf[n] = v; };
  const auto staged = [](int) { return make_float2(0.f, 0.f); };
  // a frame past its row's end (the halo's) is staged through the exchange
  // buffer at every input type, as the 2:1 kernel's edge frame is: the
  // branch in the load leaves pass 0 too few registers
  const auto stage_edge = [&] {
    const E* xi = Src<E>::imag(xf, plane_stride);
#pragma unroll 2
    for (int i = threadIdx.x; i < N1; i += T)
      smem[iqt::reg::pad(i)] = iqt::cmul(edge.read(xf, xi, start, i, blockIdx.y), __ldg(&w_in[i]));
  };
  if constexpr (Src<E>::kRows == 2) {
    if (edge.reaches(start, N1)) {
      stage_edge();
    } else {
      stage_planes<N1, T>(smem, xf, Src<E>::imag(xf, plane_stride), w_in);
    }
    reg_frame_chain<N1, N2, T, true>(smem, tw, w_out, zero_lo, zero_hi, in_lo, out_lo, out_hi,
                                     staged, store);
  } else if (edge.reaches(start, N1)) {
    stage_edge();
    reg_frame_chain<N1, N2, T, true>(smem, tw, w_out, zero_lo, zero_hi, in_lo, out_lo, out_hi,
                                     staged, store);
  } else {
    reg_frame_chain<N1, N2, T>(
        smem, tw, w_out, zero_lo, zero_hi, in_lo, out_lo, out_hi,
        [xf, w_in](int i) { return iqt::cmul(xf[i], __ldg(&w_in[i])); }, store);
  }
}

// ---- the frame-batch entry on a plan chosen at run time -------------------
//
// Replaces the same TPU kernels as fused_ola_frames_kernel above
// (fused_ola_pallas.py fused_ola_pallas and fused_ola_packed), with the
// same contract, at every one-block pair that REG_PAIRS, CLUSTER_PAIRS and
// the split route do not take and whose frames it holds (ops/kernels/
// fused_ola.py plan_takes, frames_route 'plan'; at 2:1 'plan+add', the
// frames then overlap-added by csrc/ola_add.cu): the chain of
// fused_ola_frames_reg_kernel on the passes of csrc/fft_plan.cuh, whose
// plan (radices, NS, the odd passes' multipliers, table offsets) the host
// builds per size pair and passes as one __grid_constant__ FramePlan, so
// that one instance per element type covers every such pair: sizes of any
// factors, each prime above 7 a pass of O(p) a point (fft_plan.cuh
// pass_prime; 1408 = 11 x 128, 13750 = 2 x 5^4 x 11, and an output of one
// prime pass, 1408 -> 11).
//
// What held the generic kernel back is what fused_ola_frames_reg_kernel
// above does away with, and this kernel does the same at sizes fixed only
// at run time: register-resident radix-16 passes, two barriers a pass, the
// exchange padded one float2 in 16, small twiddle tables in shared memory,
// no permutation, no integer division (masks, and a multiply-shift at the
// odd passes). Unlike the register kernel, every pass reads and writes
// shared memory only: the frame is staged first (coalesced, times w_in),
// the trim is the inverse's first load, and y is written from the buffer
// after the last pass (coalesced, times w_shift_out / nfft_out). That costs
// two more round trips through shared memory and barriers a frame, and
// buys passes whose points share one array of registers (csrc/fft_plan.cuh
// pass_r) and one loader and storer: with a pass body for each loader and
// storer (device memory, the trim) inlined into the switch, ptxas spilled
// every radix's array to the stack and each source's build took minutes.
//
// Frames a block: a frame takes a group of G lanes (G a power of two from
// 32 to 512, the least with max(N1, N2) <= 32 G) and its own barrier
// (__syncwarp for one warp, else the named barrier 1 + its index), and the
// block's 512 threads take up to 512 / G frames, as many as its shared
// memory holds: 16 frames of 1024 points, one of 16384. A thread holds at
// most 32 points (kPlanPoints), which leaves a radix-16 DFT its registers
// within the 128 a thread has at 512 threads: frames of 16384 points and
// below (ops/kernels/fused_ola.py plan_takes). At 40, 44 and 48 points a
// thread (a wider instance of radix 8 at most) ptxas spilled; the one-block
// frames above (18432-28672 points) run a half a block on two blocks,
// fused_ola_frames_plan_cluster_kernel below.
//
// Bound on an H100: as fused_ola_frames_reg_kernel's, device memory (8 B a
// point in and out at complex64). Fixed-order arithmetic, plain stores, no
// atomics: the output does not depend on block order.
struct FramePlan {
  iqt::plan::Transform fwd, inv;
  int tw_count;  // float2 of both transforms' tables, forward then inverse
  int group;     // lanes a frame
  int frames;    // frames a block
  int buf;       // float2 of a frame's exchange buffer
};

constexpr int kPlanThreads = 512;
constexpr int kPlanPoints = 32;

// the windowed frame of planes at (re, im), n points, by the group's lanes
// into the padded exchange buffer: by 16-byte loads where both planes are
// aligned and n is whole vectors, else one sample a lane at a time
template <class E>
__device__ __forceinline__ void stage_group(float2* buf, const E* __restrict__ re,
                                            const E* __restrict__ im,
                                            const float2* __restrict__ w_in, int n, int lane,
                                            int group) {
  constexpr int V = 16 / sizeof(E);
  if (n % V == 0 && vector_aligned(re, im)) {
#pragma unroll 1
    for (int base = lane * V; base < n; base += group * V) {
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
    return;
  }
#pragma unroll 2
  for (int i = lane; i < n; i += group)
    buf[iqt::reg::pad(i)] = iqt::cmul(Src<E>::read(re, im, i), __ldg(&w_in[i]));
}

// blockIdx.x = the block's run of plan.frames frames, blockIdx.y = batch
// row b; frames addressed as in fused_ola_frames_kernel, each written whole
// to y[b, m, :]. Shared memory: both transforms' tables, then one exchange
// buffer a frame. A frame's group stages the windowed frame into its
// buffer (coalesced: complex64 straight, planes by 16-byte loads where
// aligned, a frame past its row's end through Edge), runs the forward
// passes and the inverse passes there (the trim in the inverse's first
// load), and writes y in natural order times w_shift_out / nfft_out
// (coalesced): every pass reads and writes shared memory only.
template <class E>
__global__ void __launch_bounds__(kPlanThreads, 1)
fused_ola_frames_plan_kernel(const E* __restrict__ x, long long batch_stride,
                             long long frame_stride, long long plane_stride, Edge<E> edge,
                             const float2* __restrict__ w_in, const float2* __restrict__ w_out,
                             const float2* __restrict__ tw, float2* __restrict__ y, int n_frames,
                             int zero_lo, int zero_hi, int in_lo, int out_lo, int out_hi,
                             const __grid_constant__ FramePlan plan) {
  namespace P = iqt::plan;
  namespace R = iqt::reg;
  extern __shared__ float2 smem[];
  for (int e = threadIdx.x; e < plan.tw_count; e += kPlanThreads) smem[e] = __ldg(&tw[e]);
  __syncthreads();
  const int group = plan.group;
  const int g = threadIdx.x / group;
  const int lane = threadIdx.x - g * group;
  const int m = blockIdx.x * plan.frames + g;
  // a group with no frame leaves: every later barrier is its own group's
  if (g >= plan.frames || m >= n_frames) return;
  float2* buf = smem + plan.tw_count + g * plan.buf;
  const int n1 = plan.fwd.n, n2 = plan.inv.n;
  const long long start = m * frame_stride;
  const E* xf = x + blockIdx.y * batch_stride + start;
  const E* xi = Src<E>::imag(xf, plane_stride);

  if (edge.reaches(start, n1)) {
#pragma unroll 2
    for (int i = lane; i < n1; i += group)
      buf[R::pad(i)] = iqt::cmul(edge.read(xf, xi, start, i, blockIdx.y), __ldg(&w_in[i]));
  } else if constexpr (Src<E>::kRows == 2) {
    stage_group<E>(buf, xf, xi, w_in, n1, lane, group);
  } else {
#pragma unroll 4
    for (int i = lane; i < n1; i += group) buf[R::pad(i)] = iqt::cmul(xf[i], __ldg(&w_in[i]));
  }
  P::group_sync(group, g);
  const P::Trim trim{zero_lo, zero_hi, in_lo, out_lo, out_hi};
  P::fft<false, kPlanPoints, false>(plan.fwd, buf, smem, trim, lane, group, g);
  P::fft<true, kPlanPoints, true>(plan.inv, buf, smem, trim, lane, group, g);

  const float scale = 1.0f / static_cast<float>(n2);
  float2* yf = y + (static_cast<long long>(blockIdx.y) * n_frames + m) * n2;
#pragma unroll 4
  for (int n = lane; n < n2; n += group) {
    const float2 v = buf[R::pad(n)];
    yf[n] = iqt::cmul(make_float2(v.x * scale, v.y * scale), __ldg(&w_out[n]));
  }
}

// ---- the frame-batch entry on a plan chosen at run time, one frame on a
// ---- two-block cluster
//
// Replaces the same TPU kernels as fused_ola_frames_kernel above
// (fused_ola_pallas.py fused_ola_pallas and fused_ola_packed), with the
// contract of fused_ola_frames_plan_kernel, at the one-block pairs whose
// frames that kernel does not hold (above 16384 points) and where
// REG_PAIRS, CLUSTER_PAIRS and the split route do not take the pair (of the
// monitor's, 19200 -> 5120, 20480 -> 20480 and 24576 -> 24576; halves with
// a prime above 7 through the same prime pass, 16768 = 2 x 64 x 131 and
// 16896 -> 8448 = 2^8 3 11 among them; the split
// route, faster, takes the pairs whose forward transform splits, such as
// 20480 -> 10240 and 25600 -> 5120: PERF.md) (ops/kernels/fused_ola.py
// plan_cluster_takes, frames_route 'plan_cluster'; at 2:1
// 'plan_cluster+add', the frames then overlap-added by csrc/ola_add.cu).
//
// One frame of N1 points runs on a thread-block cluster of two blocks
// (cudaLaunchKernelEx with a cluster dimension of 2; blockIdx.x = 2 m +
// rank), each holding M1 = N1 / 2, then M2 = N2 / 2 points in its own padded
// exchange buffer, on the run-time plan passes of csrc/fft_plan.cuh (the
// radix-2 split as csrc/fft_cluster.cuh sets it out for C blocks):
//   1. the pass tables into shared memory; cluster barrier: every block has
//      begun;
//   2. the forward radix-2 step: block `rank` owns the offsets n of its half
//      of [0, M1): it reads samples n and M1 + n times w_in, coalesced (a
//      value of each plane, for planes; a frame past its row's end through
//      Edge), and stores their sum at n in block 0's buffer and their
//      difference times exp(-2 pi i n / N1) at n in block 1's;  cluster
//      barrier;
//   3. block r's M1-point forward plan passes in its buffer: bins 2 k + r;
//      cluster barrier;
//   4. block r's M2-point inverse plan passes, the first of which reads the
//      trim (cluster::ClusterTrim: inverse bin 2 i + r is a forward bin of one
//      block, at a fixed offset from i, for i in one range) from that
//      block's buffer, with the cluster's barrier between its reads and its
//      writes;  cluster barrier;
//   5. the inverse radix-2 step: block `rank` owns the offsets n of its half
//      of [0, M2): u = point n of block 0, v = point n of block 1 times
//      exp(+2 pi i n / N2); it writes y[n] = u + v and y[M2 + n] = u - v,
//      times w_shift_out / N2, coalesced;  cluster barrier, so that no block
//      exits while the other reads its buffer.
// The cross twiddles come from the host's table (built in float64, rounded
// once to float32) and are read from device memory (L2), consecutive
// threads reading consecutive entries; the pass tables sit in shared memory
// before the buffer, as in the plan kernel.
//
// What this buys over the plan kernel: a half of at most 16384 points on
// 512 lanes at kPlanPoints a lane, so frames up to 32768 points (one block's
// shared memory holds 29056); and where both halves are at most 8192 points
// the blocks take 256 lanes, so that two blocks (two barrier domains) share
// an SM within its 65536 registers (128 a thread) and its shared memory,
// where the plan kernel runs one 512-lane frame at a time per SM above 8192
// points. Two blocks of 256 lanes hold as many warps as one of 512, though:
// at 9216 -> 3072 the one-block plan kernel stayed the faster (PERF.md), so
// the route takes the plan kernel wherever it holds the pair. What it
// costs: the radix-2 steps through distributed shared memory and five
// cluster barriers a frame.
//
// Bound on an H100: as fused_ola_frames_plan_kernel's, device memory (8 B a
// point in and out at complex64). Fixed-order arithmetic, plain stores, no
// atomics: the output does not depend on block order.
struct ClusterPlan {
  iqt::plan::Transform fwd, inv;  // the halves: M1 = N1 / 2, M2 = N2 / 2 points
  int tw_count;   // float2 of both halves' pass tables, forward then inverse
  int fwd_cross;  // offset of exp(-2 pi i n / N1), n < M1, in the host's table
  int inv_cross;  // offset of exp(+2 pi i n / N2), n < M2
  int group;      // threads a block: 256 or 512 (G)
  int buf;        // float2 of a block's exchange buffer
};

constexpr int kPlanCluster = 2;

// G, the threads of a block, is a template argument (256 or 512): with G
// read from the plan at run time ptxas spilled 16-36 bytes a thread in the
// passes, with G a constant none
template <int G, class E>
__global__ void __launch_bounds__(kPlanThreads, 1)
fused_ola_frames_plan_cluster_kernel(const E* __restrict__ x, long long batch_stride,
                                     long long frame_stride, long long plane_stride,
                                     Edge<E> edge, const float2* __restrict__ w_in,
                                     const float2* __restrict__ w_out,
                                     const float2* __restrict__ tw, float2* __restrict__ y,
                                     int n_frames, int zero_lo, int zero_hi, int in_lo,
                                     int out_lo, int out_hi,
                                     const __grid_constant__ ClusterPlan plan) {
  namespace P = iqt::plan;
  namespace R = iqt::reg;
  namespace CL = iqt::cluster;
  extern __shared__ float2 smem[];
  CL::cg::cluster_group cluster = CL::cg::this_cluster();
  float2* buf = smem + plan.tw_count;
  constexpr int group = G;

  // 1. the pass tables, read after the barriers below; every block begun
  for (int e = threadIdx.x; e < plan.tw_count; e += group) smem[e] = __ldg(&tw[e]);
  cluster.sync();

  // 2. the forward radix-2 step over this block's half of the offsets
  {
    const int rank = CL::fresh_rank();
    const int m1 = plan.fwd.n;
    const int m = CL::fresh_block_x() / kPlanCluster;
    const long long start = m * frame_stride;
    const E* xf = x + blockIdx.y * batch_stride + start;
    const E* xi = Src<E>::imag(xf, plane_stride);
    const float2* cross = tw + plan.fwd_cross;
    const unsigned sum = CL::map_addr(buf, 0), diff = CL::map_addr(buf, 1);
    const auto forward = [&](auto read) {
      for (int n = CL::slice_lo(m1, rank, kPlanCluster) + threadIdx.x;
           n < CL::slice_lo(m1, rank + 1, kPlanCluster); n += group) {
        const float2 a = iqt::cmul(read(n), __ldg(&w_in[n]));
        const float2 b = iqt::cmul(read(m1 + n), __ldg(&w_in[m1 + n]));
        const unsigned at = static_cast<unsigned>(R::pad(n) * sizeof(float2));
        CL::st_remote(sum + at, make_float2(a.x + b.x, a.y + b.y));
        CL::st_remote(diff + at,
                      iqt::cmul(make_float2(a.x - b.x, a.y - b.y), __ldg(&cross[n])));
      }
    };
    if (edge.reaches(start, 2 * m1)) {
      forward([&](int i) { return edge.read(xf, xi, start, i, blockIdx.y); });
    } else {
      forward([&](int i) { return Src<E>::read(xf, xi, i); });
    }
  }
  cluster.sync();

  // 3. the M1-point forward passes in this block's buffer (a block is one
  // group of lanes: its barrier is the block's)
  const auto block_sync = [] { __syncthreads(); };
  P::fft<false, kPlanPoints, false>(plan.fwd, buf, smem, P::Trim{}, threadIdx.x, group,
                                    block_sync, block_sync);
  cluster.sync();

  // 4. the M2-point inverse passes, the first reading the trim from the
  // block that holds each bin, the cluster's barrier before its stores
  {
    const CL::ClusterTrim trim = CL::cluster_trim(zero_lo, zero_hi, in_lo, out_lo, out_hi,
                                                  CL::fresh_rank(), plan.inv.n, buf);
    P::fft<true, kPlanPoints, true>(plan.inv, buf, smem, trim, threadIdx.x, group,
                                    [] { CL::cg::this_cluster().sync(); }, block_sync);
  }
  cluster.sync();

  // 5. the inverse radix-2 step over this block's half, scaled, windowed
  {
    const int rank = CL::fresh_rank();
    const int m2 = plan.inv.n;
    const int m = CL::fresh_block_x() / kPlanCluster;
    const float scale = 1.0f / static_cast<float>(2 * m2);
    const float2* cross = tw + plan.inv_cross;
    const unsigned lo = CL::map_addr(buf, 0), hi = CL::map_addr(buf, 1);
    float2* yf = y + (static_cast<long long>(blockIdx.y) * n_frames + m) * (2 * m2);
    for (int n = CL::slice_lo(m2, rank, kPlanCluster) + threadIdx.x;
         n < CL::slice_lo(m2, rank + 1, kPlanCluster); n += group) {
      const unsigned at = static_cast<unsigned>(R::pad(n) * sizeof(float2));
      const float2 u = CL::ld_remote(lo + at);
      const float2 v = iqt::cmul(CL::ld_remote(hi + at), __ldg(&cross[n]));
      yf[n] = iqt::cmul(make_float2((u.x + v.x) * scale, (u.y + v.y) * scale), __ldg(&w_out[n]));
      yf[m2 + n] = iqt::cmul(make_float2((u.x - v.x) * scale, (u.y - v.y) * scale),
                             __ldg(&w_out[m2 + n]));
    }
  }
  cluster.sync();
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
//      coalesced (two values a sample from two planes, for planes), takes
//      their C-point DFT in registers, and stores output r times
//      exp(-2 pi i r n / N1) at n in block r's buffer;  cluster barrier;
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

template <int N1, int N2, int C, int T, class E>
__global__ void __launch_bounds__(T, 1)
fused_ola_frames_cluster_kernel(const E* __restrict__ x, long long batch_stride,
                                long long frame_stride, long long plane_stride, Edge<E> edge,
                                const float2* __restrict__ w_in, const float2* __restrict__ w_out,
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
  const long long start = m * frame_stride;
  const E* xf = x + blockIdx.y * batch_stride + start;
  const E* xi = Src<E>::imag(xf, plane_stride);
  float2* yf = y + (static_cast<long long>(blockIdx.y) * n_frames + m) * N2;
  // block c's exchange buffer, mapped where it is used: an array of C
  // mapped pointers held across the passes costs 2 C registers
  const auto part = [&cluster, buf](int c) { return cluster.map_shared_rank(buf, c); };

  // 1. the pass tables, read after the barriers below; every block begun
  for (int e = threadIdx.x; e < S::passes; e += T) tw_fwd[e] = __ldg(&tw[e]);
  cluster.sync();

  // 2. the forward radix-C step over this block's slice of offsets, each
  // sample read by `read` (a frame past its row's end reads the halo)
  const auto forward = [&](auto read) {
    for (int n = CL::slice_lo(M1, rank, C) + threadIdx.x; n < CL::slice_lo(M1, rank + 1, C);
         n += T) {
      float2 v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = iqt::cmul(read(c * M1 + n), __ldg(&w_in[c * M1 + n]));
      iqt::dft_small<C>(v, false);
      part(0)[R::pad(n)] = v[0];
#pragma unroll
      for (int r = 1; r < C; ++r)
        part(r)[R::pad(n)] = iqt::cmul(v[r], __ldg(&tw[S::fwd_cross + r * M1 + n]));
    }
  };
  if (edge.reaches(start, N1)) {
    forward([&](int i) { return edge.read(xf, xi, start, i, blockIdx.y); });
  } else {
    forward([&](int i) { return Src<E>::read(xf, xi, i); });
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

constexpr int kRegThreads = 512;
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

// ---- the host side of the frame-batch kernels ----------------------------

// one launch's arguments: frames (batch, n_frames) of element type E at x +
// b batch_stride + m frame_stride (elements of E; for planes the imaginary
// plane plane_stride elements after the real one), the halo past a row's
// n_in samples where n_in > 0 (edge), y (batch, n_frames, nfft_out)
// complex64; tw the register / cluster kernel's table (n_tw
// entries); tw_in, perm_in, tw_out, perm_out and the plans the generic
// kernel's
struct FrameArgs {
  const void* x;
  long long batch_stride, frame_stride, plane_stride;
  // the rows' end and the halo past it (Edge; n_in = 0: none)
  const void* halo;
  long long halo_batch, halo_plane;
  int n_in, n_halo;
  const float2 *w_in, *w_out, *tw;
  int n_tw;
  float2* y;
  int batch, n_frames, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo, out_hi;
  cudaStream_t stream;
  const float2 *tw_in, *tw_out;
  const int *perm_in, *perm_out;
  iqt::FftPlan plan_in, plan_out;
};

template <class E>
Edge<E> edge_of(const FrameArgs& a) {
  return Edge<E>{static_cast<const E*>(a.halo), a.halo_batch, a.halo_plane, a.n_in, a.n_halo};
}

template <int N1, int N2, int C, int T, class E>
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

// allow every frame kernel of element type E `max_smem` bytes of dynamic
// shared memory (the generic kernel) or its own (the others)
template <class E>
cudaError_t frames_prepare(int max_smem) {
  cudaError_t err;
#define IQT_ALLOW_GENERIC(P) \
  if ((err = iqt::allow_smem(fused_ola_frames_kernel<P, E>, max_smem))) return err;
  IQT_ALLOW_GENERIC(1)
  IQT_ALLOW_GENERIC(2)
  IQT_ALLOW_GENERIC(4)
  IQT_ALLOW_GENERIC(8)
  IQT_ALLOW_GENERIC(16)
  IQT_ALLOW_GENERIC(32)
#undef IQT_ALLOW_GENERIC
#define IQT_ALLOW_REG(N1, N2)                                                        \
  if ((err = iqt::allow_smem(fused_ola_frames_reg_kernel<N1, N2, kRegThreads, E>, \
                             RegShape<N1, N2>::smem)))                              \
    return err;
  IQT_FRAMES_REG_PAIRS(IQT_ALLOW_REG)
#undef IQT_ALLOW_REG
#define IQT_ALLOW_CLUSTER(N1, N2, C)                                                         \
  if ((err = iqt::allow_smem(fused_ola_frames_cluster_kernel<N1, N2, C, kClusterThreads, E>, \
                             ClusterShape<N1, N2, C>::smem)))                                \
    return err;
  IQT_CLUSTER_PAIRS(IQT_ALLOW_CLUSTER)
#undef IQT_ALLOW_CLUSTER
  if ((err = iqt::allow_smem(fused_ola_frames_plan_kernel<E>, max_smem))) return err;
  if ((err = iqt::allow_smem(fused_ola_frames_plan_cluster_kernel<kPlanThreads, E>, max_smem)))
    return err;
  if ((err = iqt::allow_smem(fused_ola_frames_plan_cluster_kernel<kPlanThreads / 2, E>, max_smem)))
    return err;
  return cudaSuccess;
}

// the generic kernel at any size of the plans; PT the output bins a thread
// carries through registers
template <class E>
cudaError_t frames_generic(const FrameArgs& a) {
  const int nmax = a.nfft > a.nfft_out ? a.nfft : a.nfft_out;
  const size_t smem = static_cast<size_t>(nmax) * sizeof(float2);
  const int need = (a.nfft_out + kFrameThreads - 1) / kFrameThreads;
  const dim3 grid(a.n_frames, a.batch);
#define IQT_FRAMES(P)                                                                          \
  if (need <= P) {                                                                             \
    fused_ola_frames_kernel<P, E><<<grid, kFrameThreads, smem, a.stream>>>(                    \
        static_cast<const E*>(a.x), a.batch_stride, a.frame_stride, a.plane_stride,            \
        edge_of<E>(a), a.w_in, a.tw_in, a.perm_in, a.w_out, a.tw_out, a.perm_out, a.y,         \
        a.n_frames, a.plan_in, a.plan_out, a.zero_lo, a.zero_hi, a.in_lo, a.out_lo, a.out_hi); \
    return cudaGetLastError();                                                                 \
  }
  IQT_FRAMES(1)
  IQT_FRAMES(2)
  IQT_FRAMES(4)
  IQT_FRAMES(8)
  IQT_FRAMES(16)
  IQT_FRAMES(32)
#undef IQT_FRAMES
  return cudaErrorInvalidValue;
}

// the register-resident kernel at a pair of IQT_FRAMES_REG_PAIRS; any other
// pair or table length: cudaErrorInvalidValue
template <class E>
cudaError_t frames_reg(const FrameArgs& a) {
#define IQT_LAUNCH_REG(N1, N2)                                                                 \
  if (a.nfft == N1 && a.nfft_out == N2) {                                                      \
    if (a.n_tw != RegShape<N1, N2>::tw_count) return cudaErrorInvalidValue;                    \
    fused_ola_frames_reg_kernel<N1, N2, kRegThreads, E>                                        \
        <<<dim3(a.n_frames, a.batch), kRegThreads, RegShape<N1, N2>::smem, a.stream>>>(        \
            static_cast<const E*>(a.x), a.batch_stride, a.frame_stride, a.plane_stride,        \
            edge_of<E>(a), a.w_in, a.w_out, a.tw, a.y, a.n_frames, a.zero_lo, a.zero_hi,       \
            a.in_lo, a.out_lo, a.out_hi);                                                      \
    return cudaGetLastError();                                                                 \
  }
  IQT_FRAMES_REG_PAIRS(IQT_LAUNCH_REG)
#undef IQT_LAUNCH_REG
  return cudaErrorInvalidValue;
}

// whether `plan` is one the plan kernel runs for the launch `a`: both
// transforms' plans (plan::transform_ok), groups of a power of two from 32
// to 512 lanes holding max(N1, N2) at kPlanPoints a lane, at most 15 named
// barriers a block, an exchange buffer that holds the larger transform
// padded, the table length the launch gives
inline bool plan_ok(const FrameArgs& a, const FramePlan& p) {
  const int nmax = a.nfft > a.nfft_out ? a.nfft : a.nfft_out;
  const int g = p.group;
  return p.fwd.n == a.nfft && p.inv.n == a.nfft_out && g >= 32 && g <= kPlanThreads &&
         (g & (g - 1)) == 0 && p.frames >= 1 && p.frames * g <= kPlanThreads &&
         (g == 32 || p.frames <= 15) && p.buf >= iqt::reg::padded_size(nmax) &&
         p.tw_count == a.n_tw && nmax <= kPlanPoints * g &&
         iqt::plan::transform_ok<kPlanPoints>(p.fwd, g) &&
         iqt::plan::transform_ok<kPlanPoints>(p.inv, g);
}

// the plan kernel on the host's plan; a plan it does not run:
// cudaErrorInvalidValue, before any launch
template <class E>
cudaError_t frames_plan(const FrameArgs& a, const FramePlan& p) {
  if (!plan_ok(a, p)) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(p.tw_count + p.frames * p.buf) * sizeof(float2);
  const dim3 grid((a.n_frames + p.frames - 1) / p.frames, a.batch);
  fused_ola_frames_plan_kernel<E><<<grid, kPlanThreads, smem, a.stream>>>(
      static_cast<const E*>(a.x), a.batch_stride, a.frame_stride, a.plane_stride, edge_of<E>(a),
      a.w_in, a.w_out, a.tw, a.y, a.n_frames, a.zero_lo, a.zero_hi, a.in_lo, a.out_lo, a.out_hi,
      p);
  return cudaGetLastError();
}

// whether `plan` is one the two-block plan kernel runs for the launch `a`:
// halves of both sizes (plan::transform_ok at kPlanPoints a lane), blocks
// of 256 or 512 threads holding the larger half, an exchange buffer that
// holds it padded, the pass tables then the cross twiddles (M1, then M2)
// making up the launch's table
inline bool cluster_plan_ok(const FrameArgs& a, const ClusterPlan& p) {
  const int g = p.group;
  const int mmax = p.fwd.n > p.inv.n ? p.fwd.n : p.inv.n;
  return kPlanCluster * p.fwd.n == a.nfft && kPlanCluster * p.inv.n == a.nfft_out &&
         (g == kPlanThreads || g == kPlanThreads / 2) && mmax <= kPlanPoints * g &&
         p.buf >= iqt::reg::padded_size(mmax) && p.tw_count >= 0 &&
         p.fwd_cross == p.tw_count && p.inv_cross == p.fwd_cross + p.fwd.n &&
         a.n_tw == p.inv_cross + p.inv.n && iqt::plan::transform_ok<kPlanPoints>(p.fwd, g) &&
         iqt::plan::transform_ok<kPlanPoints>(p.inv, g);
}

inline cudaLaunchConfig_t plan_cluster_config(const ClusterPlan& p, dim3 grid,
                                              cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(p.group);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.tw_count + p.buf) * sizeof(float2);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kPlanCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the two-block plan kernel on the host's plan; a plan it does not run:
// cudaErrorInvalidValue, before any launch; a cluster the card refuses: the
// launch's own error
template <class E>
cudaError_t frames_plan_cluster(const FrameArgs& a, const ClusterPlan& p) {
  if (!cluster_plan_ok(a, p)) return cudaErrorInvalidValue;
  if (static_cast<long long>(a.n_frames) * kPlanCluster >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      plan_cluster_config(p, dim3(a.n_frames * kPlanCluster, a.batch), a.stream, &attr);
  const auto kernel = p.group == kPlanThreads
                          ? fused_ola_frames_plan_cluster_kernel<kPlanThreads, E>
                          : fused_ola_frames_plan_cluster_kernel<kPlanThreads / 2, E>;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const E*>(a.x), a.batch_stride, a.frame_stride, a.plane_stride,
      edge_of<E>(a), a.w_in, a.w_out, a.tw, a.y, a.n_frames, a.zero_lo, a.zero_hi, a.in_lo,
      a.out_lo, a.out_hi, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// out[0] = the clusters of the two-block plan kernel at plan `p` the
// current device can hold at once (0: it cannot launch one)
template <class E>
cudaError_t frames_plan_cluster_occupancy(const ClusterPlan& p, int* out) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = plan_cluster_config(p, dim3(kPlanCluster), nullptr, &attr);
  if (p.group == kPlanThreads)
    return cudaOccupancyMaxActiveClusters(
        out, fused_ola_frames_plan_cluster_kernel<kPlanThreads, E>, &cfg);
  return cudaOccupancyMaxActiveClusters(
      out, fused_ola_frames_plan_cluster_kernel<kPlanThreads / 2, E>, &cfg);
}

// the cluster kernel at a pair of IQT_CLUSTER_PAIRS; any other pair or
// table length: cudaErrorInvalidValue; a cluster the card refuses: the
// launch's own error
template <class E>
cudaError_t frames_cluster(const FrameArgs& a) {
#define IQT_LAUNCH_CLUSTER(N1, N2, C)                                                         \
  if (a.nfft == N1 && a.nfft_out == N2) {                                                     \
    if (a.n_tw != ClusterShape<N1, N2, C>::tw_count) return cudaErrorInvalidValue;            \
    if (static_cast<long long>(a.n_frames) * C >= (1LL << 31)) return cudaErrorInvalidValue;  \
    cudaLaunchAttribute attr;                                                                 \
    const cudaLaunchConfig_t cfg = cluster_config<N1, N2, C, kClusterThreads, E>(            \
        dim3(a.n_frames * C, a.batch), a.stream, &attr);                                      \
    const cudaError_t err = cudaLaunchKernelEx(                                               \
        &cfg, fused_ola_frames_cluster_kernel<N1, N2, C, kClusterThreads, E>,                 \
        static_cast<const E*>(a.x), a.batch_stride, a.frame_stride, a.plane_stride,           \
        edge_of<E>(a), a.w_in, a.w_out, a.tw, a.y, a.n_frames, a.zero_lo, a.zero_hi, a.in_lo, \
        a.out_lo, a.out_hi);                                                                  \
    if (err != cudaSuccess) return err;                                                       \
    return cudaGetLastError();                                                                \
  }
  IQT_CLUSTER_PAIRS(IQT_LAUNCH_CLUSTER)
#undef IQT_LAUNCH_CLUSTER
  return cudaErrorInvalidValue;
}

// out[0] = the clusters of the pair's kernel the current device can hold
// at once (0: it cannot launch one)
template <class E>
cudaError_t frames_cluster_occupancy(int nfft, int nfft_out, int* out) {
#define IQT_OCCUPANCY(N1, N2, C)                                                              \
  if (nfft == N1 && nfft_out == N2) {                                                         \
    cudaLaunchAttribute attr;                                                                 \
    const cudaLaunchConfig_t cfg =                                                            \
        cluster_config<N1, N2, C, kClusterThreads, E>(dim3(C), nullptr, &attr);               \
    return cudaOccupancyMaxActiveClusters(                                                    \
        out, fused_ola_frames_cluster_kernel<N1, N2, C, kClusterThreads, E>, &cfg);           \
  }
  IQT_CLUSTER_PAIRS(IQT_OCCUPANCY)
#undef IQT_OCCUPANCY
  return cudaErrorInvalidValue;
}

// the host launchers of one element type: `IQT_FRAMES_INSTANCES(, T)`
// instantiates them (csrc/fused_ola_f32.cu and its siblings), and
// `IQT_FRAMES_INSTANCES(extern, T)` declares them instantiated elsewhere
#define IQT_FRAMES_INSTANCES(EXTERN, E)                                        \
  EXTERN template cudaError_t frames_prepare<E>(int);                          \
  EXTERN template cudaError_t frames_generic<E>(const FrameArgs&);             \
  EXTERN template cudaError_t frames_reg<E>(const FrameArgs&);                 \
  EXTERN template cudaError_t frames_plan<E>(const FrameArgs&, const FramePlan&);      \
  EXTERN template cudaError_t frames_plan_cluster<E>(const FrameArgs&, const ClusterPlan&); \
  EXTERN template cudaError_t frames_plan_cluster_occupancy<E>(const ClusterPlan&, int*); \
  EXTERN template cudaError_t frames_cluster<E>(const FrameArgs&);             \
  EXTERN template cudaError_t frames_cluster_occupancy<E>(int, int, int*);

}  // namespace ola
}  // namespace iqt
