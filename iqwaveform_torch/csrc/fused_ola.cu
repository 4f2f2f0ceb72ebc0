// Fused OLA bandpass + rational resample at 2:1 overlap, one block per OLA
// frame, with the overlap-add in the kernel; and the C entries of the
// frame-batch kernels of csrc/ola_frames.cuh, which share its per-frame
// chain.
//
// Replaces: iqwaveform_tpu/ops/pallas/fused_ola_pallas.py
//   fused_ola_strided (_fused_ola_strided_kernel); its per-frame chain is
//   also that of fused_ola_packed and fused_ola_pallas.
//
// Per frame m (block m, batch row blockIdx.y) of the 2:1 kernels:
//   1. load x[m*hop_in : m*hop_in + nfft] (interleaved complex64, or (2, n)
//      planes of float32, int16 or bfloat16 dequantized on load: Src,
//      csrc/ola_frames.cuh); samples past the row's end come from the halo
//      (the next chunk's or shard's head) where the caller gives one, else
//      zero (the single-device 'extend' halo); times the complex analysis
//      window (fftshift delay, 1/sum|w[::hop]| and the input scale baked
//      in), into bit-reversed order in shared memory;
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
// block-wide barrier per radix-2 stage (27 stages per flagship frame), and
// it took 1.6-1.9x the torch.fft chain's time (PERF.md). At OLA_REG_PAIRS
// fused_ola_reg_kernel below takes its place, at every other pair the plan
// frame kernel of csrc/ola_frames.cuh and the overlap-add of
// csrc/ola_add.cu ('plan+add'): this kernel routes only at a power-of-two
// pair the plan kernel does not hold (a size of 2), and is elsewhere the
// yardstick of the others (ops/kernels/fused_ola.py _fused_ola_generic,
// _fused_ola_older).
#include <cstring>

#include "ola_frames.cuh"

namespace {

using namespace iqt::ola;

constexpr int kThreads = 1024;

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


// ---- the 2:1 entry at the hamming pairs ----------------------------------
//
// Replaces the same TPU kernel as fused_ola_kernel above
// (fused_ola_pallas.py fused_ola_strided), with the same contract, at the
// size pairs of IQT_OLA_REG_PAIRS below: the flagship monitor step's
// 16384 -> 8192 at 2:1 (the hamming COLA design), 8192 -> 4096 and 16384
// -> 4096. Every other 2:1 pair runs a frame kernel of csrc/ola_frames.cuh
// (the plan kernel at the other powers of two) or csrc/ola_split.cu, which
// reads the frames and the halo where they lie, and the overlap-add of
// csrc/ola_add.cu; the host route (ops/kernels/fused_ola.py ola_route)
// picks by size before the launch.
//
// Per frame m of batch row b (block m, blockIdx.y = b): the chain of
// fused_ola_frames_reg_kernel (reg_frame_chain, csrc/ola_frames.cuh) on the
// frame at x[b, m * hop_in] (any input of Src: complex64, or planes of float32,
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


// the frame-batch launchers of every element type, instantiated in
// csrc/fused_ola_c64.cu, fused_ola_f32.cu, fused_ola_i16.cu and
// fused_ola_bf16.cu
namespace iqt {
namespace ola {
IQT_FRAMES_INSTANCES(extern, float2)
IQT_FRAMES_INSTANCES(extern, float)
IQT_FRAMES_INSTANCES(extern, short)
IQT_FRAMES_INSTANCES(extern, __nv_bfloat16)
}  // namespace ola
}  // namespace iqt

namespace {

// the frame-batch launcher of `layout`'s element type (IQT_LAYOUTS):
// FN<E>(args...); any other layout: cudaErrorInvalidValue
#define IQT_BY_LAYOUT(FN, ...)                                       \
  switch (layout) {                                                  \
    case 0: return iqt::ola::FN<float2>(__VA_ARGS__);                \
    case 1: return iqt::ola::FN<float>(__VA_ARGS__);                 \
    case 2: return iqt::ola::FN<short>(__VA_ARGS__);                 \
    case 3: return iqt::ola::FN<__nv_bfloat16>(__VA_ARGS__);         \
    default: return cudaErrorInvalidValue;                           \
  }

iqt::ola::FrameArgs frame_args(const void* x, long long batch_stride, long long frame_stride,
                               long long plane_stride, const void* halo, long long halo_batch,
                               long long halo_plane, int n_in, int n_halo, const void* w_in,
                               const void* w_out, void* y, int batch, int n_frames, int nfft,
                               int nfft_out, int zero_lo, int zero_hi, int in_lo, int out_lo,
                               int out_hi, void* stream) {
  iqt::ola::FrameArgs a = {};
  a.x = x;
  a.batch_stride = batch_stride;
  a.frame_stride = frame_stride;
  a.plane_stride = plane_stride;
  a.halo = halo;
  a.halo_batch = halo_batch;
  a.halo_plane = halo_plane;
  a.n_in = n_in;
  a.n_halo = n_halo;
  a.w_in = static_cast<const float2*>(w_in);
  a.w_out = static_cast<const float2*>(w_out);
  a.y = static_cast<float2*>(y);
  a.batch = batch;
  a.n_frames = n_frames;
  a.nfft = nfft;
  a.nfft_out = nfft_out;
  a.zero_lo = zero_lo;
  a.zero_hi = zero_hi;
  a.in_lo = in_lo;
  a.out_lo = out_lo;
  a.out_hi = out_hi;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// once per device, before the first launch: every frame-batch kernel of
// every layout its dynamic shared memory (the generic one `max_smem`)
extern "C" int iqt_fused_ola_frames_prepare(int max_smem) {
  cudaError_t err;
  for (int layout = 0; layout < 4; ++layout) {
    if ((err = [&]() -> cudaError_t { IQT_BY_LAYOUT(frames_prepare, max_smem) }())) return err;
  }
  return cudaSuccess;
}

// The frame-batch entries. Frames of `layout` (IQT_LAYOUTS: 0 complex64, 1-3
// (2, n) planes of float32, int16, bfloat16): frame (b, m) starts at x + b
// batch_stride + m frame_stride, in elements of the layout's type (the last
// stride 1), its imaginary plane plane_stride elements after its real one;
// with n_in > 0, a row's samples at and past n_in are read from the halo
// (n_halo samples a row at halo + b halo_batch, the imaginary plane
// halo_plane further), zeros after it (ola_frames.cuh Edge; n_in = 0, halo
// nullptr: every frame inside its row); y: (batch, n_frames, nfft_out)
// complex64, contiguous. A layout, pair or table length that no instance
// takes: cudaErrorInvalidValue, before any launch.

// the pairs of IQT_CLUSTER_PAIRS, by fused_ola_frames_cluster_kernel: tw
// the n_tw entries of the pair's cluster table; a cluster the card refuses:
// the launch's own error
extern "C" int iqt_fused_ola_frames_cluster(
    const void* x, int layout, long long batch_stride, long long frame_stride,
    long long plane_stride, const void* halo, long long halo_batch, long long halo_plane,
    int n_in, int n_halo, const void* w_in, const void* w_out, const void* tw, void* y,
    int n_tw, int batch, int n_frames, int nfft, int nfft_out, int zero_lo, int zero_hi,
    int in_lo, int out_lo, int out_hi, void* stream) {
  iqt::ola::FrameArgs a = frame_args(x, batch_stride, frame_stride, plane_stride, halo,
                                     halo_batch, halo_plane, n_in, n_halo, w_in, w_out, y, batch,
                                     n_frames, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo,
                                     out_hi, stream);
  a.tw = static_cast<const float2*>(tw);
  a.n_tw = n_tw;
  IQT_BY_LAYOUT(frames_cluster, a)
}

// out[0] = the clusters of the pair's kernel of `layout` the current
// device can hold at once (0: it cannot launch one); after
// iqt_fused_ola_frames_prepare
extern "C" int iqt_fused_ola_frames_cluster_occupancy(int nfft, int nfft_out, int layout,
                                                      int* out) {
  IQT_BY_LAYOUT(frames_cluster_occupancy, nfft, nfft_out, out)
}

// the pairs of IQT_FRAMES_REG_PAIRS, by fused_ola_frames_reg_kernel: tw the
// n_tw twiddle-table entries of the pair
extern "C" int iqt_fused_ola_frames_reg(
    const void* x, int layout, long long batch_stride, long long frame_stride,
    long long plane_stride, const void* halo, long long halo_batch, long long halo_plane,
    int n_in, int n_halo, const void* w_in, const void* w_out, const void* tw, void* y,
    int n_tw, int batch, int n_frames, int nfft, int nfft_out, int zero_lo, int zero_hi,
    int in_lo, int out_lo, int out_hi, void* stream) {
  iqt::ola::FrameArgs a = frame_args(x, batch_stride, frame_stride, plane_stride, halo,
                                     halo_batch, halo_plane, n_in, n_halo, w_in, w_out, y, batch,
                                     n_frames, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo,
                                     out_hi, stream);
  a.tw = static_cast<const float2*>(tw);
  a.n_tw = n_tw;
  IQT_BY_LAYOUT(frames_reg, a)
}

// any pair the plan kernel holds (ops/kernels/fused_ola.py plan_takes), by
// fused_ola_frames_plan_kernel: plan the plan_ints ints of the pair's
// FramePlan (ops/kernels/fused_ola.py frame_plan); tw the n_tw entries of
// both transforms' tables (plan_twiddles). A plan the kernel does not run:
// cudaErrorInvalidValue, before any launch.
static_assert(sizeof(iqt::ola::FramePlan) % sizeof(int) == 0, "a FramePlan is whole ints");

extern "C" int iqt_fused_ola_frames_plan(
    const void* x, int layout, long long batch_stride, long long frame_stride,
    long long plane_stride, const void* halo, long long halo_batch, long long halo_plane,
    int n_in, int n_halo, const void* w_in, const void* w_out, const void* tw, void* y,
    int n_tw, int batch, int n_frames, int nfft, int nfft_out, int zero_lo, int zero_hi,
    int in_lo, int out_lo, int out_hi, const int* plan, int plan_ints, void* stream) {
  if (plan_ints != static_cast<int>(sizeof(iqt::ola::FramePlan) / sizeof(int)))
    return cudaErrorInvalidValue;
  iqt::ola::FramePlan p;
  std::memcpy(&p, plan, sizeof p);
  iqt::ola::FrameArgs a = frame_args(x, batch_stride, frame_stride, plane_stride, halo,
                                     halo_batch, halo_plane, n_in, n_halo, w_in, w_out, y, batch,
                                     n_frames, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo,
                                     out_hi, stream);
  a.tw = static_cast<const float2*>(tw);
  a.n_tw = n_tw;
  IQT_BY_LAYOUT(frames_plan, a, p)
}

// any pair the two-block plan kernel holds (ops/kernels/fused_ola.py
// plan_cluster_takes), by fused_ola_frames_plan_cluster_kernel: plan the
// plan_ints ints of the pair's ClusterPlan (ops/kernels/fused_ola.py
// cluster_plan); tw the n_tw entries of both halves' pass tables and the
// cross twiddles (plan_cluster_twiddles). A plan the kernel does not run:
// cudaErrorInvalidValue, before any launch; a cluster the card refuses: the
// launch's own error.
static_assert(sizeof(iqt::ola::ClusterPlan) % sizeof(int) == 0, "a ClusterPlan is whole ints");

extern "C" int iqt_fused_ola_frames_plan_cluster(
    const void* x, int layout, long long batch_stride, long long frame_stride,
    long long plane_stride, const void* halo, long long halo_batch, long long halo_plane,
    int n_in, int n_halo, const void* w_in, const void* w_out, const void* tw, void* y,
    int n_tw, int batch, int n_frames, int nfft, int nfft_out, int zero_lo, int zero_hi,
    int in_lo, int out_lo, int out_hi, const int* plan, int plan_ints, void* stream) {
  if (plan_ints != static_cast<int>(sizeof(iqt::ola::ClusterPlan) / sizeof(int)))
    return cudaErrorInvalidValue;
  iqt::ola::ClusterPlan p;
  std::memcpy(&p, plan, sizeof p);
  iqt::ola::FrameArgs a = frame_args(x, batch_stride, frame_stride, plane_stride, halo,
                                     halo_batch, halo_plane, n_in, n_halo, w_in, w_out, y, batch,
                                     n_frames, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo,
                                     out_hi, stream);
  a.tw = static_cast<const float2*>(tw);
  a.n_tw = n_tw;
  IQT_BY_LAYOUT(frames_plan_cluster, a, p)
}

// out[0] = the clusters of the two-block plan kernel of `layout` at the
// plan's block size and shared memory that the current device can hold at
// once (0: it cannot launch one); after iqt_fused_ola_frames_prepare
extern "C" int iqt_fused_ola_frames_plan_cluster_occupancy(const int* plan, int plan_ints,
                                                           int layout, int* out) {
  if (plan_ints != static_cast<int>(sizeof(iqt::ola::ClusterPlan) / sizeof(int)))
    return cudaErrorInvalidValue;
  iqt::ola::ClusterPlan p;
  std::memcpy(&p, plan, sizeof p);
  IQT_BY_LAYOUT(frames_plan_cluster_occupancy, p, out)
}

// any size of the mixed-radix plans, by fused_ola_frames_kernel: each plan
// is (stages, radix code) of its size; perm_* the digit-reversal tables,
// tw_* the full twiddle tables exp(-2 pi i t / n), t < n
extern "C" int iqt_fused_ola_frames(
    const void* x, int layout, long long batch_stride, long long frame_stride,
    long long plane_stride, const void* halo, long long halo_batch, long long halo_plane,
    int n_in, int n_halo, const void* w_in, const void* tw_in, const void* perm_in,
    const void* w_out, const void* tw_out, const void* perm_out, void* y, int batch,
    int n_frames, int nfft, int stages_in, int code_in, int nfft_out, int stages_out,
    int code_out, int zero_lo, int zero_hi, int in_lo, int out_lo, int out_hi, void* stream) {
  iqt::ola::FrameArgs a = frame_args(x, batch_stride, frame_stride, plane_stride, halo,
                                     halo_batch, halo_plane, n_in, n_halo, w_in, w_out, y, batch,
                                     n_frames, nfft, nfft_out, zero_lo, zero_hi, in_lo, out_lo,
                                     out_hi, stream);
  a.tw_in = static_cast<const float2*>(tw_in);
  a.tw_out = static_cast<const float2*>(tw_out);
  a.perm_in = static_cast<const int*>(perm_in);
  a.perm_out = static_cast<const int*>(perm_out);
  a.plan_in = iqt::FftPlan{nfft, stages_in, code_in};
  a.plan_out = iqt::FftPlan{nfft_out, stages_out, code_out};
  IQT_BY_LAYOUT(frames_generic, a)
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
