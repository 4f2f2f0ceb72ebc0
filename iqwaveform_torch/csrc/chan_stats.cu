// One-pass channelizer statistics of a resampled stream.
//
// Replaces: iqwaveform_tpu/ops/pallas/chan_stats_pallas.py
//   chan_stats_packed_pallas and chan_stats_pallas (_chan_call /
//   _chan_stats_kernel). The port feeds complex y, so one kernel meets the
//   contract of both.
//
// Each block walks a run of `frames_per_block` channelizer frames of nfft
// samples (blockIdx.y is the batch row). For each frame it
//   - writes the detector-binned power: mean of |y|^2 over navg samples;
//   - runs the windowed nfft-point FFT in shared memory (window =
//     channelizer window / nfft, fftshift baked in, so bins come out in
//     centred order);
//   - forms spg = |Y|^2, and keeps per-bin running sums of ln(spg + 1e-25)
//     and maxima of spg in registers;
//   - writes each channel's power: the sum of spg over its `abins` kept
//     bins, after skipping `skip_half` bins at the low edge.
// The block then writes its per-bin partials to (batch, n_blocks, nfft);
// chan_reduce_kernel folds them over blocks in a fixed order, so the sums
// are deterministic (no float atomics).
//
// Channel-only mode (chan_stats_pallas with emit_psd=False and
// emit_pbin=False, the channelize_power route): the template flags PSD and
// PBIN drop the ln / max accumulators with their partial writes and the
// reduce launch, and the binned-power loop with its write. Each frame is
// then one read of y, the FFT and the channel sums; at BASELINE config #4
// (4 x 9,994,240 samples, nfft 16384) that is 320 MB, 0.095 ms at
// 3.35 TB/s.
//
// What bounds it on an H100: one read of y (8 B/sample) and the write of
// the binned power (4 B per navg samples); about 69 MB at the flagship
// step, ~21 us at 3.35 TB/s. The FFT work (0.5 GFLOP) is below that. Each
// frame stays in shared memory (32 KiB at nfft = 4096) from load to the
// channel sums, so y is read from device memory once, plus a second read of
// the same frame for the binned power that L1/L2 serve. This simple version
// pays one barrier per radix-2 stage, and is the route at the powers of two
// 64-512 alone (and at navg above 128): in the channel-only mode at
// 1024-16384 points chan_power_reg_kernel below takes its place, in the
// PSD + binned-power mode at 4096 points (the monitor step's)
// chan_stats_reg_kernel, in the other modes at one block's sizes
// chan_stats_mixed_kernel (csrc/chan_mixed.cu) and above one block
// chan_stats_cluster_kernel (csrc/chan_cluster.cu).
#include <math.h>

#include "chan_common.cuh"
#include "fft.cuh"
#include "fft_reg.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kEps = 1e-25f;

// PT = bins per thread (nfft / blockDim.x); per-bin accumulators live in
// registers for the whole run of frames. PSD: keep the ln / max partials;
// PBIN: write the binned power.
template <int PT, bool PSD, bool PBIN>
__global__ void __launch_bounds__(kMaxThreads)
chan_stats_kernel(const float2* __restrict__ y, const float2* __restrict__ w,
                  const float2* __restrict__ tw, float* __restrict__ part_log,
                  float* __restrict__ part_max, float* __restrict__ chp,
                  float* __restrict__ pbin, long long row_len, int n_frames,
                  int log2_nfft, int navg, int channel_count, int abins,
                  int skip_half, int frames_per_block) {
  extern __shared__ float2 buf[];
  const int nfft = 1 << log2_nfft;
  const int row = blockIdx.y;
  const int bins_per_frame = nfft / navg;
  const float2* yr = y + row * row_len;
  float* pr =
      PBIN ? pbin + static_cast<long long>(row) * n_frames * bins_per_frame
           : nullptr;
  float* cr = chp + static_cast<long long>(row) * n_frames * channel_count;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;

  float ls[PT], mx[PT];
#pragma unroll
  for (int r = 0; r < PT; ++r) {
    ls[r] = 0.f;
    mx[r] = -INFINITY;
  }

  const int f0 = blockIdx.x * frames_per_block;
  const int f1 = min(f0 + frames_per_block, n_frames);
  for (int f = f0; f < f1; ++f) {
    const float2* fr = yr + static_cast<long long>(f) * nfft;
    if (PBIN) {
      for (int t = threadIdx.x; t < bins_per_frame; t += blockDim.x) {
        float s = 0.f;
        for (int i = 0; i < navg; ++i) {
          const float2 v = fr[t * navg + i];
          s += v.x * v.x + v.y * v.y;
        }
        pr[static_cast<long long>(f) * bins_per_frame + t] = s / navg;
      }
    }
    for (int n = threadIdx.x; n < nfft; n += blockDim.x) {
      buf[iqt::bitrev(n, log2_nfft)] = iqt::cmul(fr[n], w[n]);
    }
    iqt::fft_radix2(buf, tw, log2_nfft, false);

    float spg[PT];
#pragma unroll
    for (int r = 0; r < PT; ++r) {
      const float2 v = buf[threadIdx.x + r * blockDim.x];
      spg[r] = v.x * v.x + v.y * v.y;
      if (PSD) {
        ls[r] += logf(spg[r] + kEps);
        mx[r] = fmaxf(mx[r], spg[r]);
      }
    }
    __syncthreads();
    // the spectrum is in registers now; reuse the buffer for spg
    float* sp = reinterpret_cast<float*>(buf);
#pragma unroll
    for (int r = 0; r < PT; ++r) sp[threadIdx.x + r * blockDim.x] = spg[r];
    __syncthreads();

    for (int c = warp; c < channel_count; c += n_warps) {
      const float* cb = sp + skip_half + c * abins;
      float s = 0.f;
      for (int i = lane; i < abins; i += 32) s += cb[i];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      if (lane == 0) cr[static_cast<long long>(f) * channel_count + c] = s;
    }
    __syncthreads();
  }

  if (PSD) {
    const long long base =
        (static_cast<long long>(row) * gridDim.x + blockIdx.x) * nfft;
#pragma unroll
    for (int r = 0; r < PT; ++r) {
      const int k = threadIdx.x + r * blockDim.x;
      part_log[base + k] = ls[r];
      part_max[base + k] = mx[r];
    }
  }
}

// psd_log_sum / psd_max per (row, bin): fold the blocks' partials in order
__global__ void chan_reduce_kernel(const float* __restrict__ part_log,
                                   const float* __restrict__ part_max,
                                   float* __restrict__ log_sum,
                                   float* __restrict__ max_out, int n_blocks,
                                   int nfft) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nfft) return;
  const long long row = blockIdx.y;
  float s = 0.f;
  float m = -INFINITY;
  for (int b = 0; b < n_blocks; ++b) {
    const long long i = (row * n_blocks + b) * nfft + k;
    s += part_log[i];
    m = fmaxf(m, part_max[i]);
  }
  log_sum[row * nfft + k] = s;
  max_out[row * nfft + k] = m;
}

template <int PT, bool PSD, bool PBIN>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const float2* y, const float2* w, const float2* tw,
                   float* part_log, float* part_max, float* chp, float* pbin,
                   long long row_len, int n_frames, int log2_nfft, int navg,
                   int channel_count, int abins, int skip_half,
                   int frames_per_block) {
  chan_stats_kernel<PT, PSD, PBIN><<<grid, threads, smem, stream>>>(
      y, w, tw, part_log, part_max, chp, pbin, row_len, n_frames, log2_nfft,
      navg, channel_count, abins, skip_half, frames_per_block);
  return cudaGetLastError();
}

template <int PT>
cudaError_t launch_mode(bool psd, bool pbin, dim3 grid, int threads,
                        size_t smem, cudaStream_t stream, const float2* y,
                        const float2* w, const float2* tw, float* part_log,
                        float* part_max, float* chp, float* pb,
                        long long row_len, int n_frames, int log2_nfft,
                        int navg, int channel_count, int abins, int skip_half,
                        int frames_per_block) {
#define IQT_MODE(A, B)                                                       \
  launch<PT, A, B>(grid, threads, smem, stream, y, w, tw, part_log,          \
                   part_max, chp, pb, row_len, n_frames, log2_nfft, navg,    \
                   channel_count, abins, skip_half, frames_per_block)
  if (psd) return pbin ? IQT_MODE(true, true) : IQT_MODE(true, false);
  return pbin ? IQT_MODE(false, true) : IQT_MODE(false, false);
#undef IQT_MODE
}

template <int PT>
cudaError_t allow_modes(int max_smem) {
  cudaError_t err;
  if ((err = iqt::allow_smem(chan_stats_kernel<PT, true, true>, max_smem))) return err;
  if ((err = iqt::allow_smem(chan_stats_kernel<PT, true, false>, max_smem))) return err;
  if ((err = iqt::allow_smem(chan_stats_kernel<PT, false, true>, max_smem))) return err;
  return iqt::allow_smem(chan_stats_kernel<PT, false, false>, max_smem);
}

// ---- the channel-only mode at one block's frame sizes ----------------------
//
// Replaces the same TPU kernel as chan_stats_kernel<PT, false, false>
// above (chan_stats_pallas.py chan_stats_pallas with emit_psd=False,
// emit_pbin=False, the mode channelize_power takes), with the same
// contract, at every frame size of IQT_CHAN_SIZES (csrc/chan_common.cuh:
// 1024-16384 points, 2^a 3^b 5^c with b, c <= 1; BASELINE config #4's 64
// channels of 256 points at 16384). The PSD + binned-power mode at 4096
// points takes chan_stats_reg_kernel below, the other modes at these sizes
// chan_stats_mixed_kernel (csrc/chan_mixed.cu), frames above 16384 points
// chan_stats_cluster_kernel (csrc/chan_cluster.cu) and the powers of two
// 64-512 chan_stats_kernel; the host route (ops/kernels/chan_stats.py
// chan_route) picks before the launch.
//
// Per frame f of row b (block f, blockIdx.y = b): pass 0 of the forward
// plan of csrc/fft_reg.cuh (16.16.16.4 at 16384) loads y[b, f * N + i]
// times w[i] (the channelizer window / nfft with the fftshift delay,
// so bins come out in centred order), coalesced, straight from device
// memory; the last pass, whose loads have all finished at its barrier,
// writes |Y_k|^2 over the exchange buffer viewed as float, in natural bin
// order; after one more barrier each warp sums the `abins` kept bins of
// its channels from skip_half + c * abins (lane i takes bins i, i + 32,
// ..., then a shuffle tree: a fixed order, no float atomics) and writes
// chp[b, f, c].
//
// Bound on an H100: one read of y (8 B/sample) and the write of the
// channel power (4 B per channel and frame); at BASELINE config #4 (2440
// frames of 16384) 320 MB, 0.0957 ms at 3.35 TB/s. The FFT work (about
// 2.8e9 flop) is below that at 67 TFLOP/s.
//
// What held chan_stats_kernel<16, false, false> back, and what this one
// does about it:
// - one block-wide barrier and a shared-memory round trip per radix-2
//   stage (14 per frame) with twiddles gathered from device memory: here
//   four register-resident radix-16 passes (the last radix 4), the
//   exchange padded conflict-free, and the forward tables of
//   fused_ola_reg_kernel (1104 float2, the first entries of the same host
//   table) copied into shared memory once per block;
// - a bit-reversed scatter of the windowed frame: pass 0 reads it in
//   natural order;
// - a run of frames per block, with the window and the FFT loop live
//   across the frame loop: here one block per frame and no frame loop (a
//   persistent loop keeps index math live and ptxas spills it).
// 512 threads at 16384 (N / 16, at most 512, at every size); the exchange
// buffer and the tables take 145 KiB there, so one block runs per SM.
template <int N, int T>
__global__ void __launch_bounds__(T, 1)
chan_power_reg_kernel(const float2* __restrict__ y, const float2* __restrict__ w,
                      const float2* __restrict__ tw, float* __restrict__ chp,
                      long long row_len, int n_frames, int channel_count, int abins,
                      int skip_half) {
  namespace R = iqt::reg;
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tws = smem + R::padded_size(N);
  // pass 0 reads no table; the barrier after it orders these stores
  // before the first table read
  for (int e = threadIdx.x; e < R::table_total<N>(); e += T) tws[e] = __ldg(&tw[e]);

  const int f = blockIdx.x;
  const float2* fr = y + blockIdx.y * row_len + static_cast<long long>(f) * N;
  float* sp = reinterpret_cast<float*>(buf);
  R::fft<N, false, T, false>(
      buf, tws, [fr, w](int i) { return iqt::cmul(fr[i], __ldg(&w[i])); },
      [sp](int k, float2 v) { sp[k] = v.x * v.x + v.y * v.y; });
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* cr = chp + (static_cast<long long>(blockIdx.y) * n_frames + f) * channel_count;
  for (int c = warp; c < channel_count; c += T / 32) {
    const float* cb = sp + skip_half + c * abins;
    float s = 0.f;
    for (int i = lane; i < abins; i += 32) s += cb[i];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) cr[c] = s;
  }
}

template <int N>
constexpr size_t power_smem() {
  return static_cast<size_t>(iqt::reg::padded_size(N) + iqt::reg::table_total<N>()) *
         sizeof(float2);
}

// ---- the PSD + binned-power mode at 4096 points ---------------------------
//
// Replaces the same TPU kernel as chan_stats_kernel<4, true, true> above
// (chan_stats_pallas.py chan_stats_packed_pallas, the mode the monitor
// step takes), with the same contract, at nfft = 4096 (the flagship
// design's 16 channels of 256 points, and the blackman design's) with
// navg in {1, 2, 4, 8, 16}. Every other size and mode keeps the kernels
// above; the host route (ops/kernels/chan_stats.py chan_route) picks
// before the launch.
//
// A block of 256 threads walks a run of frames of one row (blockIdx.y),
// one frame at a time, through the three radix-16 passes of csrc/
// fft_reg.cuh's 16.16.16 plan (Stockham passes, one butterfly a thread a
// pass, twiddles from the 720-entry forward table of ops/kernels/
// fused_ola.py reg_forward_twiddles, copied into shared memory once per
// block), with four block barriers a frame:
// - pass 0 loads y[t + 256 r] (r < 16) times the window, coalesced,
//   straight from device memory, and keeps |y|^2 of those 16 samples; the
//   navg samples of one detector bin sit in navg adjacent lanes at one r,
//   so the transposing shuffle of fft_reg.cuh bin_power writes the binned
//   power with no second read of the frame;
// - the last pass leaves thread t bins t + 256 r, the same 16 bins every
//   frame, so the running sums of ln(|Y|^2 + 1e-25) stay in the thread's
//   registers across the run and the maxima in its slots of shared memory
//   (slot-major, conflict-free: 32 statistics a lane beside a 16-point
//   butterfly would not fit 128 registers); it also stores |Y|^2 to a
//   float buffer of its own, in natural bin order;
// - after a barrier each warp sums the `abins` kept bins of its channels
//   from skip_half + c * abins (lane i takes bins i, i + 32, ..., then a
//   shuffle tree: a fixed order) and writes chp[b, f, c]; the next
//   frame's passes write that buffer only after two more barriers.
// At the end the block writes its per-bin partials, and chan_fold_kernel
// (csrc/chan_common.cuh) folds them over blocks in a fixed order (no float
// atomics).
//
// What held chan_stats_kernel<4, true, true> back, and what this one does
// about it: 16 frames a block made 128 blocks of 1024 threads, less than
// a wave (here runs of about 8 frames make a wave of two blocks an SM);
// twelve radix-2 stages a frame, each a block barrier and a shared-memory
// round trip with twiddles gathered from device memory (here three
// register-resident radix-16 passes and four barriers); a bit-reversed
// scatter of the windowed frame (here pass 0 reads it in natural order);
// a second, serial read of the frame for the binned power (here shuffles
// of the samples pass 0 holds). Each frame is still one read of y; the
// partials add 8 bytes a bin a block (8 MiB at the flagship's 256 blocks,
// mostly served from L2 to the fold).
constexpr int kStN = 4096;
constexpr int kStT = 256;     // threads of a block: one butterfly each a pass
constexpr int kStBins = 16;   // bins of one thread
// float2 units: the exchange buffer, the table, then as floats |Y|^2 of
// the frame (kStN) and the maxima (kStBins x kStT)
constexpr int kStTable = iqt::reg::padded_size(kStN);
constexpr int kStSpg = kStTable + iqt::reg::table_total<kStN>();
constexpr size_t kStSmem =
    static_cast<size_t>(kStSpg) * sizeof(float2) + (kStN + kStBins * kStT) * sizeof(float);
static_assert(kStN / 16 == kStT, "one butterfly a thread in every pass");

template <int NAVG>
__global__ void __launch_bounds__(kStT, 2)
chan_stats_reg_kernel(const float2* __restrict__ y, const float2* __restrict__ w,
                      const float2* __restrict__ tw, float* __restrict__ part_log,
                      float* __restrict__ part_max, float* __restrict__ chp,
                      float* __restrict__ pbin, long long row_len, int n_frames,
                      int channel_count, int abins, int skip_half, int frames_per_block) {
  namespace R = iqt::reg;
  constexpr int N = kStN;
  constexpr int T = kStT;
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tws = smem + kStTable;
  float* sp = reinterpret_cast<float*>(smem + kStSpg);
  // slot q of this thread's maxima: mx[q T] (bin t + 256 q)
  float* mx = sp + N + threadIdx.x;
  const int t = threadIdx.x;
  // pass 0 reads no table; the barrier after it orders these stores
  // before the first table read
  for (int e = t; e < R::table_total<N>(); e += T) tws[e] = __ldg(&tw[e]);
  const auto sync = [] { __syncthreads(); };

  float ls[kStBins];
#pragma unroll
  for (int q = 0; q < kStBins; ++q) {
    ls[q] = 0.f;
    mx[q * T] = -INFINITY;
  }

  const int row = blockIdx.y;
  const float2* yr = y + row * row_len;
  float* pr = pbin + static_cast<long long>(row) * n_frames * (N / NAVG);
  float* cr = chp + static_cast<long long>(row) * n_frames * channel_count;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int f0 = blockIdx.x * frames_per_block;
  const int f1 = min(f0 + frames_per_block, n_frames);
  for (int f = f0; f < f1; ++f) {
    const float2* fr = yr + static_cast<long long>(f) * N;
    float pw[kStBins];
    R::pass_lane<N, 0, false, T, false>(
        t, tws,
        [&](int slot, int i) {
          const float2 v = fr[i];
          pw[slot] = v.x * v.x + v.y * v.y;
          return iqt::cmul(v, __ldg(&w[i]));
        },
        [buf](int, int i, float2 v) { buf[R::pad(i)] = v; }, sync);
    R::bin_power<NAVG, T>(pw, t, pr + static_cast<long long>(f) * (N / NAVG));
    __syncthreads();
    R::pass_lane<N, 1, false, T, true>(
        t, tws, [buf](int, int i) { return buf[R::pad(i)]; },
        [buf](int, int i, float2 v) { buf[R::pad(i)] = v; }, sync);
    __syncthreads();
    R::pass_lane<N, 2, false, T, false>(
        t, tws, [buf](int, int i) { return buf[R::pad(i)]; },
        [&](int slot, int k, float2 v) {
          const float p = v.x * v.x + v.y * v.y;
          ls[slot] += logf(p + kEps);
          mx[slot * T] = fmaxf(mx[slot * T], p);
          sp[k] = p;
        },
        sync);
    __syncthreads();
    float* cf = cr + static_cast<long long>(f) * channel_count;
    for (int c = warp; c < channel_count; c += T / 32) {
      const float* cb = sp + skip_half + c * abins;
      float s = 0.f;
      for (int i = lane; i < abins; i += 32) s += cb[i];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      if (lane == 0) cf[c] = s;
    }
  }

  const long long base = (static_cast<long long>(row) * gridDim.x + blockIdx.x) * N;
#pragma unroll
  for (int q = 0; q < kStBins; ++q) {
    part_log[base + t + q * T] = ls[q];
    part_max[base + t + q * T] = mx[q * T];
  }
}

cudaError_t allow_stats_reg() {
  cudaError_t err;
  if ((err = iqt::allow_smem(chan_stats_reg_kernel<1>, kStSmem))) return err;
  if ((err = iqt::allow_smem(chan_stats_reg_kernel<2>, kStSmem))) return err;
  if ((err = iqt::allow_smem(chan_stats_reg_kernel<4>, kStSmem))) return err;
  if ((err = iqt::allow_smem(chan_stats_reg_kernel<8>, kStSmem))) return err;
  return iqt::allow_smem(chan_stats_reg_kernel<16>, kStSmem);
}

}  // namespace

// once per device, before the first launch: allow up to `max_smem` bytes
// of dynamic shared memory (one frame)
extern "C" int iqt_chan_stats_prepare(int max_smem) {
  cudaError_t err;
  if ((err = allow_modes<1>(max_smem))) return err;
  if ((err = allow_modes<2>(max_smem))) return err;
  if ((err = allow_modes<4>(max_smem))) return err;
  if ((err = allow_modes<8>(max_smem))) return err;
  if ((err = allow_modes<16>(max_smem))) return err;
  if ((err = allow_stats_reg())) return err;
#define IQT_ALLOW(N, T) \
  if ((err = iqt::allow_smem(chan_power_reg_kernel<N, T>, power_smem<N>()))) return err;
  IQT_CHAN_SIZES(IQT_ALLOW)
#undef IQT_ALLOW
  return cudaSuccess;
}

// the channel-only mode at a size of IQT_CHAN_SIZES, by
// chan_power_reg_kernel: y and chp as for iqt_chan_stats; tw: the n_tw
// forward twiddle-table entries of nfft (ops/kernels/fused_ola.py
// reg_forward_twiddles). Another nfft or table length:
// cudaErrorInvalidValue.
extern "C" int iqt_chan_power_reg(const void* y, const void* w, const void* tw, void* chp,
                                  int n_tw, int batch, int row_len, int n_frames, int nfft,
                                  int channel_count, int abins, int skip_half, void* stream) {
#define IQT_POWER(N, T)                                                                  \
  if (nfft == N) {                                                                       \
    if (n_tw != iqt::reg::table_total<N>()) return cudaErrorInvalidValue;                \
    constexpr size_t smem = power_smem<N>();                                             \
    chan_power_reg_kernel<N, T>                                                          \
        <<<dim3(n_frames, batch), T, smem, static_cast<cudaStream_t>(stream)>>>(         \
            static_cast<const float2*>(y), static_cast<const float2*>(w),                \
            static_cast<const float2*>(tw), static_cast<float*>(chp), row_len, n_frames, \
            channel_count, abins, skip_half);                                            \
    return cudaGetLastError();                                                           \
  }
  IQT_CHAN_SIZES(IQT_POWER)
#undef IQT_POWER
  return cudaErrorInvalidValue;
}

// the PSD + binned-power mode at nfft = 4096, by chan_stats_reg_kernel
// and chan_fold_kernel: arguments as for iqt_chan_stats below (both
// outputs on), with tw the n_tw entries of 4096's forward tables
// (ops/kernels/fused_ola.py reg_forward_twiddles) and navg in {1, 2, 4, 8,
// 16}. Another nfft, navg or table length: cudaErrorInvalidValue.
extern "C" int iqt_chan_stats_reg(const void* y, const void* w, const void* tw, void* part_log,
                                  void* part_max, void* log_sum, void* max_out, void* chp,
                                  void* pbin, int n_tw, int batch, int row_len, int n_frames,
                                  int nfft, int navg, int channel_count, int abins,
                                  int skip_half, int frames_per_block, int n_blocks,
                                  void* stream) {
  if (nfft != kStN || n_tw != iqt::reg::table_total<kStN>()) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pl = static_cast<float*>(part_log);
  auto pm = static_cast<float*>(part_max);
  const dim3 grid(n_blocks, batch);
#define IQT_ST(A)                                                                           \
  case A:                                                                                   \
    chan_stats_reg_kernel<A><<<grid, kStT, kStSmem, s>>>(                                   \
        static_cast<const float2*>(y), static_cast<const float2*>(w),                      \
        static_cast<const float2*>(tw), pl, pm, static_cast<float*>(chp),                  \
        static_cast<float*>(pbin), row_len, n_frames, channel_count, abins, skip_half,     \
        frames_per_block);                                                                  \
    break;
  switch (navg) {
    IQT_ST(1)
    IQT_ST(2)
    IQT_ST(4)
    IQT_ST(8)
    IQT_ST(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef IQT_ST
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return iqt::chan::launch_fold(pl, pm, static_cast<float*>(log_sum),
                                static_cast<float*>(max_out), batch, n_blocks, kStN, 1, s);
}

// y: (batch, row_len) complex64 with n_frames * nfft <= row_len;
// part_log / part_max: (batch, n_blocks, nfft) scratch with n_blocks =
// ceil(n_frames / frames_per_block); outputs log_sum / max_out (batch,
// nfft), chp (batch, n_frames, channel_count), pbin (batch, n_frames *
// nfft / navg). nfft is a power of two up to 16384 and navg divides it.
// emit_psd = 0 skips the ln / max sums (part_log, part_max, log_sum and
// max_out are then not touched, and may be null); emit_pbin = 0 skips pbin.
extern "C" int iqt_chan_stats(const void* y, const void* w, const void* tw,
                              void* part_log, void* part_max, void* log_sum,
                              void* max_out, void* chp, void* pbin,
                              int batch, int row_len, int n_frames,
                              int log2_nfft, int navg, int channel_count,
                              int abins, int skip_half, int frames_per_block,
                              int n_blocks, int emit_psd, int emit_pbin,
                              void* stream) {
  const int nfft = 1 << log2_nfft;
  const int threads = nfft < kMaxThreads ? nfft : kMaxThreads;
  const int pt = nfft / threads;
  const size_t smem = static_cast<size_t>(nfft) * sizeof(float2);
  const dim3 grid(n_blocks, batch);
  auto s = static_cast<cudaStream_t>(stream);
  auto yp = static_cast<const float2*>(y);
  auto wp = static_cast<const float2*>(w);
  auto tp = static_cast<const float2*>(tw);
  auto pl = static_cast<float*>(part_log);
  auto pm = static_cast<float*>(part_max);
  auto cp = static_cast<float*>(chp);
  auto pb = static_cast<float*>(pbin);
  cudaError_t err;
#define IQT_CHAN(P)                                                          \
  case P:                                                                    \
    err = launch_mode<P>(emit_psd != 0, emit_pbin != 0, grid, threads, smem, \
                         s, yp, wp, tp, pl, pm, cp, pb, row_len, n_frames,   \
                         log2_nfft, navg, channel_count, abins, skip_half,   \
                         frames_per_block);                                  \
    break;
  switch (pt) {
    IQT_CHAN(1)
    IQT_CHAN(2)
    IQT_CHAN(4)
    IQT_CHAN(8)
    IQT_CHAN(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef IQT_CHAN
  if (err != cudaSuccess || !emit_psd) return err;
  const int rthreads = 256;
  chan_reduce_kernel<<<dim3((nfft + rthreads - 1) / rthreads, batch),
                       rthreads, 0, s>>>(pl, pm, static_cast<float*>(log_sum),
                                         static_cast<float*>(max_out),
                                         n_blocks, nfft);
  return cudaGetLastError();
}
