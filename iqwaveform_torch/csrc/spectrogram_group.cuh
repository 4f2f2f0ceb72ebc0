// The persistence spectrogram's frame-group kernels at 64-1024 points.
//
// Replaces: iqwaveform_tpu/ops/pallas/spectrogram_pallas.py
//   spectrogram_levels_pallas (spectrogram_levels_reg_kernel: the levels
//   and stats modes, its edges_dB=None variant) and spectrogram_dB_pallas
//   (spectrogram_db_reg_kernel), with the contract and rounding of
//   csrc/spectrogram.cu's radix-2 spectrogram_kernel, at nfft 64, 128, 256,
//   512 and 1024 and apd_navg 0 or any power of two up to 128 that divides
//   nfft (the JAX levels kernel takes 1024 with apd_navg dividing 128; the
//   port's calls take the smaller frames too).
//
// A block of csrc/fft_small.cuh's kThreads = 256 threads holds G = 256 / T
// frame groups of T = nfft / 16 lanes and walks a run of frames; group g
// takes frames f0 + g, f0 + g + G, ... and syncs on its own barrier (a
// warp's __syncwarp below 1024 points, a named barrier of 64 threads at
// 1024). Per frame (fft_small.cuh group_frame) the passes of nfft's plan
// run through the group's padded exchange buffer, twiddles from the
// forward pass tables of ops/kernels/fused_ola.py _reg_pass_tables, copied
// into shared memory once a block:
// - pass 0 loads x[lane + T r] (r < 16) times the window, coalesced, and
//   bins |x|^2 of those 16 samples by shuffles (bin_group): no second read
//   of the frame;
// - the last pass leaves each lane the same 16 bins every frame
//   (slot_bin), so dB, the level store (a group's stores of one slot are T
//   consecutive int32) and the bins' statistics stay with the lane across
//   the run: the sums in registers, the max and min in the thread's slots
//   of shared memory (slot-major over the block's threads,
//   conflict-free), which keeps the kernel within 128 registers.
// At the end the groups' statistics fold in group order into the block's
// partials, and spectrogram_reduce_kernel folds the blocks in a fixed
// order: the same order in kLevels and kStats (one kernel; the levels are
// stored where `levels` is given), so their statistics are bit-equal. At
// 1024 points this is the fold of the four groups into group 0 that the
// kernel ran as its only size.
//
// What bounds it on an H100: one read of the frames (8 bytes a sample) and
// the write of dB or the levels (4 bytes a sample) and of the binned power
// (4 bytes a navg samples); at 2^24 samples, 0.060 ms at 3.35 TB/s. The FFT
// work (5 log2 nfft flop a sample, 0.5-0.8 GFLOP) is below that. What held
// the radix-2 spectrogram_kernel back at these sizes, and what this design
// does about it: log2 nfft block-wide barriers and shared-memory round
// trips a frame (here two or three register-resident passes and one barrier
// of the group's own lanes a pass); a bit-reversed scatter of the windowed
// frame (here pass 0 reads it in natural order); a second, serial read of
// the frame for the binned power (here shuffles of the samples pass 0
// holds); nfft / 2 threads a frame, as few as 32 at 64 points, with a
// block's whole frame loop behind each barrier (here eight to 64 frames a
// block in flight, each group on its own).
#pragma once

#include "fft_small.cuh"
#include "spectrogram_common.cuh"

namespace iqt {
namespace spg {

using small::kSlots;
using small::kThreads;

// A block's shared memory, float2 units: the groups' exchange buffers, the
// pass tables; then, for the statistics, as float the max and min of each
// thread's 16 slots (extremes) and, at 1024 points, 16 floats a group for
// bin_group's second warp
template <int N>
struct GroupSmem {
  static constexpr int table = small::Group<N>::G * reg::padded_size(N);
  static constexpr int extremes = table + reg::table_total<N>();
  static constexpr int cross = small::Group<N>::T > 32 ? small::Group<N>::G * kSlots : 0;
  static constexpr size_t db_bytes = static_cast<size_t>(extremes) * sizeof(float2);
  static constexpr size_t stats_bytes =
      db_bytes + static_cast<size_t>(2 * kSlots * kThreads + cross) * sizeof(float);
  static_assert(kSlots * kThreads <= 2 * table, "the groups' sums fold through the exchange buffers");
  static_assert(stats_bytes <= reg::kSmemOptin, "the buffers, tables and extremes fit one block");
};

template <int N, int NAVG>
__global__ void __launch_bounds__(kThreads, 2)
spectrogram_levels_reg_kernel(Args a) {
  using Gp = small::Group<N>;
  using S = GroupSmem<N>;
  constexpr int T = Gp::T;
  extern __shared__ float2 smem[];
  const int group = threadIdx.x / T;
  const int lane = threadIdx.x % T;
  float2* buf = smem + group * reg::padded_size(N);
  float2* tws = smem + S::table;
  // slot q of this thread: max at ext[q K], min at ext[(16 + q) K], K =
  // kThreads
  float* const ext0 = reinterpret_cast<float*>(smem + S::extremes);
  float* const ext = ext0 + threadIdx.x;
  float* const xw = ext0 + 2 * kSlots * kThreads + group * kSlots;
  for (int e = threadIdx.x; e < reg::table_total<N>(); e += kThreads) tws[e] = __ldg(&a.tw[e]);
  const auto sync = [group] { small::group_sync<T>(group); };
  // the arguments in registers: a lambda that captured the parameter
  // block by reference would copy it to local memory
  const float* const xr = a.xr;
  const float* const xi = a.xi;
  const int stride = a.stride;
  const float2* const w = a.w;
  int* const levels = a.levels;
  float* const pbin = a.pbin;
  const float e0 = a.e0;
  const float scale = a.scale;
  const int n_bins = a.n_bins;

  float sm[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    sm[q] = 0.f;
    ext[q * kThreads] = -INFINITY;
    ext[(kSlots + q) * kThreads] = INFINITY;
  }
  __syncthreads();

  const int f0 = blockIdx.x * a.frames_per_block;
  const int f1 = min(f0 + a.frames_per_block, a.n_frames);
  small::group_frames<N>(group, f0, f1, [&](int f, bool live) {
    const long long base = static_cast<long long>(f) * N;
    float* frame_pbin = nullptr;
    if constexpr (NAVG > 0) frame_pbin = pbin + static_cast<long long>(f) * (N / NAVG);
    small::group_frame<N, NAVG>(
        lane, live, tws, buf, w, [&](int i) { return sample(xr, xi, stride, base + i); },
        frame_pbin, xw, sync, [&](int slot, int k, float2 v) {
          if (!live) return;
          const float d = to_dB(v);
          if (levels) levels[base + k] = to_level(d, e0, scale, n_bins);
          sm[slot] += d;
          ext[slot * kThreads] = fmaxf(ext[slot * kThreads], d);
          ext[(kSlots + slot) * kThreads] = fminf(ext[(kSlots + slot) * kThreads], d);
        });
    sync();  // the next frame's pass 0 writes buf
  });

  // the groups' sums through the exchange buffers, which every group has
  // left once all reach the barrier; each (slot, lane) entry folds over the
  // groups in order into the block's partials
  __syncthreads();
  float* fold = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int q = 0; q < kSlots; ++q) fold[q * kThreads + threadIdx.x] = sm[q];
  __syncthreads();
  const long long plane = static_cast<long long>(gridDim.x) * N;
  float* pb = a.part + static_cast<long long>(blockIdx.x) * N;
  for (int e = threadIdx.x; e < kSlots * T; e += kThreads) {
    const int q = e / T;
    const int l = e % T;
    float s = fold[q * kThreads + l];
    float mx = ext0[q * kThreads + l];
    float mn = ext0[(kSlots + q) * kThreads + l];
    for (int g = 1; g < Gp::G; ++g) {
      const int t = g * T + l;
      s += fold[q * kThreads + t];
      mx = fmaxf(mx, ext0[q * kThreads + t]);
      mn = fminf(mn, ext0[(kSlots + q) * kThreads + t]);
    }
    const int k = small::slot_bin<N>(l, q);
    pb[k] = s;
    pb[plane + k] = mx;
    pb[2 * plane + k] = mn;
  }
}

// The dB mode (spectrogram_dB_pallas) on the same frame groups and passes:
// each lane's 16 outputs stored as dB where the last pass leaves them (a
// group's stores of one slot are T consecutive float32). No statistics,
// partials or binned power, and no reduce kernel follows. Bound on an
// H100: the read of the frames and the write of dB, 0.060 ms at 2^24
// samples.
template <int N>
__global__ void __launch_bounds__(kThreads, 2)
spectrogram_db_reg_kernel(Args a) {
  constexpr int T = small::Group<N>::T;
  using S = GroupSmem<N>;
  extern __shared__ float2 smem[];
  const int group = threadIdx.x / T;
  const int lane = threadIdx.x % T;
  float2* buf = smem + group * reg::padded_size(N);
  float2* tws = smem + S::table;
  for (int e = threadIdx.x; e < reg::table_total<N>(); e += kThreads) tws[e] = __ldg(&a.tw[e]);
  const auto sync = [group] { small::group_sync<T>(group); };
  const float* const xr = a.xr;
  const float* const xi = a.xi;
  const int stride = a.stride;
  const float2* const w = a.w;
  float* const db = a.db;
  __syncthreads();

  const int f0 = blockIdx.x * a.frames_per_block;
  const int f1 = min(f0 + a.frames_per_block, a.n_frames);
  small::group_frames<N>(group, f0, f1, [&](int f, bool live) {
    const long long base = static_cast<long long>(f) * N;
    float* out = db + base;
    small::group_frame<N, 0>(
        lane, live, tws, buf, w, [&](int i) { return sample(xr, xi, stride, base + i); },
        nullptr, nullptr, sync, [&](int, int k, float2 v) {
          if (live) out[k] = to_dB(v);
        });
    sync();
  });
}

// the apd_navg the group kernels are compiled for at N points: 0 and the
// powers of two up to 128 that divide N
#define IQT_SPG_GROUP_NAVG(F, N) \
  F(N, 0)                        \
  F(N, 1)                        \
  F(N, 2)                        \
  F(N, 4)                        \
  F(N, 8)                        \
  F(N, 16)                       \
  F(N, 32)                       \
  F(N, 64)                       \
  F(N, 128)

// opt every instance of N in to its shared memory
template <int N>
cudaError_t group_prepare() {
  cudaError_t err;
#define IQT_ALLOW(M, A)                                                                  \
  if constexpr (A <= M)                                                                  \
    if ((err = allow_smem(spectrogram_levels_reg_kernel<M, A>, GroupSmem<M>::stats_bytes))) \
      return err;
  IQT_SPG_GROUP_NAVG(IQT_ALLOW, N)
#undef IQT_ALLOW
  return allow_smem(spectrogram_db_reg_kernel<N>, GroupSmem<N>::db_bytes);
}

// the levels (a.levels given) or stats mode at N points, then the fold of
// the blocks' partials into psum / pmax / pmin; another navg:
// cudaErrorInvalidValue
template <int N>
cudaError_t group_levels(const Args& a, void* psum, void* pmax, void* pmin) {
  cudaError_t err = cudaErrorInvalidValue;
#define IQT_LAUNCH(M, A)                                                                    \
  if constexpr (A <= M)                                                                     \
    if (a.navg == A) {                                                                      \
      spectrogram_levels_reg_kernel<M, A>                                                   \
          <<<a.n_blocks, kThreads, GroupSmem<M>::stats_bytes, a.stream>>>(a);               \
      err = cudaGetLastError();                                                             \
    }
  IQT_SPG_GROUP_NAVG(IQT_LAUNCH, N)
#undef IQT_LAUNCH
  if (err != cudaSuccess) return err;
  return launch_reduce(a.part, psum, pmax, pmin, a.n_blocks, N, a.stream);
}

template <int N>
cudaError_t group_db(const Args& a) {
  spectrogram_db_reg_kernel<N><<<a.n_blocks, kThreads, GroupSmem<N>::db_bytes, a.stream>>>(a);
  return cudaGetLastError();
}

// the host launchers of one frame size: `IQT_SPG_GROUP_INSTANCES(, N)`
// instantiates them (csrc/spectrogram.cu at 512 and 1024,
// csrc/spectrogram_small.cu at 64-256), `IQT_SPG_GROUP_INSTANCES(extern,
// N)` declares them instantiated elsewhere
#define IQT_SPG_GROUP_INSTANCES(EXTERN, N)                                       \
  EXTERN template cudaError_t group_prepare<N>();                                \
  EXTERN template cudaError_t group_levels<N>(const Args&, void*, void*, void*); \
  EXTERN template cudaError_t group_db<N>(const Args&);

// the frame sizes of the group kernels
#define IQT_SPG_GROUP_SIZES(F) F(64) F(128) F(256) F(512) F(1024)

}  // namespace spg
}  // namespace iqt
