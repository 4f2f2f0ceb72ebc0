// The channelizer statistics at 64-512 points: frames in groups.
//
// Replaces: iqwaveform_tpu/ops/pallas/chan_stats_pallas.py
//   chan_stats_pallas and chan_stats_packed_pallas (_chan_call /
//   _chan_stats_kernel), with the contract of csrc/chan_stats.cu, at frames
//   of 64, 128, 256 and 512 points in every mode (psd_log_sum and psd_max,
//   p_binned, each on or off) with navg a power of two up to 128 that
//   divides the frame. The radix-2 chan_stats_kernel of csrc/chan_stats.cu
//   keeps only navg above 128 (a power of two up to nfft_big, which the JAX
//   kernel does not take); the host route (ops/kernels/chan_stats.py
//   chan_route, 'small') picks before the launch.
//
// A block of csrc/fft_small.cuh's kThreads = 256 threads holds G = 256 / T
// frame groups of T = nfft / 16 lanes (4 to 32: each group inside one
// warp) and walks a run of frames of one row (blockIdx.y); group g takes
// frames f0 + g, f0 + g + G, ... and syncs with __syncwarp alone. Per frame
// (fft_small.cuh group_frame, the passes of nfft's plan in csrc/
// fft_reg.cuh: 16.4, 16.8, 16.16, 16.16.2, twiddles from the host's
// float64 tables copied into shared memory once a block):
//   - pass 0 loads y[f N + lane + T r] (r < 16) times the window, coalesced,
//     and bins |y|^2 of those 16 samples by shuffles (bin_group): one read
//     of the frame;
//   - the last pass leaves each lane the same 16 bins every frame
//     (slot_bin), so it adds ln(|Y|^2 + 1e-25) to running sums in its
//     registers (at 512 points in its slots of shared memory) and |Y|^2 to
//     running maxima in its slots of shared memory (slot-major over the
//     block's threads, conflict-free), and stores |Y|^2
//     over the group's exchange buffer, in natural bin order;
//   - after the group's barrier each channel's `abins` kept bins from
//     skip_half + c abins are summed by a team of lanes (the group's lanes
//     split into as many teams as there are channels, up to one a lane;
//     lane i of a team takes bins i, i + span, ..., then a shuffle tree: a
//     fixed order) and written to chp[b, f, c].
// At the end the groups' statistics fold by a pairwise tree into the
// block's partials (batch, n_blocks, nfft), and chan_small_fold_kernel
// folds the blocks (32 warps' strided sums, then a pairwise tree): fixed
// orders near the accuracy of torch's reductions, no float atomics.
//
// Bound on an H100: one read of y (8 B a sample) and the writes of the
// channel power (4 B a channel and frame) and the binned power (4 B per
// navg samples); 2^23 samples at 64 points channel-only, 24 channels, 0.0205
// ms at 3.35 TB/s. The FFT work (5 log2 nfft flop a sample) is below that.
// What held the radix-2 chan_stats_kernel back here, and what this does
// about it: a block of nfft threads, one point a thread, through log2 nfft
// block barriers, a bit-reversed scatter and two more barriers around the
// channel sums a frame (here two or three register-resident passes and
// warp barriers, 8 to 64 frames a block in flight); twiddles gathered from
// device memory (here a table in shared memory); a second read of the
// frame for the binned power (here shuffles of pass 0's samples).
#include "chan_common.cuh"
#include "fft_small.cuh"

namespace {

namespace S = iqt::small;
using S::kSlots;
using S::kThreads;

// A block's shared memory, float2 units: the groups' exchange buffers and
// the pass tables; then, with the PSD outputs, as float the maxima of each
// thread's 16 slots and, at 512 points, their ln sums (there 16 sums in
// registers beside a lane's 16-point butterflies and the channel teams'
// index math spill 4-20 bytes under 128 registers)
template <int N>
struct SmallSmem {
  static constexpr bool sums_in_smem = N >= 512;
  static constexpr int table = S::Group<N>::G * iqt::reg::padded_size(N);
  static constexpr int maxima = table + iqt::reg::table_total<N>();
  static constexpr size_t channel_bytes = static_cast<size_t>(maxima) * sizeof(float2);
  static constexpr size_t psd_bytes =
      channel_bytes + (sums_in_smem ? 2 : 1) * kSlots * kThreads * sizeof(float);
  static_assert(kSlots * kThreads <= 2 * table, "the groups' sums fold through the exchange buffers");
  static_assert(psd_bytes <= iqt::reg::kSmemOptin, "the buffers, tables and maxima fit one block");
};

template <int N, bool PSD, int NAVG>
__global__ void __launch_bounds__(kThreads, 2)
chan_stats_small_kernel(const float2* __restrict__ y, const float2* __restrict__ w,
                        const float2* __restrict__ tw, float* __restrict__ part_log,
                        float* __restrict__ part_max, float* __restrict__ chp,
                        float* __restrict__ pbin, long long row_len, int n_frames,
                        int channel_count, int abins, int skip_half, int frames_per_block) {
  using Gp = S::Group<N>;
  constexpr int T = Gp::T;
  static_assert(T <= 32, "a group inside one warp");
  extern __shared__ float2 smem[];
  const int group = threadIdx.x / T;
  const int lane = threadIdx.x % T;
  float2* buf = smem + group * iqt::reg::padded_size(N);
  float2* tws = smem + SmallSmem<N>::table;
  float* const mx0 = reinterpret_cast<float*>(smem + SmallSmem<N>::maxima);
  // slot q of this thread: its maximum at mx[q K], K = kThreads, and (at
  // 512 points) its ln sum at lsm[q K]
  float* const mx = mx0 + threadIdx.x;
  float* const lsm = mx + kSlots * kThreads;
  float* const sp = reinterpret_cast<float*>(buf);
  for (int e = threadIdx.x; e < iqt::reg::table_total<N>(); e += kThreads) tws[e] = __ldg(&tw[e]);
  const auto sync = [] { __syncwarp(); };

  constexpr bool kSumsInSmem = SmallSmem<N>::sums_in_smem;
  float ls[kSumsInSmem ? 1 : kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    if constexpr (kSumsInSmem) {
      if constexpr (PSD) lsm[q * kThreads] = 0.f;
    } else {
      ls[q] = 0.f;
    }
    if constexpr (PSD) mx[q * kThreads] = -INFINITY;
  }
  __syncthreads();

  const int row = blockIdx.y;
  const float2* yr = y + row * row_len;
  float* pr = nullptr;
  if constexpr (NAVG > 0) pr = pbin + static_cast<long long>(row) * n_frames * (N / NAVG);
  float* cr = chp + static_cast<long long>(row) * n_frames * channel_count;
  // the channel teams: as many as there are channels, up to one a lane
  int teams = 1;
  while (teams * 2 <= T && teams * 2 <= channel_count) teams *= 2;
  const int span = T / teams;
  const int team = lane / span;
  const int sub = lane % span;

  const int f0 = blockIdx.x * frames_per_block;
  const int f1 = min(f0 + frames_per_block, n_frames);
  S::group_frames<N>(group, f0, f1, [&](int f, bool live) {
    const float2* fr = yr + static_cast<long long>(f) * N;
    float* frame_pbin = nullptr;
    if constexpr (NAVG > 0) frame_pbin = pr + static_cast<long long>(f) * (N / NAVG);
    S::group_frame<N, NAVG>(
        lane, live, tws, buf, w, [fr](int i) { return fr[i]; }, frame_pbin, nullptr, sync,
        [&](int slot, int k, float2 v) {
          const float p = v.x * v.x + v.y * v.y;
          if constexpr (PSD) {
            if (live) {
              if constexpr (kSumsInSmem) {
                lsm[slot * kThreads] += logf(p + iqt::chan::kEps);
              } else {
                ls[slot] += logf(p + iqt::chan::kEps);
              }
              mx[slot * kThreads] = fmaxf(mx[slot * kThreads], p);
            }
          }
          sp[k] = p;
        });
    sync();
    float* cf = cr + static_cast<long long>(f) * channel_count;
    for (int c0 = 0; c0 < channel_count; c0 += teams) {
      const int c = c0 + team;
      float s = 0.f;
      if (c < channel_count) {
        const float* cb = sp + skip_half + c * abins;
        for (int i = sub; i < abins; i += span) s += cb[i];
      }
      for (int o = span / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (live && sub == 0 && c < channel_count) cf[c] = s;
    }
    sync();  // the next frame's pass 0 writes buf
  });

  if constexpr (PSD) {
    // the groups' sums (through the exchange buffers, or where they run at
    // 512 points) and maxima fold into group 0 by a pairwise tree of the
    // groups, a fixed order; group 0's entries are the block's partials
    __syncthreads();
    float* fold = kSumsInSmem ? lsm - threadIdx.x : reinterpret_cast<float*>(smem);
    if constexpr (!kSumsInSmem) {
#pragma unroll
      for (int q = 0; q < kSlots; ++q) fold[q * kThreads + threadIdx.x] = ls[q];
      __syncthreads();
    }
    for (int span = 1; span < Gp::G; span *= 2) {
#pragma unroll 1
      for (int e = threadIdx.x; e < kSlots * kThreads; e += kThreads) {
        const int g = (e % kThreads) / T;
        if (g % (2 * span) == 0) {
          fold[e] += fold[e + span * T];
          mx0[e] = fmaxf(mx0[e], mx0[e + span * T]);
        }
      }
      __syncthreads();
    }
    const long long base = (static_cast<long long>(row) * gridDim.x + blockIdx.x) * N;
#pragma unroll 1
    for (int e = threadIdx.x; e < kSlots * T; e += kThreads) {
      const int q = e / T;
      const int l = e % T;
      const int k = S::slot_bin<N>(l, q);
      part_log[base + k] = fold[q * kThreads + l];
      part_max[base + k] = mx0[q * kThreads + l];
    }
  }
}

// psd_log_sum / psd_max per (row, bin) from the blocks' partials, in a
// fixed order: a block of 32 warps owns 32 bins (one a lane); warp w folds
// blocks w, w + 32, ..., and the 32 warps' results meet in a pairwise
// tree (a sum of n_blocks partials in about n_blocks / 32 + 5 steps, near
// the accuracy of torch's own reduction)
constexpr int kSmallFoldWarps = 32;

__global__ void __launch_bounds__(kSmallFoldWarps * 32)
chan_small_fold_kernel(const float* __restrict__ part_log, const float* __restrict__ part_max,
                       float* __restrict__ log_sum, float* __restrict__ max_out, int n_blocks,
                       int nfft) {
  __shared__ float ws[kSmallFoldWarps][32], wx[kSmallFoldWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;  // nfft is a multiple of 32
  const long long row = blockIdx.y;
  float s = 0.f;
  float m = -INFINITY;
  for (int b = warp; b < n_blocks; b += kSmallFoldWarps) {
    const long long i = (row * n_blocks + b) * nfft + k;
    s += part_log[i];
    m = fmaxf(m, part_max[i]);
  }
  ws[warp][lane] = s;
  wx[warp][lane] = m;
  __syncthreads();
  for (int span = kSmallFoldWarps / 2; span > 0; span /= 2) {
    if (warp < span) {
      ws[warp][lane] += ws[warp + span][lane];
      wx[warp][lane] = fmaxf(wx[warp][lane], wx[warp + span][lane]);
    }
    __syncthreads();
  }
  if (warp == 0) {
    log_sum[row * nfft + k] = ws[0][lane];
    max_out[row * nfft + k] = wx[0][lane];
  }
}

// the frame sizes and the navg each is compiled for (0: no binned power;
// the powers of two up to 128 that divide the frame)
#define IQT_CHAN_SMALL_NAVG(F, N, PSD) \
  F(N, PSD, 0)                         \
  F(N, PSD, 1)                         \
  F(N, PSD, 2)                         \
  F(N, PSD, 4)                         \
  F(N, PSD, 8)                         \
  F(N, PSD, 16)                        \
  F(N, PSD, 32)                        \
  F(N, PSD, 64)                        \
  F(N, PSD, 128)
#define IQT_CHAN_SMALL(F)            \
  IQT_CHAN_SMALL_NAVG(F, 64, false)  \
  IQT_CHAN_SMALL_NAVG(F, 64, true)   \
  IQT_CHAN_SMALL_NAVG(F, 128, false) \
  IQT_CHAN_SMALL_NAVG(F, 128, true)  \
  IQT_CHAN_SMALL_NAVG(F, 256, false) \
  IQT_CHAN_SMALL_NAVG(F, 256, true)  \
  IQT_CHAN_SMALL_NAVG(F, 512, false) \
  IQT_CHAN_SMALL_NAVG(F, 512, true)

template <int N, bool PSD>
constexpr size_t small_bytes() {
  return PSD ? SmallSmem<N>::psd_bytes : SmallSmem<N>::channel_bytes;
}

// one launch's arguments
struct SmallArgs {
  const float2* y;
  const float2* w;
  const float2* tw;
  float* part_log;
  float* part_max;
  float* chp;
  float* pbin;
  long long row_len;
  int n_frames;
  int channel_count;
  int abins;
  int skip_half;
  int frames_per_block;
};

// each instance's opt-in, occupancy and launch; a navg above the frame has
// no instance (cudaErrorInvalidValue)
template <int N, bool PSD, int A>
cudaError_t allow_small() {
  if constexpr (A <= N) {
    return iqt::allow_smem(chan_stats_small_kernel<N, PSD, A>, small_bytes<N, PSD>());
  } else {
    return cudaSuccess;
  }
}

template <int N, bool PSD, int A>
cudaError_t occupancy_small(int* out) {
  if constexpr (A <= N) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, chan_stats_small_kernel<N, PSD, A>, kThreads, small_bytes<N, PSD>());
  } else {
    return cudaErrorInvalidValue;
  }
}

template <int N, bool PSD, int A>
cudaError_t launch_small(dim3 grid, cudaStream_t s, const SmallArgs& a) {
  if constexpr (A <= N) {
    chan_stats_small_kernel<N, PSD, A><<<grid, kThreads, small_bytes<N, PSD>(), s>>>(
        a.y, a.w, a.tw, a.part_log, a.part_max, a.chp, a.pbin, a.row_len, a.n_frames,
        a.channel_count, a.abins, a.skip_half, a.frames_per_block);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// once per device, before the first launch: opt every instance in to its
// dynamic shared memory
extern "C" int iqt_chan_small_prepare(int) {
  cudaError_t err;
#define IQT_ALLOW(N, PSD, A) \
  if ((err = allow_small<N, PSD, A>())) return err;
  IQT_CHAN_SMALL(IQT_ALLOW)
#undef IQT_ALLOW
  return cudaSuccess;
}

// out[0] = the blocks of the instance of (nfft, emit_psd, navg; navg 0
// without the binned power) one SM holds at once (0: none, or no such
// instance); after iqt_chan_small_prepare
extern "C" int iqt_chan_small_occupancy(int nfft, int emit_psd, int navg, int* out) {
  *out = 0;
#define IQT_OCC(N, PSD, A) \
  if (nfft == N && (emit_psd != 0) == PSD && navg == A) return occupancy_small<N, PSD, A>(out);
  IQT_CHAN_SMALL(IQT_OCC)
#undef IQT_OCC
  return cudaErrorInvalidValue;
}

// The channelizer statistics at nfft 64-512 by chan_stats_small_kernel
// (and chan_small_fold_kernel with the PSD outputs): arguments as for
// iqt_chan_stats (csrc/chan_stats.cu), with tw the n_tw entries of nfft's
// forward pass tables (ops/kernels/fused_ola.py _reg_pass_tables);
// part_log = null drops psd_log_sum and psd_max (part_max, log_sum and
// max_out then untouched), pbin = null the binned power; navg a power of
// two up to 128 that divides nfft. Another nfft, navg or table length:
// cudaErrorInvalidValue.
extern "C" int iqt_chan_stats_small(const void* y, const void* w, const void* tw, void* part_log,
                                    void* part_max, void* log_sum, void* max_out, void* chp,
                                    void* pbin, int n_tw, int batch, int row_len, int n_frames,
                                    int nfft, int navg, int channel_count, int abins,
                                    int skip_half, int frames_per_block, int n_blocks,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const SmallArgs a{static_cast<const float2*>(y), static_cast<const float2*>(w),
                    static_cast<const float2*>(tw), static_cast<float*>(part_log),
                    static_cast<float*>(part_max), static_cast<float*>(chp),
                    static_cast<float*>(pbin), row_len, n_frames, channel_count, abins,
                    skip_half, frames_per_block};
  const bool psd = a.part_log != nullptr;
  const int binned = a.pbin != nullptr ? navg : 0;
  const dim3 grid(n_blocks, batch);
  cudaError_t err = cudaErrorInvalidValue;
#define IQT_LAUNCH(N, PSD, A)                                                          \
  if (nfft == N && psd == PSD && binned == A && n_tw == iqt::reg::table_total<N>()) \
    err = launch_small<N, PSD, A>(grid, s, a);
  IQT_CHAN_SMALL(IQT_LAUNCH)
#undef IQT_LAUNCH
  if (err != cudaSuccess || !psd) return err;
  chan_small_fold_kernel<<<dim3(nfft / 32, batch), kSmallFoldWarps * 32, 0, s>>>(
      a.part_log, a.part_max, static_cast<float*>(log_sum), static_cast<float*>(max_out),
      n_blocks, nfft);
  return cudaGetLastError();
}
