// The persistence spectrogram at 2048-16384 points: a block per run of
// frames.
//
// Replaces: iqwaveform_tpu/ops/pallas/spectrogram_pallas.py
//   spectrogram_dB_pallas (DB) and spectrogram_levels_pallas (the levels
//   and stats modes, its edges_dB=None variant), with the contract and
//   rounding of csrc/spectrogram.cu's radix-2 spectrogram_kernel, at nfft
//   2048, 4096, 8192 and 16384 and apd_navg 0 or any power of two up to 128
//   (the JAX kernels' sizes above 1024, their apd_navg dividing 128).
//
// A block of T = nfft / 16 threads (at most 512) walks a run of frames,
// one frame at a time, through the register-resident passes of nfft's
// plan in csrc/fft_reg.cuh (16.16.8, 16.16.16, 16.16.16.2, 16.16.16.4;
// twiddles from the host's float64 tables, copied into shared memory once
// a block), each pass with its lane read anew (chan_common.cuh fresh_lane:
// a frame loop otherwise keeps the passes' index math live, and ptxas
// spills it), as csrc/chan_mixed.cu runs the channelizer's frames. Per
// frame:
//   - the block stages the frame: each thread issues 8 coalesced loads of
//     x[f N + i] before it uses any, bins their |x|^2 over the lanes of its
//     warp (bin_staged, chan_common.cuh bin_sample's sums with the loads'
//     shuffles interleaved: navg adjacent samples are navg adjacent lanes;
//     navg 64 and 128 add the warps' 32-sample sums after the barrier,
//     bin_fold), and stores them times the window into the
//     exchange buffer: one read of the frame from device memory;
//   - the passes run from the exchange buffer; the last hands each output
//     to its thread in natural bin order: dB (the plain version's
//     rounding) stored at once (DB; a warp's stores are 32 consecutive
//     float32), or the level stored and dB folded into the running sum,
//     max and min of the bin, which the same thread holds every frame.
// The running sums live in shared memory, and the max and min too where
// they fit beside the exchange buffer (up to 8192 points); at 16384 (an
// exchange buffer of 139,264 bytes and three statistics of 65,536 do not
// fit 232,448) the max and min run in the block's rows of the partials in
// device memory, read and written once a frame, served by L2: there the
// last pass leaves dB over the exchange buffer and, after a barrier, each
// thread folds its bins t + T j with four bins' loads in flight. At the end
// the block writes its partials, and spectrogram_reduce_kernel folds the
// blocks in a fixed order (no float atomics): one kernel for kLevels and
// kStats, so their statistics are bit-equal.
//
// What bounds it on an H100: one read of the frames (8 bytes a sample) and
// the write of dB or the levels (4 bytes a sample); at 2^24 samples, 0.060
// ms at 3.35 TB/s; the FFT work (5 log2 nfft flop a sample, up to 1.2
// GFLOP) is below that. What it pays: one block barrier a pass and two a
// frame around the staging, at 16384 sixteen bytes of L2 traffic a bin a
// frame for the max and min. What held the radix-2 spectrogram_kernel
// back, and what this does about it: log2 nfft block barriers and
// shared-memory round trips a frame with twiddles gathered from device
// memory (here three or four register-resident passes from a table in
// shared memory), a bit-reversed scatter (here a coalesced staging in
// natural order) and a second, serial read of the frame for the binned
// power (here shuffles of the staged loads).
#include "chan_common.cuh"
#include "spectrogram_common.cuh"

namespace {

using namespace iqt::spg;
namespace CH = iqt::chan;
namespace R = iqt::reg;

// A block's shared memory: the padded exchange buffer and the pass tables
// (float2); then, for the statistics, as float the warps' 32-sample sums
// of bin_sample (N / 32), the running sums (N) and, where they fit the
// opt-in limit, the running max and min (2 N)
template <int N>
struct BlockSmem {
  static constexpr int exchange = R::padded_size(N);
  static constexpr int tables = R::table_total<N>();
  static constexpr size_t db_bytes = static_cast<size_t>(exchange + tables) * sizeof(float2);
  static constexpr size_t head = db_bytes + static_cast<size_t>(N / 32 + N) * sizeof(float);
  static constexpr bool ext_in_smem = head + 2 * N * sizeof(float) <= CH::kSmemOptin;
  static constexpr size_t stats_bytes = head + (ext_in_smem ? 2 * N * sizeof(float) : 0);
  static_assert(head <= CH::kSmemOptin, "the exchange, tables and sums fit one block");
};

// the detector-binned power of a thread's staged loads v[j] (samples i0 +
// j T, each in its warp's run of 32 consecutive samples): as
// chan_common.cuh bin_sample, the loads' shuffle butterflies interleaved
// (each step's kLoads shuffles independent) and the group's first lane
// writing the means (navg <= 32) or the 32-sample sums for bin_fold
template <int kLoads>
__device__ __forceinline__ void bin_staged(const float2 (&v)[kLoads], int i0, int stride_t,
                                           int lg, float* pb, float* ws) {
  float p[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) p[j] = v[j].x * v[j].x + v[j].y * v[j].y;
  const int g = lg < 5 ? 1 << lg : 32;
  for (int o = 1; o < g; o <<= 1) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) p[j] += __shfl_xor_sync(0xffffffffu, p[j], o);
  }
  if ((threadIdx.x & (g - 1)) != 0) return;
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = i0 + j * stride_t;
    if (lg <= 5) {
      pb[i >> lg] = p[j] * (1.0f / static_cast<float>(1 << lg));
    } else {
      ws[i >> 5] = p[j];
    }
  }
}

template <int N, int T, bool DB>
__global__ void __launch_bounds__(T, 512 / T)
spectrogram_block_kernel(Args a, int lg_navg) {
  constexpr int kLoads = 8;  // loads in flight a thread while the frame is staged
  constexpr int kBatch = 4;  // bins a thread folds at once where the max and min are in L2
  static_assert(T % 32 == 0 && N % (kLoads * T) == 0, "the frame stages in whole warps");
  using S = BlockSmem<N>;
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tws = smem + S::exchange;
  float* ws = reinterpret_cast<float*>(tws + S::tables);
  float* ls = ws + N / 32;
  float* sp = reinterpret_cast<float*>(buf);
  const int t = threadIdx.x;
  const float* const xr = a.xr;
  const float* const xi = a.xi;
  const int stride = a.stride;
  const float2* const w = a.w;
  float* const db = a.db;
  int* const levels = a.levels;
  const float e0 = a.e0;
  const float scale = a.scale;
  const int n_bins = a.n_bins;
  const long long plane = static_cast<long long>(gridDim.x) * N;
  float* const prow = DB ? nullptr : a.part + static_cast<long long>(blockIdx.x) * N;
  float* const mx = DB ? nullptr : (S::ext_in_smem ? ls + N : prow + plane);
  float* const mn = DB ? nullptr : (S::ext_in_smem ? ls + 2 * N : prow + 2 * plane);

  // pass 0 reads no table; the frame loop's barriers order these stores
  // (and the statistics' resets) before their first use
  for (int e = t; e < S::tables; e += T) tws[e] = __ldg(&a.tw[e]);
  if constexpr (!DB) {
    for (int k = t; k < N; k += T) {
      ls[k] = 0.f;
      mx[k] = -INFINITY;
      mn[k] = INFINITY;
    }
  }

  const int bins = lg_navg >= 0 ? N >> lg_navg : 0;
  const int f0 = blockIdx.x * a.frames_per_block;
  const int f1 = min(f0 + a.frames_per_block, a.n_frames);
  for (int f = f0; f < f1; ++f) {
    const long long base = static_cast<long long>(f) * N;
    float* pb = lg_navg >= 0 ? a.pbin + static_cast<long long>(f) * bins : nullptr;
    __syncthreads();  // the previous frame's reads of the buffer are done
    for (int i0 = CH::fresh_lane(); i0 < N; i0 += kLoads * T) {
      float2 v[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) v[j] = sample(xr, xi, stride, base + i0 + j * T);
      if (pb) bin_staged(v, i0, T, lg_navg, pb, ws);
#pragma unroll
      for (int j = 0; j < kLoads; ++j)
        buf[R::pad(i0 + j * T)] = iqt::cmul(v[j], __ldg(&w[i0 + j * T]));
    }
    __syncthreads();
    if (pb && lg_navg > 5) CH::bin_fold(ws, lg_navg, 0, bins, pb);
    CH::passes_from<N, 0, T>(buf, tws, [&](int k, float2 v) {
      const float d = to_dB(v);
      if constexpr (DB) {
        db[base + k] = d;
      } else if constexpr (S::ext_in_smem) {
        if (levels) levels[base + k] = to_level(d, e0, scale, n_bins);
        ls[k] += d;
        mx[k] = fmaxf(mx[k], d);
        mn[k] = fminf(mn[k], d);
      } else {
        sp[k] = d;  // the last pass's loads are done: dB over the buffer
      }
    });
    if constexpr (!DB && !S::ext_in_smem) {
      // the max and min in device memory: each thread folds its bins k = t
      // + T j in batches whose kBatch loads of each are in flight together
      // (one read-modify-write a bin after another waits on L2 each time)
      __syncthreads();
      for (int k0 = CH::fresh_lane(); k0 < N; k0 += kBatch * T) {
        float d[kBatch], hi[kBatch], lo[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          d[j] = sp[k0 + j * T];
          hi[j] = mx[k0 + j * T];
          lo[j] = mn[k0 + j * T];
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int k = k0 + j * T;
          if (levels) levels[base + k] = to_level(d[j], e0, scale, n_bins);
          ls[k] += d[j];
          mx[k] = fmaxf(hi[j], d[j]);
          mn[k] = fminf(lo[j], d[j]);
        }
      }
    }
  }

  if constexpr (!DB) {
    __syncthreads();  // the last pass's owners of each bin are done
    for (int k = t; k < N; k += T) {
      prow[k] = ls[k];
      if (S::ext_in_smem) {
        prow[plane + k] = mx[k];
        prow[2 * plane + k] = mn[k];
      }
    }
  }
}

// the frame sizes of the block kernel and their threads
#define IQT_SPG_BLOCK_SIZES(F) F(2048, 128) F(4096, 256) F(8192, 512) F(16384, 512)

template <int N, int T>
cudaError_t launch(const Args& a, int lg_navg) {
  if (a.db) {
    spectrogram_block_kernel<N, T, true>
        <<<a.n_blocks, T, BlockSmem<N>::db_bytes, a.stream>>>(a, lg_navg);
  } else {
    spectrogram_block_kernel<N, T, false>
        <<<a.n_blocks, T, BlockSmem<N>::stats_bytes, a.stream>>>(a, lg_navg);
  }
  return cudaGetLastError();
}

}  // namespace

// once per device, before the first launch: opt every instance in to its
// dynamic shared memory
extern "C" int iqt_spectrogram_block_prepare(int) {
  cudaError_t err;
#define IQT_ALLOW(N, T)                                                                          \
  if ((err = iqt::allow_smem(spectrogram_block_kernel<N, T, true>, BlockSmem<N>::db_bytes)))    \
    return err;                                                                                  \
  if ((err = iqt::allow_smem(spectrogram_block_kernel<N, T, false>, BlockSmem<N>::stats_bytes))) \
    return err;
  IQT_SPG_BLOCK_SIZES(IQT_ALLOW)
#undef IQT_ALLOW
  return cudaSuccess;
}

// out[0] = the blocks of nfft's instance in the dB mode (db != 0) or the
// statistics modes one SM holds at once (0: none, or no such size); after
// iqt_spectrogram_block_prepare
extern "C" int iqt_spectrogram_block_occupancy(int nfft, int db, int* out) {
#define IQT_OCC(N, T)                                                                   \
  if (nfft == N)                                                                        \
    return db ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(                         \
                    out, spectrogram_block_kernel<N, T, true>, T, BlockSmem<N>::db_bytes) \
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(                         \
                    out, spectrogram_block_kernel<N, T, false>, T,                     \
                    BlockSmem<N>::stats_bytes);
  IQT_SPG_BLOCK_SIZES(IQT_OCC)
#undef IQT_OCC
  *out = 0;
  return cudaErrorInvalidValue;
}

// The dB (mode 0), levels (1) or stats (2) mode at nfft 2048-16384:
// arguments as for iqt_spectrogram (csrc/spectrogram.cu), with tw the n_tw
// entries of nfft's forward pass tables (ops/kernels/fused_ola.py
// _reg_pass_tables) and navg 0 or a power of two up to 128 that divides
// nfft (not in the dB mode); the statistics modes then fold the blocks'
// partials into psum / pmax / pmin. Another nfft, mode, navg or table
// length: cudaErrorInvalidValue.
extern "C" int iqt_spectrogram_block(const void* xr, const void* xi, const void* w,
                                     const void* tw, void* db, void* levels, void* part,
                                     void* psum, void* pmax, void* pmin, void* pbin, int n_tw,
                                     int stride, int n_frames, int nfft, int mode, int n_bins,
                                     int navg, int frames_per_block, int n_blocks, float e0,
                                     float scale, void* stream) {
  const int lg_navg = navg == 0 ? -1 : CH::navg_log2(navg);
  if ((navg != 0 && lg_navg < 0) || (mode == kDb && navg != 0) || mode < kDb || mode > kStats)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(xr), static_cast<const float*>(xi), stride,
               static_cast<const float2*>(w), static_cast<const float2*>(tw),
               mode == kDb ? static_cast<float*>(db) : nullptr,
               mode == kLevels ? static_cast<int*>(levels) : nullptr, static_cast<float*>(part),
               static_cast<float*>(pbin), n_frames, n_bins, navg, frames_per_block, n_blocks, e0,
               scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
#define IQT_LAUNCH(N, T) \
  if (nfft == N && n_tw == R::table_total<N>()) err = launch<N, T>(a, lg_navg);
  IQT_SPG_BLOCK_SIZES(IQT_LAUNCH)
#undef IQT_LAUNCH
  if (err != cudaSuccess || mode == kDb) return err;
  return launch_reduce(a.part, psum, pmax, pmin, n_blocks, nfft, a.stream);
}
