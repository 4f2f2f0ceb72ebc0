// The channelizer statistics at every frame size one block holds.
//
// Replaces: iqwaveform_tpu/ops/pallas/chan_stats_pallas.py
//   chan_stats_packed_pallas and chan_stats_pallas (_chan_call /
//   _chan_stats_kernel), with the contract of csrc/chan_stats.cu, at the
//   frame sizes of IQT_CHAN_STATS_SIZES (csrc/chan_common.cuh): 1024-16384
//   points of the form 2^a 3^b 5^c with b, c <= 1 but 15360 (a cluster of
//   5 x 3072 in csrc/chan_cluster.cu), in any mode the JAX
//   kernel takes (psd_log_sum and psd_max, p_binned, each on or off) and
//   every navg of 1-128. The host route (ops/kernels/chan_stats.py
//   chan_route) takes it wherever the older kernels do not: the
//   channel-only mode keeps chan_power_reg_kernel and the flagship's 4096
//   points with navg 1-16 chan_stats_reg_kernel (both csrc/chan_stats.cu).
//
// A block of T threads walks a run of frames of one row (blockIdx.y), one
// frame at a time, through the register-resident passes of N's plan in
// csrc/fft_reg.cuh (twiddles from the host's float64 tables, copied into
// shared memory once a block), each pass with its lane read anew
// (chan_common.cuh fresh_lane: a frame loop otherwise keeps the passes'
// index math live, and ptxas spills it). Per frame:
//   - the block stages the frame: each thread issues 8 (or 4) coalesced
//     loads of y[f N + i] before it uses any, bins their |y|^2 over the
//     lanes of its warp (chan_common.cuh bin_sample: navg adjacent samples
//     are navg adjacent lanes), and stores them times the window into the
//     exchange buffer, so the frame is read from device memory once; navg
//     64 and 128 take a second, fixed-order sum of the warps' 32-sample
//     sums after the barrier;
//   - every pass then runs from the exchange buffer, the last writing
//     |Y_k|^2 over it viewed as float, in natural bin order;
//   - after a barrier each thread adds ln(|Y_k|^2 + 1e-25) to the running
//     sums and folds |Y_k|^2 into the running maxima of its bins k = t, t
//     + T, ..., and each warp sums the `abins` kept bins of its channels
//     (lane i takes bins i, i + 32, ..., then a shuffle tree).
// The running sums live in shared memory, and the maxima too where they
// fit (chan_common.cuh StatsSmem: up to 12288 points); at 16384 the maxima
// run in the block's row of the partials in device memory, read and
// written once a frame (L2). At the end the block writes its partials,
// and chan_fold_kernel folds them over blocks in a fixed order (no float
// atomics).
//
// Bound on an H100: one read of y (8 B/sample) and the writes of the
// channel power and the binned power, as for chan_stats_reg_kernel; the
// FFT work (5 N log2 N flop a frame) is below that at 67 TFLOP/s. What it
// pays: six block barriers a frame (the staging and four passes), the
// exchange round trips of the staging and the passes, and at 16384 eight
// bytes of L2 traffic a bin a frame for the maxima. (Binning inside pass
// 0's loads, straight from device memory, left one load a thread in flight
// behind each sample's shuffles: about 50 us a frame at 12288 points.) Not done
// here: keeping the statistics in registers (32 bins a thread beside two
// radix-16 butterflies do not fit 128 registers), overlapping the next
// frame's loads with this frame's passes.
#include "chan_common.cuh"

namespace {

namespace CH = iqt::chan;
namespace R = iqt::reg;

template <int N>
using Smem = CH::StatsSmem<N, N / 32>;

template <int N, int T>
__global__ void __launch_bounds__(T, 1)
chan_stats_mixed_kernel(const float2* __restrict__ y, const float2* __restrict__ w,
                        const float2* __restrict__ tw, float* __restrict__ part_log,
                        float* __restrict__ part_max, float* __restrict__ chp,
                        float* __restrict__ pbin, long long row_len, int n_frames,
                        int channel_count, int abins, int skip_half, int frames_per_block,
                        int lg_navg) {
  // loads in flight a thread while the frame is staged; N is a multiple
  // of their T, so every warp stages whole (bin_sample)
  constexpr int kLoads = (N / T) % 8 == 0 ? 8 : 4;
  static_assert(T % 32 == 0 && N % (kLoads * T) == 0, "the frame stages in whole warps");
  using S = Smem<N>;
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tws = smem + S::exchange;
  float* ws = reinterpret_cast<float*>(tws + S::tables);
  float* ls = ws + N / 32;
  float* sp = reinterpret_cast<float*>(buf);
  const int t = threadIdx.x;
  const bool psd = part_log != nullptr;
  const int row = blockIdx.y;
  const long long base = (static_cast<long long>(row) * gridDim.x + blockIdx.x) * N;
  float* mx = S::max_in_smem ? ls + N : part_max + base;

  // pass 0 reads no table; its barrier orders these stores before the
  // first table read
  for (int e = t; e < S::tables; e += T) tws[e] = __ldg(&tw[e]);
  if (psd) CH::stats_reset(ls, mx, N);

  const float2* yr = y + row * row_len;
  const int bins = N >> lg_navg;
  float* pr = pbin ? pbin + static_cast<long long>(row) * n_frames * bins : nullptr;
  float* cr = chp + static_cast<long long>(row) * n_frames * channel_count;
  const int warp = t >> 5;
  const int f0 = blockIdx.x * frames_per_block;
  const int f1 = min(f0 + frames_per_block, n_frames);
  for (int f = f0; f < f1; ++f) {
    const float2* fr = yr + static_cast<long long>(f) * N;
    float* pb = pr ? pr + static_cast<long long>(f) * bins : nullptr;
    __syncthreads();  // the previous frame's reads of the buffer are done
    // stage the frame: kLoads coalesced loads a thread in flight, their
    // |y|^2 binned over the warp's lanes, the windowed samples into the
    // exchange buffer
    for (int i0 = CH::fresh_lane(); i0 < N; i0 += kLoads * T) {
      float2 v[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) v[j] = fr[i0 + j * T];
      if (pb) {
#pragma unroll
        for (int j = 0; j < kLoads; ++j)
          CH::bin_sample(v[j].x * v[j].x + v[j].y * v[j].y, i0 + j * T, lg_navg, pb, ws);
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j)
        buf[R::pad(i0 + j * T)] = iqt::cmul(v[j], __ldg(&w[i0 + j * T]));
    }
    __syncthreads();
    if (pb && lg_navg > 5) CH::bin_fold(ws, lg_navg, 0, bins, pb);
    CH::passes_from<N, 0, T>(buf, tws, [sp](int k, float2 v) { sp[k] = v.x * v.x + v.y * v.y; });
    __syncthreads();
    if (psd) CH::stats_add(sp, ls, mx, N);
    float* cf = cr + static_cast<long long>(f) * channel_count;
    for (int c = warp; c < channel_count; c += T / 32) {
      const float s = CH::warp_run_sum(sp, skip_half + c * abins, skip_half + (c + 1) * abins);
      if ((t & 31) == 0) cf[c] = s;
    }
  }

  if (psd) CH::stats_write(ls, mx, S::max_in_smem, part_log + base, part_max + base, N);
}

template <int N, int T>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float2* y, const float2* w,
                   const float2* tw, int n_tw, float* part_log, float* part_max, float* chp,
                   float* pbin, long long row_len, int n_frames, int channel_count, int abins,
                   int skip_half, int frames_per_block, int lg_navg) {
  if (n_tw != R::table_total<N>()) return cudaErrorInvalidValue;
  chan_stats_mixed_kernel<N, T><<<grid, T, Smem<N>::bytes, stream>>>(
      y, w, tw, part_log, part_max, chp, pbin, row_len, n_frames, channel_count, abins, skip_half,
      frames_per_block, lg_navg);
  return cudaGetLastError();
}

}  // namespace

// once per device, before the first launch: opt every instance in to its
// dynamic shared memory
extern "C" int iqt_chan_mixed_prepare(int) {
  cudaError_t err;
#define IQT_ALLOW(N, T) \
  if ((err = iqt::allow_smem(chan_stats_mixed_kernel<N, T>, Smem<N>::bytes))) return err;
  IQT_CHAN_STATS_SIZES(IQT_ALLOW)
#undef IQT_ALLOW
  return cudaSuccess;
}

// out[0] = the blocks of nfft's instance one SM holds at once (0: none,
// or no instance of that size); after iqt_chan_mixed_prepare
extern "C" int iqt_chan_mixed_occupancy(int nfft, int* out) {
#define IQT_OCC(N, T)                                                                        \
  if (nfft == N)                                                                             \
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, chan_stats_mixed_kernel<N, T>, \
                                                         T, Smem<N>::bytes);
  IQT_CHAN_STATS_SIZES(IQT_OCC)
#undef IQT_OCC
  *out = 0;
  return cudaErrorInvalidValue;
}

// y: (batch, row_len) complex64 with n_frames * nfft <= row_len; w the
// window (nfft); tw the n_tw forward pass tables of nfft (ops/kernels/
// fused_ola.py reg_forward_twiddles); part_log / part_max: (batch,
// n_blocks, nfft) scratch with n_blocks = ceil(n_frames /
// frames_per_block); outputs log_sum / max_out (batch, nfft), chp (batch,
// n_frames, channel_count), pbin (batch, n_frames * nfft / navg).
// part_log = null drops psd_log_sum and psd_max (part_max, log_sum and
// max_out then untouched), pbin = null the binned power. Another nfft, a
// table of another length or a navg outside 1, 2, 4, ..., 128:
// cudaErrorInvalidValue.
extern "C" int iqt_chan_stats_mixed(const void* y, const void* w, const void* tw, void* part_log,
                                    void* part_max, void* log_sum, void* max_out, void* chp,
                                    void* pbin, int n_tw, int batch, int row_len, int n_frames,
                                    int nfft, int navg, int channel_count, int abins,
                                    int skip_half, int frames_per_block, int n_blocks,
                                    void* stream) {
  const int lg_navg = iqt::chan::navg_log2(navg);
  if (lg_navg < 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pl = static_cast<float*>(part_log);
  auto pm = static_cast<float*>(part_max);
  const dim3 grid(n_blocks, batch);
  cudaError_t err = cudaErrorInvalidValue;
#define IQT_LAUNCH(N, T)                                                                      \
  if (nfft == N)                                                                              \
    err = launch<N, T>(grid, s, static_cast<const float2*>(y), static_cast<const float2*>(w), \
                       static_cast<const float2*>(tw), n_tw, pl, pm, static_cast<float*>(chp), \
                       static_cast<float*>(pbin), row_len, n_frames, channel_count, abins,    \
                       skip_half, frames_per_block, lg_navg);
  IQT_CHAN_STATS_SIZES(IQT_LAUNCH)
#undef IQT_LAUNCH
  if (err != cudaSuccess || part_log == nullptr) return err;
  return iqt::chan::launch_fold(pl, pm, static_cast<float*>(log_sum),
                                static_cast<float*>(max_out), batch, n_blocks, nfft, 1, s);
}
