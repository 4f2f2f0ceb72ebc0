// The channelizer statistics at frame sizes no one block or cluster kernel
// takes: the frame split into parts that pass through device memory.
//
// Replaces: iqwaveform_tpu/ops/pallas/chan_stats_pallas.py
//   chan_stats_packed_pallas and chan_stats_pallas (_chan_call /
//   _chan_stats_kernel), with the contract of csrc/chan_stats.cu, at every
//   frame size N = C M the JAX predicate takes outside CHAN_SIZES: M the
//   largest size of IQT_CHAN_STATS_SIZES (csrc/chan_common.cuh, 1024-16384
//   but 15360) that divides N with C <= 2048 (ops/kernels/chan_stats.py
//   split_shape). 1024 divides every multiple of 1024, so that is every
//   such size up to 2^21 points, and above wherever a larger M divides: 48
//   channels of 768 points (36864 = 3 x 12288), 22 of 512 (11264 = 11 x
//   1024), 128 of 1024 (131072 = 8 x 16384). Every mode (psd_log_sum and
//   psd_max, p_binned, each on or off) at navg 1-128. The host route
//   (chan_route 'split') takes it only where no other kernel takes the size.
//
// The algorithm is the cluster kernel's (csrc/chan_cluster.cu), with
// device memory in place of distributed shared memory between parts, and
// one launch a step, as the OLA's split route (csrc/ola_split.cu). The host
// route takes it only above the sizes one block holds (csrc/
// chan_split_block.cu, route 'split_block'), on the redesigned step:
//   (a) chan_split_step_kernel, the radix-C step of csrc/split_radix.cuh: a
//       block takes TN consecutive offsets n < M of one frame; it reads
//       samples c M + n (c < C, TN consecutive a part), times the window,
//       takes their C-point DFT (a prime factor from 11 to 31 in one pass
//       of a butterfly column a thread in registers, split_radix.cuh
//       prime_pass_cols; above 31 the generic pass), and stores output r
//       times exp(-2 pi i n r / N) at offset n of part r of the scratch `a`
//       (batch, frames, C, M). The cross twiddle comes from two tables of
//       about sqrt(N) entries (split_radix.cuh cross_twiddle), read through
//       the read-only cache. The same read gives the binned power at every navg: the block keeps
//       the tile's |y|^2 in its second buffer and writes the mean of each
//       run of navg (bin_sum: runs of 8 in order, then a tree) where navg
//       divides TN, else the sum of each part's TN samples, a run partial;
//   (b) chan_split_passes_kernel<M, T>, one block per (run of frames, part
//       r): per frame the register-resident M-point passes of
//       csrc/fft_reg.cuh on part r, whose bins are K = C k + r; |Y|^2 over
//       the exchange buffer; the running ln(|Y|^2 + 1e-25) sums and maxima
//       of its M bins (chan_common.cuh stats_add); and each channel's sum
//       over the kept bins the part owns (channel = (K - skip/2) / abins, a
//       run of k: warp_run_sum) stored at (frame, r, channel) of the
//       scratch `cpart`. At the end its M partial sums and maxima go to r M
//       + k of the run's row; then, where the step wrote run partials, its
//       epilogue sums each bin's navg / TN partials of part r in order;
//   (c) the folds: chan_fold_kernel (chan_common.cuh) sums the runs' rows in
//       run order and puts entry r M + k at bin C k + r;
//       chan_split_channel_fold_kernel sums each channel's C parts in part
//       order.
// The route before that redesign stays beside it (iqt_chan_stats_split,
// route 'split_older', a yardstick): chan_split_radix_kernel reading an
// N-entry table of exp(-2 pi i r n / N) (every prime above 7 through the
// generic pass), and chan_split_bin_kernel reading y once more where navg
// exceeds the tile. Plain stores and folds in a fixed order,
// no float atomics: the result does not depend on the order in which blocks
// run.
//
// Bound on an H100: one read of y (8 B/sample) and the writes of the
// channel and binned power, as the other statistics kernels. The route
// moves each frame through device memory twice more (the radix step writes
// `a`, the passes read it): about 24 B a point against the older route's
// 40 at 2^21 points (the window and `a` beside y; the older step read the
// cross table too, and the bin kernel y again). A prime factor p above 7
// costs O(p) operations a point in the radix step. Not done here: the radix
// step folded into the passes' first load (the cluster kernel's gather).
#include "chan_common.cuh"
#include "split_radix.cuh"

namespace {

namespace CH = iqt::chan;
namespace R = iqt::reg;
namespace S = iqt::split;

// the sum of run(0), ..., run(navg - 1), navg a power of two up to 128:
// runs of up to 8 terms summed in order, then a balanced tree over the runs'
// sums (zeros past the last run add exactly), so a bin's rounding grows
// with log2(navg) rather than navg, as the plain version's reduction
template <class Run>
__device__ __forceinline__ float bin_sum(Run run, int navg) {
  const int per = navg < 8 ? navg : 8;
  const int runs = navg / per;
  float part[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    float s = 0.f;
    if (b < runs) {
      for (int i = 0; i < per; ++i) s += run(b * per + i);
    }
    part[b] = s;
  }
#pragma unroll
  for (int h = 1; h < 16; h <<= 1) {
#pragma unroll
    for (int b = 0; b + h < 16; b += 2 * h) part[b] += part[b + h];
  }
  return part[0];
}

// (a) the radix-C step of one tile of one frame (blockIdx.x = frame * (m /
// TN) + tile, blockIdx.y = batch row); pbin null: no binned power here
__global__ void __launch_bounds__(S::kRadixThreads)
chan_split_radix_kernel(const float2* __restrict__ y, long long row_len,
                        const float2* __restrict__ w, const float2* __restrict__ cross,
                        const float2* __restrict__ dft_tab, float2* __restrict__ a,
                        float* __restrict__ pbin, int n_frames, int m, int c, int lt,
                        S::RadixPlan plan, int lg_navg) {
  extern __shared__ float2 smem[];
  float2* const buf[2] = {smem, smem + (c << lt)};
  float2* tab = smem + 2 * (c << lt);
  float* pw = reinterpret_cast<float*>(buf[1]);
  const int tn = 1 << lt;
  const int tiles = m >> lt;
  const int f = blockIdx.x / tiles;
  const int n0 = (blockIdx.x - f * tiles) << lt;
  const long long nfft = static_cast<long long>(c) * m;
  const float2* src = y + blockIdx.y * row_len + f * nfft + n0;
  for (int e = threadIdx.x; e < c; e += S::kRadixThreads) tab[e] = __ldg(&dft_tab[e]);
  for (int e = threadIdx.x; e < c << lt; e += S::kRadixThreads) {
    const int at = (e >> lt) * m + (e & (tn - 1));
    const float2 v = src[at];
    if (pbin != nullptr) pw[e] = v.x * v.x + v.y * v.y;
    buf[0][e] = iqt::cmul(v, __ldg(&w[n0 + at]));
  }
  __syncthreads();
  if (pbin != nullptr) {
    // the tile's bins: navg consecutive samples of one part each
    const int navg = 1 << lg_navg;
    const int per_part = tn >> lg_navg;
    float* pb = pbin + (static_cast<long long>(blockIdx.y) * n_frames + f) * (nfft >> lg_navg);
    for (int q = threadIdx.x; q < c * per_part; q += S::kRadixThreads) {
      const int part = q / per_part;
      const int j = q - part * per_part;
      const float* run = pw + part * tn + j * navg;
      pb[(static_cast<long long>(part) * m + n0 + j * navg) >> lg_navg] =
          bin_sum([run](int i) { return run[i]; }, navg) * (1.0f / static_cast<float>(navg));
    }
    __syncthreads();  // pass 0 writes buf[1]
  }
  const int cur = S::radix_step<false>(buf, tab, c, lt, plan);
  float2* dst = a + (static_cast<long long>(blockIdx.y) * n_frames + f) * nfft + n0;
  for (int e = threadIdx.x; e < c << lt; e += S::kRadixThreads) {
    const int at = (e >> lt) * m + (e & (tn - 1));
    dst[at] = iqt::cmul(buf[cur][e], __ldg(&cross[n0 + at]));
  }
}

// (a, redesigned) the radix-C step of one tile as chan_split_radix_kernel,
// with the cross twiddles on chip (split_radix.cuh cross_twiddle, from the
// factored tables hi / lo) and the binned power at every navg in the one
// read of y: where navg divides the tile, each bin's mean (bin_sum, as
// above) at pb[(f N + i) >> lg_navg]; above it the sum of each part's TN
// samples (bin_sum of TN) at pb[(f N + i) >> lt], a run partial that the
// passes kernel's epilogue folds into the bins (chan_split_passes_kernel);
// pb null: no binned power. MAXP: the instance with the register prime
// pass (kRegPrime), for a plan with a prime from 11 to 31, or without (0),
// which spares the other plans its registers
template <int MAXP>
__global__ void __launch_bounds__(S::kRadixThreads)
chan_split_step_kernel(const float2* __restrict__ y, long long row_len,
                       const float2* __restrict__ w, const float2* __restrict__ dft_tab,
                       const float2* __restrict__ hi, const float2* __restrict__ lo, int lg_l,
                       float2* __restrict__ a, float* __restrict__ pb, int n_frames, int m, int c,
                       int lt, S::RadixPlan plan, int lg_navg) {
  extern __shared__ float2 smem[];
  float2* const buf[2] = {smem, smem + (c << lt)};
  float2* tab = smem + 2 * (c << lt);
  float* pw = reinterpret_cast<float*>(buf[1]);
  const int tn = 1 << lt;
  const int tiles = m >> lt;
  const int f = blockIdx.x / tiles;
  const int n0 = (blockIdx.x - f * tiles) << lt;
  const long long nfft = static_cast<long long>(c) * m;
  const float2* src = y + blockIdx.y * row_len + f * nfft + n0;
  for (int e = threadIdx.x; e < c; e += S::kRadixThreads) tab[e] = __ldg(&dft_tab[e]);
  for (int e = threadIdx.x; e < c << lt; e += S::kRadixThreads) {
    const int at = (e >> lt) * m + (e & (tn - 1));
    const float2 v = src[at];
    if (pb != nullptr) pw[e] = v.x * v.x + v.y * v.y;
    buf[0][e] = iqt::cmul(v, __ldg(&w[n0 + at]));
  }
  __syncthreads();
  if (pb != nullptr) {
    // runs of min(navg, TN) consecutive samples of one part each: a bin's
    // mean, or the tile's partial of its bin
    const int lg_run = lg_navg < lt ? lg_navg : lt;
    const int run = 1 << lg_run;
    const float scale = lg_navg <= lt ? 1.0f / static_cast<float>(1 << lg_navg) : 1.0f;
    const int per_part = tn >> lg_run;
    float* pr = pb + ((static_cast<long long>(blockIdx.y) * n_frames + f) * nfft >> lg_run);
    for (int q = threadIdx.x; q < c * per_part; q += S::kRadixThreads) {
      const int part = q / per_part;
      const int j = q - part * per_part;
      const float* r = pw + part * tn + j * run;
      pr[(static_cast<long long>(part) * m + n0 + j * run) >> lg_run] =
          bin_sum([r](int i) { return r[i]; }, run) * scale;
    }
    __syncthreads();  // pass 0 writes buf[1]
  }
  const float2* first = buf[0];
  const int cur = S::radix_step_from<false, S::kRadixThreads, MAXP>(
      [first, lt](int row, int t) { return first[(row << lt) + t]; }, buf, tab, c, lt, plan);
  float2* dst = a + (static_cast<long long>(blockIdx.y) * n_frames + f) * nfft + n0;
  for (int e = threadIdx.x; e < c << lt; e += S::kRadixThreads) {
    const int r = e >> lt;
    const int t = e & (tn - 1);
    dst[r * m + t] = iqt::cmul(buf[cur][e], S::cross_twiddle(r * (n0 + t), hi, lo, lg_l));
  }
}

// (a') the binned power where navg exceeds the radix step's tile: bin q of
// row blockIdx.y, the mean of its navg samples in bin_sum's order
constexpr int kBinThreads = 256;

__global__ void __launch_bounds__(kBinThreads)
chan_split_bin_kernel(const float2* __restrict__ y, long long row_len,
                      float* __restrict__ pbin, long long n_bins, int lg_navg) {
  const long long q = static_cast<long long>(blockIdx.x) * kBinThreads + threadIdx.x;
  if (q >= n_bins) return;
  const int navg = 1 << lg_navg;
  const float2* src = y + blockIdx.y * row_len + (q << lg_navg);
  const float s = bin_sum(
      [src](int i) {
        const float2 v = src[i];
        return v.x * v.x + v.y * v.y;
      },
      navg);
  pbin[blockIdx.y * n_bins + q] = s * (1.0f / static_cast<float>(navg));
}

// (b) the passes kernel's shared memory: the padded exchange buffer, the
// forward pass tables, the running sums and (where they fit) the maxima of
// its M bins
template <int M>
using Smem = CH::StatsSmem<M, 0>;

template <int M, int T>
__global__ void __launch_bounds__(T, 1)
chan_split_passes_kernel(const float2* __restrict__ a, const float2* __restrict__ tw,
                         float* __restrict__ part_log, float* __restrict__ part_max,
                         float* __restrict__ cpart, int n_frames, int c, int channel_count,
                         int abins, int skip_half, int frames_per_run,
                         const float* __restrict__ ppart, float* __restrict__ pbin, int lg_navg,
                         int lt) {
  using SM = Smem<M>;
  static_assert(T % 32 == 0, "whole warps");
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tws = smem + SM::exchange;
  float* ls = reinterpret_cast<float*>(tws + SM::tables);
  float* sp = reinterpret_cast<float*>(buf);
  const int t = threadIdx.x;
  const bool psd = part_log != nullptr;
  const int row = blockIdx.y;
  const int run = blockIdx.x / c;
  const int r = blockIdx.x - run * c;
  const long long nfft = static_cast<long long>(c) * M;
  const long long base = (static_cast<long long>(row) * (gridDim.x / c) + run) * nfft +
                         static_cast<long long>(r) * M;
  float* mx = SM::max_in_smem ? ls + M : part_max + base;

  // pass 0 reads no table; its barrier orders these stores before the
  // first table read
  for (int e = t; e < SM::tables; e += T) tws[e] = __ldg(&tw[e]);
  if (psd) CH::stats_reset(ls, mx, M);

  const int warp = t >> 5;
  const int f0 = run * frames_per_run;
  const int f1 = min(f0 + frames_per_run, n_frames);
  for (int f = f0; f < f1; ++f) {
    const long long frame = static_cast<long long>(row) * n_frames + f;
    const float2* part = a + frame * nfft + static_cast<long long>(r) * M;
    __syncthreads();  // the previous frame's reads of the buffer are done
    R::pass_lane<M, 0, false, T, false>(
        CH::fresh_lane(), tws, [part](int, int i) { return part[i]; },
        [buf](int, int i, float2 v) { buf[R::pad(i)] = v; }, [] {});
    __syncthreads();
    CH::passes_from<M, 1, T>(buf, tws, [sp](int k, float2 v) { sp[k] = v.x * v.x + v.y * v.y; });
    __syncthreads();
    if (psd) CH::stats_add(sp, ls, mx, M);
    // each channel's kept bins C k + r: a run of k
    float* cf = cpart + (frame * c + r) * channel_count;
    for (int ch = warp; ch < channel_count; ch += T / 32) {
      const int b0 = skip_half + ch * abins;
      const float s = CH::warp_run_sum(sp, (b0 - r + c - 1) / c, (b0 + abins - r + c - 1) / c);
      if ((t & 31) == 0) cf[ch] = s;
    }
  }

  if (psd) CH::stats_write(ls, mx, SM::max_in_smem, part_log + base, part_max + base, M);
  if (ppart == nullptr) return;
  // the epilogue of the redesigned route where navg exceeds the radix
  // step's tile: bin q of part r of each frame of the run, the sum of its
  // navg / TN run partials (chan_split_step_kernel) in order, over navg
  const int per = 1 << (lg_navg - lt);
  const float scale = 1.0f / static_cast<float>(1 << lg_navg);
  for (int f = f0; f < f1; ++f) {
    const long long frame = static_cast<long long>(row) * n_frames + f;
    const float* src = ppart + ((frame * nfft + static_cast<long long>(r) * M) >> lt);
    float* dst = pbin + ((frame * nfft + static_cast<long long>(r) * M) >> lg_navg);
    for (int q = t; q < (M >> lg_navg); q += T) {
      float s = 0.f;
      for (int j = 0; j < per; ++j) s += src[q * per + j];
      dst[q] = s * scale;
    }
  }
}

// (c) chp[rf, ch] = sum over parts r in order of cpart[rf, r, ch], rf the
// (row, frame) pairs in order
__global__ void __launch_bounds__(kBinThreads)
chan_split_channel_fold_kernel(const float* __restrict__ cpart, float* __restrict__ chp,
                               long long n, int c, int channel_count) {
  const long long i = static_cast<long long>(blockIdx.x) * kBinThreads + threadIdx.x;
  if (i >= n) return;
  const long long rf = i / channel_count;
  const int ch = static_cast<int>(i - rf * channel_count);
  const float* src = cpart + rf * c * channel_count + ch;
  float s = 0.f;
  for (int r = 0; r < c; ++r) s += src[static_cast<long long>(r) * channel_count];
  chp[i] = s;
}

template <int M, int T>
cudaError_t launch_passes(dim3 grid, cudaStream_t stream, const float2* a, const float2* tw,
                          int n_tw_passes, float* part_log, float* part_max, float* cpart,
                          int n_frames, int c, int channel_count, int abins, int skip_half,
                          int frames_per_run, const float* ppart, float* pbin, int lg_navg,
                          int lt) {
  if (n_tw_passes != R::table_total<M>()) return cudaErrorInvalidValue;
  chan_split_passes_kernel<M, T><<<grid, T, Smem<M>::bytes, stream>>>(
      a, tw, part_log, part_max, cpart, n_frames, c, channel_count, abins, skip_half,
      frames_per_run, ppart, pbin, lg_navg, lt);
  return cudaGetLastError();
}

// (b) and (c) of both routes: the passes of each part (ppart: the step's run
// partials the epilogue folds into pbin, or null), the channel fold, the
// statistics' fold
cudaError_t launch_rest(cudaStream_t s, const float2* a, const float2* tab, int n_passes,
                        float* pl, float* pm, float* log_sum, float* max_out, float* chp,
                        float* cpart, const float* ppart, float* pbin, int batch, int n_frames,
                        int nfft, int lg_navg, int channel_count, int abins, int skip_half,
                        int frames_per_run, int n_runs, int c, int m, int lt) {
  const dim3 grid(n_runs * c, batch);
  cudaError_t err = cudaErrorInvalidValue;
#define IQT_LAUNCH(N, T)                                                                       \
  if (m == N)                                                                                  \
    err = launch_passes<N, T>(grid, s, a, tab, n_passes, pl, pm, cpart, n_frames, c,            \
                              channel_count, abins, skip_half, frames_per_run, ppart, pbin,    \
                              lg_navg, lt);
  IQT_CHAN_STATS_SIZES(IQT_LAUNCH)
#undef IQT_LAUNCH
  if (err != cudaSuccess) return err;
  const long long n_chp = static_cast<long long>(batch) * n_frames * channel_count;
  chan_split_channel_fold_kernel<<<static_cast<unsigned>((n_chp + kBinThreads - 1) / kBinThreads),
                                   kBinThreads, 0, s>>>(cpart, chp, n_chp, c, channel_count);
  if ((err = cudaGetLastError())) return err;
  if (pl == nullptr) return cudaSuccess;
  return CH::launch_fold(pl, pm, log_sum, max_out, batch, n_runs, nfft, c, s);
}

// the pass tables' length of the M-point passes where M is compiled, else -1
int passes_table(int m) {
#define IQT_TABLE(N, T) \
  if (m == N) return R::table_total<N>();
  IQT_CHAN_STATS_SIZES(IQT_TABLE)
#undef IQT_TABLE
  return -1;
}

}  // namespace

// once per device, before the first launch: opt every passes instance in to
// its dynamic shared memory
extern "C" int iqt_chan_split_prepare(int) {
  cudaError_t err;
#define IQT_ALLOW(N, T) \
  if ((err = iqt::allow_smem(chan_split_passes_kernel<N, T>, Smem<N>::bytes))) return err;
  IQT_CHAN_STATS_SIZES(IQT_ALLOW)
#undef IQT_ALLOW
  return cudaSuccess;
}

// out[0] = the blocks of the m-point passes instance one SM holds at once
// (0: none); after iqt_chan_split_prepare. Another m: cudaErrorInvalidValue.
extern "C" int iqt_chan_split_occupancy(int m, int* out) {
#define IQT_OCC(N, T)                                                                         \
  if (m == N)                                                                                 \
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, chan_split_passes_kernel<N, T>, \
                                                         T, Smem<N>::bytes);
  IQT_CHAN_STATS_SIZES(IQT_OCC)
#undef IQT_OCC
  *out = 0;
  return cudaErrorInvalidValue;
}

// y: (batch, row_len) complex64 with n_frames * nfft <= row_len, nfft = c m;
// w the window (nfft); tw the n_tw entries of the split table
// (ops/kernels/chan_stats.py split_tables: the m-point forward pass tables,
// the c x m cross twiddles exp(-2 pi i r n / nfft), exp(-2 pi i j / c));
// plan the radix step's (a host int array: the stage count, then the
// radices); part_log / part_max (batch, n_runs, nfft) scratch, n_runs =
// ceil(n_frames / frames_per_run); a (batch, n_frames, nfft) complex64 and
// cpart (batch, n_frames, c, channel_count) float32 scratch; outputs as for
// iqt_chan_stats_mixed (csrc/chan_mixed.cu): log_sum / max_out (batch,
// nfft), chp (batch, n_frames, channel_count), pbin (batch, n_frames * nfft
// / navg); part_log = null drops the PSD outputs, pbin = null the binned
// power. Another m, a table or plan that does not fit, or a navg outside 1,
// 2, 4, ..., 128: cudaErrorInvalidValue before any launch.
extern "C" int iqt_chan_stats_split(const void* y, const void* w, const void* tw,
                                    void* part_log, void* part_max, void* log_sum,
                                    void* max_out, void* chp, void* pbin, void* a, void* cpart,
                                    const int* plan, int n_tw, int batch, int row_len,
                                    int n_frames, int nfft, int navg, int channel_count,
                                    int abins, int skip_half, int frames_per_run, int n_runs,
                                    int c, int m, void* stream) {
  const int lg_navg = CH::navg_log2(navg);
  const S::RadixPlan p = S::plan_from(plan);
  const int n_passes = passes_table(m);
  if (lg_navg < 0 || n_passes < 0 || static_cast<long long>(c) * m != nfft ||
      !S::plan_ok(c, m, p) || n_tw != n_passes + c * m + c)
    return cudaErrorInvalidValue;
  const int lt = S::tile_log2(c);
  if (static_cast<long long>(n_frames) * (m >> lt) >= (1LL << 31)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto tab = static_cast<const float2*>(tw);
  auto pb = static_cast<float*>(pbin);
  const bool bin_in_step = pb != nullptr && lg_navg <= lt;
  cudaError_t err;
  // (a) the radix step, and the binned power where navg divides its tile
  chan_split_radix_kernel<<<dim3(n_frames * (m >> lt), batch), S::kRadixThreads,
                            S::radix_smem(c), s>>>(
      static_cast<const float2*>(y), row_len, static_cast<const float2*>(w), tab + n_passes,
      tab + n_passes + c * m, static_cast<float2*>(a), bin_in_step ? pb : nullptr, n_frames, m,
      c, lt, p, lg_navg);
  if ((err = cudaGetLastError())) return err;
  if (pb != nullptr && !bin_in_step) {
    const long long n_bins = (static_cast<long long>(n_frames) * nfft) >> lg_navg;
    chan_split_bin_kernel<<<dim3(static_cast<unsigned>((n_bins + kBinThreads - 1) / kBinThreads),
                                 batch),
                            kBinThreads, 0, s>>>(static_cast<const float2*>(y), row_len, pb,
                                                 n_bins, lg_navg);
    if ((err = cudaGetLastError())) return err;
  }
  // (b) the passes of each part, (c) the folds
  return launch_rest(s, static_cast<const float2*>(a), tab, n_passes, static_cast<float*>(part_log),
                     static_cast<float*>(part_max), static_cast<float*>(log_sum),
                     static_cast<float*>(max_out), static_cast<float*>(chp),
                     static_cast<float*>(cpart), nullptr, nullptr, batch, n_frames, nfft,
                     lg_navg, channel_count, abins, skip_half, frames_per_run, n_runs, c, m, lt);
}

// The redesigned route (chan_route 'split'): the arguments of
// iqt_chan_stats_split, but tw the n_tw entries of ops/kernels/chan_stats.py
// factored_tables (the m-point forward pass tables, exp(-2 pi i j / c), the
// cross twiddles' hi and lo factors at L = 2^lg_l) and ppart, where navg
// exceeds the radix step's tile, (batch, n_frames * nfft / TN) float32
// scratch for the tiles' run partials (else null). Three launches and the
// statistics' fold: chan_split_step_kernel (the binned power at every navg),
// chan_split_passes_kernel (the run partials folded in its epilogue),
// chan_split_channel_fold_kernel, chan_fold_kernel.
extern "C" int iqt_chan_stats_split_step(const void* y, const void* w, const void* tw,
                                         void* part_log, void* part_max, void* log_sum,
                                         void* max_out, void* chp, void* pbin, void* a,
                                         void* cpart, void* ppart, const int* plan, int n_tw,
                                         int lg_l, int batch, int row_len, int n_frames, int nfft,
                                         int navg, int channel_count, int abins, int skip_half,
                                         int frames_per_run, int n_runs, int c, int m,
                                         void* stream) {
  const int lg_navg = CH::navg_log2(navg);
  const S::RadixPlan p = S::plan_from(plan);
  const int n_passes = passes_table(m);
  const int n_hi = lg_l >= 0 && lg_l < 16 ? (nfft + (1 << lg_l) - 1) >> lg_l : -1;
  if (lg_navg < 0 || n_passes < 0 || static_cast<long long>(c) * m != nfft ||
      !S::plan_ok(c, m, p) || n_hi < 1 || (1LL << (2 * lg_l)) < nfft ||
      n_tw != n_passes + c + n_hi + (1 << lg_l))
    return cudaErrorInvalidValue;
  const int lt = S::tile_log2(c);
  if (static_cast<long long>(n_frames) * (m >> lt) >= (1LL << 31)) return cudaErrorInvalidValue;
  auto pb = static_cast<float*>(pbin);
  const bool partials = pb != nullptr && lg_navg > lt;
  if (partials && ppart == nullptr) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto tab = static_cast<const float2*>(tw);
  auto pp = static_cast<float*>(ppart);
  auto step = S::has_prime_upto(p, S::kRegPrime) ? chan_split_step_kernel<S::kRegPrime>
                                                 : chan_split_step_kernel<0>;
  step<<<dim3(n_frames * (m >> lt), batch), S::kRadixThreads, S::radix_smem(c), s>>>(
      static_cast<const float2*>(y), row_len, static_cast<const float2*>(w), tab + n_passes,
      tab + n_passes + c, tab + n_passes + c + n_hi, lg_l, static_cast<float2*>(a),
      partials ? pp : pb, n_frames, m, c, lt, p, lg_navg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_rest(s, static_cast<const float2*>(a), tab, n_passes, static_cast<float*>(part_log),
                     static_cast<float*>(part_max), static_cast<float*>(log_sum),
                     static_cast<float*>(max_out), static_cast<float*>(chp),
                     static_cast<float*>(cpart), partials ? pp : nullptr, pb, batch, n_frames, nfft,
                     lg_navg, channel_count, abins, skip_half, frames_per_run, n_runs, c, m, lt);
}
