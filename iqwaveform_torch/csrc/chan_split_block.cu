// The channelizer statistics at the split sizes one block holds: the split
// route in one block, each frame read from device memory once and kept in
// shared memory.
//
// Replaces: iqwaveform_tpu/ops/pallas/chan_stats_pallas.py
//   chan_stats_packed_pallas and chan_stats_pallas (_chan_call /
//   _chan_stats_kernel), with the contract of csrc/chan_stats.cu, at the
//   frame sizes N = C M of the split route (ops/kernels/chan_stats.py
//   split_shape: M the largest part size of 1024-16384 but 15360 that
//   divides N) whose frame, tiles, tables and running sums fit one H100
//   block (ops/kernels/chan_stats.py block_plan states the limit per mode:
//   7168-25600 points without the PSD outputs, 7168-14336 with them), at
//   part sizes M of IQT_CHAN_BLOCK_PARTS, in every mode
//   (psd_log_sum and psd_max, p_binned, each on or off) at navg 1-128. The
//   host route (chan_route 'split_block') takes it at those sizes in place
//   of the device-memory split route (csrc/chan_split.cu).
//
// A block of T = G TM threads walks a run of frames of one row
// (blockIdx.y). Its shared memory holds the frame, C parts of M points
// each in a padded exchange buffer of csrc/fft_reg.cuh, and the tables.
// Per frame:
//   1. the frame from device memory, each thread with 8 (4 beside the
//      widest radix column) coalesced loads of y and of the window in
//      flight: sample i times the window goes to offset i mod M of part i /
//      M, and its |y|^2 is binned over the lanes of a warp from the same
//      read (chan_common.cuh bin_sample; at navg 64 and 128 the warps' sums
//      of 32, which bin_fold sums in order);
//   2. the radix-C step tile by tile in place (csrc/split_radix.cuh
//      radix_step_from): a tile is the TN consecutive offsets n0 .. n0 + TN
//      of every part; its first pass reads them from the frame buffer (every
//      C of the range a prime up to 23, in one pass of a butterfly column a
//      thread in registers: prime_pass_cols, in an instance for C up to 13
//      and one up to 23), and output r times exp(-2 pi i r n / N)
//      (split_radix.cuh cross_twiddle) goes back to offset n of part r;
//   3. the M-point register passes of each part in place in its buffer, G
//      parts at a time by G groups of TM = M / 16 threads (each with its
//      lane read anew at each pass: chan_common.cuh fresh_lane); the last
//      pass writes |Y|^2 of the part's bins C k + r at k over the buffer
//      viewed as float;
//   4. each thread adds ln(|Y|^2 + 1e-25) to the running sums and folds
//      |Y|^2 into the maxima of its bins (part-major: entry r M + k), and
//      each warp sums, for each of its channels, the kept bins of every
//      part (warp_run_sum's arithmetic, the shuffle trees of eight parts
//      side by side), the parts' sums in part order, straight into
//      channel_power: no scratch, no channel fold.
// The running sums live in shared memory, and the maxima too where they
// fit; otherwise the maxima run in the block's row of the partials in
// device memory (L2), read and written once a frame, as chan_mixed.cu at
// 16384 points. At the end of a run the block writes its partials at r M +
// k of its row, and chan_fold_kernel (chan_common.cuh) folds the rows in a
// fixed order and puts entry r M + k at bin C k + r. Plain stores and folds
// in a fixed order, no float atomics.
//
// Bound on an H100: one read of y (8 B/sample) and the writes of the
// channel and binned power, as the other statistics kernels. What it pays:
// one 512-thread block an SM (the frame takes most of the shared memory),
// so the frame's read and its compute do not overlap; two block barriers a
// tile of the radix step; the passes' barriers once per G parts and the
// groups left idle where G does not divide C; the cross twiddles and the
// window read through the read-only cache; a few register spills (ptxas:
// 16-24 bytes a thread in the instances for C up to 13). On an H100 80GB
// HBM3 at 700 W, 11264 points channel-only on 2^23 samples, leaving phases
// out showed the radix step and the channel sums as first written costing
// more than the frame's read, which runs near the card's memory rate; the
// register column and the side-by-side channel trees took the kernel from
// 230 to 161 us (PERF.md). Not done here: the next frame's loads in
// flight during this frame's passes.
#include "chan_common.cuh"
#include "split_radix.cuh"

namespace {

namespace CH = iqt::chan;
namespace R = iqt::reg;
namespace S = iqt::split;

// The part sizes of the kernel, F(M, TM, G): TM = M / 16 threads a part
// (one radix-16 butterfly a thread a pass, the passes instances of
// chan_common.cuh IQT_CHAN_STATS_SIZES), G parts at once. The split sizes
// one block holds are C x 1024 (C = 7, 11, 13, 17, 19, 23), C x 2048 (7,
// 11), C x 3072 (3, 7), 3 x 6144 and 5 x 5120.
#define IQT_CHAN_BLOCK_PARTS(F) \
  F(1024, 64, 8)                \
  F(2048, 128, 4)               \
  F(3072, 192, 2)               \
  F(5120, 320, 1)               \
  F(6144, 384, 1)

// the smallest tile (log2); the most parts a frame (the largest C of the
// range) and the prime bound of the instance for C up to 13 (the radix
// step's column of C points takes 2 MAXP registers; at MAXP = 23 the
// M = 1024 instance spilled 212 bytes a thread, at 13 about 16); the parts
// whose channel sums a warp holds at once
constexpr int kMinTileLog2 = 7;
constexpr int kMaxParts = 23;
constexpr int kSmallParts = 13;
constexpr int kSumParts = 8;
// the loads of y a thread has in flight while the frame is read: 8, or 4
// beside the 23-point radix column (at 8 that instance spilled 212 bytes a
// thread at M = 1024, at 4 about 48)
template <int MAXP>
constexpr int kLoads = MAXP > 13 ? 4 : 8;

// The block's shared memory at C parts of M points, tiles of TN = 2^lt
// columns: the frame (C padded exchange buffers), the pass tables, the
// radix step's table, its tile buffers (one where the step is one pass,
// as at every prime C; two for a plan of several), then as float the
// warps' sums of 32 samples (navg 64, 128), the running ln sums and
// (max_smem) the maxima. ops/kernels/chan_stats.py _block_bytes computes
// the same bytes.
struct Layout {
  int tables, dft, tile1, tile0;  // float2 offsets (tile0: several passes only)
  int ws, ls, mx;                 // float offsets
  size_t bytes;
};

__host__ __device__ inline Layout layout(int c, int m, int n_tables, int lt, int stages,
                                         bool sums32, bool psd, bool max_smem) {
  Layout l{};
  const int n = c * m;
  l.tables = c * R::padded_size(m);
  l.dft = l.tables + n_tables;
  l.tile1 = l.dft + c;
  l.tile0 = l.tile1 + (c << lt);
  const int floats = 2 * (l.tile0 + (stages > 1 ? c << lt : 0));
  l.ws = floats;
  l.ls = l.ws + (sums32 ? n / 32 : 0);
  l.mx = l.ls + (psd ? n : 0);
  l.bytes = static_cast<size_t>(l.mx + (psd && max_smem ? n : 0)) * sizeof(float);
  return l;
}

// passes S, S + 1, ... of the M-point forward transform of part r0 + g by
// group g of G (threads g TM .. g TM + TM), in place in the part's padded
// buffer of the frame; a group with no part (r0 + g >= C) loads part C - 1
// and stores nothing. The last pass writes |Y|^2 at k over the buffer
// viewed as float. Every thread of the block takes every barrier.
template <int M, int S, int TM>
__device__ __forceinline__ void group_passes(float2* frame, const float2* tw, int c, int r0) {
  const int g = CH::fresh_lane() / TM;
  const bool live = r0 + g < c;
  float2* buf = frame + (live ? r0 + g : c - 1) * R::padded_size(M);
  const int lane = CH::fresh_lane() - g * TM;
  const auto sync = [] { __syncthreads(); };
  const auto load = [buf](int, int i) { return buf[R::pad(i)]; };
  if constexpr (S < R::Plan<M>::stages - 1) {
    R::pass_lane<M, S, false, TM, true>(
        lane, tw, load,
        [buf, live](int, int i, float2 v) {
          if (live) buf[R::pad(i)] = v;
        },
        sync);
    __syncthreads();
    group_passes<M, S + 1, TM>(frame, tw, c, r0);
  } else {
    float* sp = reinterpret_cast<float*>(buf);
    R::pass_lane<M, S, false, TM, true>(
        lane, tw, load,
        [sp, live](int, int k, float2 v) {
          if (live) sp[k] = v.x * v.x + v.y * v.y;
        },
        sync);
  }
}

template <int M, int TM, int G, int MAXP>
__global__ void __launch_bounds__(TM * G, 1)
chan_split_block_kernel(const float2* __restrict__ y, const float2* __restrict__ w,
                        const float2* __restrict__ tab, const float2* __restrict__ hi,
                        const float2* __restrict__ lo, int lg_l, float* __restrict__ part_log,
                        float* __restrict__ part_max, float* __restrict__ chp,
                        float* __restrict__ pbin, long long row_len, int n_frames, int c,
                        int channel_count, int abins, int skip_half, int frames_per_block,
                        int lg_navg, int lt, int max_smem, S::RadixPlan plan) {
  constexpr int T = TM * G;
  constexpr int MP = R::padded_size(M);
  constexpr int NT = R::table_total<M>();
  const int n = c * M;
  const int tn = 1 << lt;
  const bool psd = part_log != nullptr;
  const Layout l =
      layout(c, M, NT, lt, plan.stages, pbin != nullptr && lg_navg > 5, psd, max_smem);
  extern __shared__ float2 smem[];
  float2* frame = smem;
  float2* tws = smem + l.tables;
  float2* dft = smem + l.dft;
  float2* const tile[2] = {smem + l.tile0, smem + l.tile1};
  float* fs = reinterpret_cast<float*>(smem);
  float* ws = fs + l.ws;
  float* ls = fs + l.ls;
  const int t = threadIdx.x;
  const int row = blockIdx.y;
  const long long base = (static_cast<long long>(row) * gridDim.x + blockIdx.x) * n;
  float* mx = max_smem ? fs + l.mx : part_max + base;

  // the tables: read first after the frame's barrier
  for (int e = t; e < NT + c; e += T) tws[e] = __ldg(&tab[e]);
  if (psd) CH::stats_reset(ls, mx, n);

  const float2* yr = y + row * row_len;
  const int bins = n >> lg_navg;
  float* pr = pbin ? pbin + static_cast<long long>(row) * n_frames * bins : nullptr;
  float* cr = chp + static_cast<long long>(row) * n_frames * channel_count;
  const int warp = t >> 5;
  const int f0 = blockIdx.x * frames_per_block;
  const int f1 = min(f0 + frames_per_block, n_frames);
  for (int f = f0; f < f1; ++f) {
    const float2* fr = yr + static_cast<long long>(f) * n;
    float* pb = pr ? pr + static_cast<long long>(f) * bins : nullptr;
    __syncthreads();  // the previous frame's reads of the frame buffer are done
    // 1. the frame from device memory, L coalesced loads a thread in
    // flight (n is a multiple of 1024, so a warp's lanes are all in or all
    // out): |y|^2 binned over the warp's lanes, times the window into part
    // i / M of the frame buffer
    constexpr int L = kLoads<MAXP>;
    for (int i0 = CH::fresh_lane(); i0 < n; i0 += L * T) {
      float2 v[L], wv[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int i = i0 + j * T;
        if (i < n) {
          v[j] = fr[i];
          wv[j] = __ldg(&w[i]);
        }
      }
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int i = i0 + j * T;
        if (i < n) {
          if (pb) CH::bin_sample(v[j].x * v[j].x + v[j].y * v[j].y, i, lg_navg, pb, ws);
          const int r = i / M;
          frame[r * MP + R::pad(i - r * M)] = iqt::cmul(v[j], wv[j]);
        }
      }
    }
    __syncthreads();
    if (pb && lg_navg > 5) CH::bin_fold(ws, lg_navg, 0, bins, pb);
    // the radix-C step tile by tile in place: the first pass reads the
    // tile's columns n0 .. n0 + TN of every part from the frame buffer
    for (int n0 = 0; n0 < M; n0 += tn) {
      const int cur = S::radix_step_from<false, T, MAXP>(
          [frame, n0](int r, int k) { return frame[r * MP + R::pad(n0 + k)]; }, tile, dft, c,
          lt, plan);
      for (int e = CH::fresh_lane(); e < c << lt; e += T) {
        const int r = e >> lt;
        const int k = n0 + (e & (tn - 1));
        frame[r * MP + R::pad(k)] =
            iqt::cmul(tile[cur][e], S::cross_twiddle(r * k, hi, lo, lg_l));
      }
      __syncthreads();  // the tile's reads before the next tile's first pass writes it
    }
    // 2. the M-point passes of each part, G at a time
    for (int r0 = 0; r0 < c; r0 += G) group_passes<M, 0, TM>(frame, tws, c, r0);
    __syncthreads();
    // 3. the statistics of the frame's bins, part-major, and the channels
    if (psd) {
      for (int k = t; k < n; k += T) {
        const int r = k / M;
        const float p = fs[2 * r * MP + (k - r * M)];
        ls[k] += logf(p + CH::kEps);
        mx[k] = fmaxf(mx[k], p);
      }
    }
    // each warp's channels: lane l adds, for every part at once, the kept
    // bins k0 + l, k0 + l + 32, ... of the part's run of k in order, the
    // parts' shuffle trees run side by side, and the parts' sums add in part
    // order (warp_run_sum's arithmetic, part by part)
    float* cf = cr + static_cast<long long>(f) * channel_count;
    for (int ch = warp; ch < channel_count; ch += T / 32) {
      const int b0 = skip_half + ch * abins;
      float s = 0.f;
      for (int r0 = 0; r0 < c; r0 += kSumParts) {
        float part[kSumParts];
#pragma unroll
        for (int i = 0; i < kSumParts; ++i) {
          const int r = r0 + i;
          part[i] = 0.f;
          if (r < c) {
            const float* sp = fs + 2 * r * MP;
            const int k1 = (b0 + abins - r + c - 1) / c;
            for (int k = (b0 - r + c - 1) / c + (t & 31); k < k1; k += 32) part[i] += sp[k];
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int i = 0; i < kSumParts; ++i) part[i] += __shfl_down_sync(0xffffffffu, part[i], o);
        }
#pragma unroll
        for (int i = 0; i < kSumParts; ++i) {
          if (r0 + i < c) s += part[i];
        }
      }
      if ((t & 31) == 0) cf[ch] = s;
    }
  }

  if (psd) CH::stats_write(ls, mx, max_smem, part_log + base, part_max + base, n);
}

// the instance of part size M for C parts: MAXP kSmallParts up to C = 13,
// else kMaxParts
template <int M, int TM, int G>
auto instance(int c) {
  return c <= kSmallParts ? chan_split_block_kernel<M, TM, G, kSmallParts>
                          : chan_split_block_kernel<M, TM, G, kMaxParts>;
}

template <int M, int TM, int G>
cudaError_t launch(dim3 grid, size_t bytes, cudaStream_t stream, const float2* y, const float2* w,
                   const float2* tab, const float2* hi, const float2* lo, int lg_l,
                   float* part_log, float* part_max, float* chp, float* pbin, long long row_len,
                   int n_frames, int c, int channel_count, int abins, int skip_half,
                   int frames_per_block, int lg_navg, int lt, int max_smem,
                   const S::RadixPlan& plan) {
  const auto kernel = instance<M, TM, G>(c);
  kernel<<<grid, TM * G, bytes, stream>>>(
      y, w, tab, hi, lo, lg_l, part_log, part_max, chp, pbin, row_len, n_frames, c, channel_count,
      abins, skip_half, frames_per_block, lg_navg, lt, max_smem, plan);
  return cudaGetLastError();
}

// the pass tables' length of part size m where it is compiled, else -1
int block_tables(int m) {
#define IQT_TABLE(M, TM, G) \
  if (m == M) return R::table_total<M>();
  IQT_CHAN_BLOCK_PARTS(IQT_TABLE)
#undef IQT_TABLE
  return -1;
}

// a radix plan of the step at c parts whose product is c
bool plan_of(int c, const S::RadixPlan& plan) {
  if (plan.stages < 1 || plan.stages > S::kMaxStages) return false;
  long long prod = 1;
  for (int s = 0; s < plan.stages; ++s) {
    const int r = plan.radix[s];
    if (r != 4 && !S::is_prime(r)) return false;
    prod *= r;
  }
  return prod == c;
}

}  // namespace

// once per device, before the first launch: opt every instance in to the
// block's whole dynamic shared memory (its bytes depend on C, the tile and
// the mode)
extern "C" int iqt_chan_split_block_prepare(int max_smem) {
  cudaError_t err;
#define IQT_ALLOW(M, TM, G)                                                                  \
  if ((err = iqt::allow_smem(instance<M, TM, G>(kSmallParts), max_smem))) return err;        \
  if ((err = iqt::allow_smem(instance<M, TM, G>(kMaxParts), max_smem))) return err;
  IQT_CHAN_BLOCK_PARTS(IQT_ALLOW)
#undef IQT_ALLOW
  return cudaSuccess;
}

// out[0] = the blocks of the instance of part size m for c parts one SM
// holds at `bytes` of dynamic shared memory (0: none); out[1] = its
// threads. Another m: cudaErrorInvalidValue. After
// iqt_chan_split_block_prepare.
extern "C" int iqt_chan_split_block_occupancy(int m, int c, int bytes, int* out) {
#define IQT_OCC(M, TM, G)                                                                    \
  if (m == M) {                                                                              \
    out[1] = TM * G;                                                                         \
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, instance<M, TM, G>(c), TM * G, \
                                                         bytes);                             \
  }
  IQT_CHAN_BLOCK_PARTS(IQT_OCC)
#undef IQT_OCC
  out[0] = 0;
  return cudaErrorInvalidValue;
}

// y: (batch, row_len) complex64 with n_frames * nfft <= row_len, nfft = c m;
// w the window (nfft); tw the n_tw entries of ops/kernels/chan_stats.py
// factored_tables (the m-point forward pass tables, exp(-2 pi i j / c),
// the cross twiddles' hi and lo factors at L = 2^lg_l); plan the radix
// step's (a host int array: the stage count, then the radices); tiles of
// 2^lt columns; max_smem: the maxima in shared memory (else in part_max);
// part_log / part_max (batch, n_blocks, nfft) scratch; outputs as for
// iqt_chan_stats_mixed (csrc/chan_mixed.cu): log_sum / max_out (batch,
// nfft), chp (batch, n_frames, channel_count), pbin (batch, n_frames * nfft
// / navg); part_log = null drops the PSD outputs, pbin = null the binned
// power. Another m, a table, plan or tile that does not fit, a layout above
// the block's shared memory or a navg outside 1, 2, 4, ..., 128:
// cudaErrorInvalidValue before any launch.
extern "C" int iqt_chan_stats_split_block(const void* y, const void* w, const void* tw,
                                          void* part_log, void* part_max, void* log_sum,
                                          void* max_out, void* chp, void* pbin, const int* plan,
                                          int n_tw, int lg_l, int batch, int row_len,
                                          int n_frames, int nfft, int navg, int channel_count,
                                          int abins, int skip_half, int frames_per_block,
                                          int n_blocks, int c, int m, int lt, int max_smem,
                                          void* stream) {
  const int lg_navg = CH::navg_log2(navg);
  const S::RadixPlan p = S::plan_from(plan);
  const int n_tables = block_tables(m);
  const int n_hi = lg_l >= 0 && lg_l < 16 ? (nfft + (1 << lg_l) - 1) >> lg_l : -1;
  if (lg_navg < 0 || n_tables < 0 || c > kMaxParts || static_cast<long long>(c) * m != nfft ||
      !plan_of(c, p) ||
      lt < kMinTileLog2 || lt > 9 || m % (1 << lt) || n_hi < 1 ||
      (1LL << (2 * lg_l)) < nfft || n_tw != n_tables + c + n_hi + (1 << lg_l))
    return cudaErrorInvalidValue;
  const bool psd = part_log != nullptr;
  const Layout l =
      layout(c, m, n_tables, lt, p.stages, pbin != nullptr && lg_navg > 5, psd, max_smem);
  if (l.bytes > CH::kSmemOptin) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto tab = static_cast<const float2*>(tw);
  auto pl = static_cast<float*>(part_log);
  auto pm = static_cast<float*>(part_max);
  const dim3 grid(n_blocks, batch);
  cudaError_t err = cudaErrorInvalidValue;
#define IQT_LAUNCH(M, TM, G)                                                                  \
  if (m == M)                                                                                 \
    err = launch<M, TM, G>(grid, l.bytes, s, static_cast<const float2*>(y),                   \
                           static_cast<const float2*>(w), tab, tab + n_tables + c,            \
                           tab + n_tables + c + n_hi, lg_l, pl, pm, static_cast<float*>(chp), \
                           static_cast<float*>(pbin), row_len, n_frames, c, channel_count,    \
                           abins, skip_half, frames_per_block, lg_navg, lt, max_smem, p);
  IQT_CHAN_BLOCK_PARTS(IQT_LAUNCH)
#undef IQT_LAUNCH
  if (err != cudaSuccess || part_log == nullptr) return err;
  return CH::launch_fold(pl, pm, static_cast<float*>(log_sum), static_cast<float*>(max_out), batch,
                         n_blocks, nfft, c, s);
}
