// Device code shared by the channelizer statistics kernels of every frame
// size (csrc/chan_stats.cu, chan_mixed.cu, chan_cluster.cu): the binned
// power of one sample from the lanes of a warp, the warp sum of a run of
// bins, the shared-memory plan of a block's statistics, and the fixed-order
// fold of the blocks' partials.
#pragma once

#include <math.h>

#include "fft_reg.cuh"

namespace iqt {
namespace chan {

constexpr float kEps = 1e-25f;
// an H100 block's opt-in dynamic shared memory
constexpr size_t kSmemOptin = 232448;

// The detector-binned power of the sample at index i of a frame (i in the
// lane's own warp-aligned run of 32 consecutive indices, every lane of the
// warp active), navg = 2^lg with lg <= 7. Each lane holds p = |y_i|^2; a
// butterfly of shuffles (offsets 1, 2, ..., a fixed order) sums groups of
// min(navg, 32) lanes, and the group's first lane writes the mean to
// pb[i >> lg] (navg <= 32) or the sum of its 32 samples to ws[i >> 5] for
// bin_fold (navg 64, 128).
__device__ __forceinline__ void bin_sample(float p, int i, int lg, float* pb, float* ws) {
  const int g = lg < 5 ? 1 << lg : 32;
  for (int o = 1; o < g; o <<= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
  if ((threadIdx.x & (g - 1)) != 0) return;
  if (lg <= 5) {
    pb[i >> lg] = p * (1.0f / static_cast<float>(1 << lg));
  } else {
    ws[i >> 5] = p;
  }
}

// bins [q0, q1) of navg = 2^lg > 32 from bin_sample's sums of 32, in
// order, by the threads of the block
__device__ __forceinline__ void bin_fold(const float* ws, int lg, int q0, int q1, float* pb) {
  const int per = 1 << (lg - 5);
  const float scale = 1.0f / static_cast<float>(1 << lg);
  for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < per; ++j) s += ws[q * per + j];
    pb[q] = s * scale;
  }
}

// lg of navg in 1, 2, 4, ..., 128 (the binnings of bin_sample); -1 for
// any other value
__host__ __device__ constexpr int navg_log2(int navg) {
  int lg = 0;
  while (lg < 7 && (1 << lg) < navg) ++lg;
  return (1 << lg) == navg ? lg : -1;
}

// The running statistics of m bins, bin k held by thread k mod
// blockDim.x of the block: ln sums `ls` and maxima `mx` (shared or device
// memory), reset, folded with one frame's |Y|^2 `sp`, and written to the
// block's partials (the maxima only where they are not kept there).
__device__ __forceinline__ void stats_reset(float* ls, float* mx, int m) {
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    ls[k] = 0.f;
    mx[k] = -INFINITY;
  }
}

__device__ __forceinline__ void stats_add(const float* sp, float* ls, float* mx, int m) {
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const float p = sp[k];
    ls[k] += logf(p + kEps);
    mx[k] = fmaxf(mx[k], p);
  }
}

__device__ __forceinline__ void stats_write(const float* ls, const float* mx, bool max_in_smem,
                                            float* part_log, float* part_max, int m) {
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    part_log[k] = ls[k];
    if (max_in_smem) part_max[k] = mx[k];
  }
}

// the warp's sum of sp[k0 .. k1): lane l adds k0 + l, k0 + l + 32, ... in
// order, then a shuffle tree; the sum is in lane 0
__device__ __forceinline__ float warp_run_sum(const float* sp, int k0, int k1) {
  float s = 0.f;
  for (int k = k0 + static_cast<int>(threadIdx.x & 31); k < k1; k += 32) s += sp[k];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

// A frame loop around the register-resident passes keeps their index math
// live across the loop, and ptxas spills it: the thread's lane (and, in a
// cluster, the block's rank) are read anew at each pass, from the special
// registers, through asm the compiler may not hoist, so that each pass
// recomputes its indices where it runs.
__device__ __forceinline__ int fresh_lane() {
  int lane;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(lane));
  return lane;
}

__device__ __forceinline__ int fresh_rank() {
  int rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  return rank;
}

// passes S, S + 1, ... of N's forward transform by the T threads of a
// block, each with a fresh lane: the middle passes through the padded
// `buf`, the last to `last(k, v)`; a barrier between the loads and the
// stores of each pass, and after each middle pass
template <int N, int S, int T, class Last>
__device__ __forceinline__ void passes_from(float2* buf, const float2* tw, Last last) {
  const auto sync = [] { __syncthreads(); };
  const auto load = [buf](int, int i) { return buf[reg::pad(i)]; };
  if constexpr (S < reg::Plan<N>::stages - 1) {
    reg::pass_lane<N, S, false, T, true>(
        fresh_lane(), tw, load, [buf](int, int i, float2 v) { buf[reg::pad(i)] = v; }, sync);
    __syncthreads();
    passes_from<N, S + 1, T>(buf, tw, last);
  } else {
    reg::pass_lane<N, S, false, T, true>(
        fresh_lane(), tw, load, [&last](int, int k, float2 v) { last(k, v); }, sync);
  }
}

// One block's shared memory for the statistics of M bins a frame: the
// padded exchange buffer, the forward pass tables, the binned-power
// scratch (n_scratch floats), the running sums of ln(|Y|^2 + 1e-25) (M
// floats) and, where it still fits the opt-in limit, the running maxima
// (M floats); otherwise the maxima run in the block's row of the partials
// in device memory (L2), read and written once a frame.
template <int M, int SCRATCH>
struct StatsSmem {
  static constexpr int exchange = reg::padded_size(M);
  static constexpr int tables = reg::table_total<M>();
  static constexpr size_t head = static_cast<size_t>(exchange + tables) * sizeof(float2) +
                                 static_cast<size_t>(SCRATCH + M) * sizeof(float);
  static constexpr bool max_in_smem = head + M * sizeof(float) <= kSmemOptin;
  static constexpr size_t bytes = head + (max_in_smem ? M * sizeof(float) : 0);
  static_assert(head <= kSmemOptin, "the exchange, tables and sums fit one block");
};

// The frame sizes of one block and its threads, F(N, T): T = N / 16 (one
// radix-16 butterfly a thread a pass) up to 512 threads; pass 0 of each
// plan is radix 16, with N / 16 butterflies a multiple of 32, so that its
// loads run in whole warps (bin_sample). IQT_CHAN_STATS_SIZES, those of
// chan_stats_mixed_kernel, lack 15360: with the frame loop its 30 points a
// thread spill under every plan of radices up to 16 (ptxas), so its
// statistics run on a cluster of 5 x 3072 (csrc/chan_cluster.cu).
#define IQT_CHAN_STATS_SIZES(F) \
  F(1024, 64)                   \
  F(2048, 128)                  \
  F(3072, 192)                  \
  F(4096, 256)                  \
  F(5120, 320)                  \
  F(6144, 384)                  \
  F(8192, 512)                  \
  F(10240, 512)                 \
  F(12288, 512)                 \
  F(16384, 512)
#define IQT_CHAN_SIZES(F) IQT_CHAN_STATS_SIZES(F) F(15360, 512)

namespace {

// psd_log_sum / psd_max per (row, bin) from the blocks' partials (batch,
// n_blocks, nfft), in a fixed order: a group of W warps (W the least power
// of two >= n_blocks, at most 32) owns 32 partial entries (one a lane);
// warp w of the group folds blocks w, w + W, ..., and the group's first
// warp then folds its W warps' results in warp order. At every W that is
// the order of W = 32 (warps past the last block hold 0 and -inf, which
// the fold's last steps add exactly), so the result does not depend on W;
// a small W spares the 32 warps a bin that one block's partials would keep
// mostly idle.
//
// A partial row holds the bins of C parts, part r's M = nfft / C bins C k +
// r at entry j = r M + k (C = 1: natural order). A block of 32 warps owns
// a tile of its 32 / W groups' entries: TK = 2^lg_tk consecutive k of each
// of 32 (32 / W) / TK consecutive parts r, so that its lanes read TK
// consecutive entries of a part and its bins C k + r, run through a
// transpose in shared memory, are written in runs of the tile's parts
// (the whole tile's C TK bins at once where it holds every part; at W = 32
// and C above 4, one part's 32 entries, as the fold's first form).
constexpr int kFoldWarps = 32;

__global__ void __launch_bounds__(kFoldWarps * 32)
chan_fold_kernel(const float* __restrict__ part_log, const float* __restrict__ part_max,
                 float* __restrict__ log_sum, float* __restrict__ max_out, int n_blocks,
                 int nfft, int c, int lg_w, int lg_tk) {
  __shared__ float ws[kFoldWarps][32], wx[kFoldWarps][32];
  __shared__ float ts[kFoldWarps * 32], tx[kFoldWarps * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp >> lg_w;
  const int wl = warp - (group << lg_w);
  const int lg_rows = 10 - lg_w - lg_tk;  // parts a tile
  const int per = nfft / c;
  const int row_tiles = (c + (1 << lg_rows) - 1) >> lg_rows;
  const int kt = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x - kt * row_tiles) << lg_rows;
  const int q = group * 32 + lane;  // the entry's slot in the tile
  const int r = r0 + (q >> lg_tk);
  const int k = (kt << lg_tk) + (q & ((1 << lg_tk) - 1));
  const long long row = blockIdx.y;
  float s = 0.f;
  float m = -INFINITY;
  if (r < c) {
    const long long j = static_cast<long long>(r) * per + k;
    for (int b = wl; b < n_blocks; b += 1 << lg_w) {
      const long long i = (row * n_blocks + b) * nfft + j;
      s += part_log[i];
      m = fmaxf(m, part_max[i]);
    }
  }
  ws[warp][lane] = s;
  wx[warp][lane] = m;
  __syncthreads();
  if (wl == 0) {
    s = 0.f;
    m = -INFINITY;
    for (int v = warp; v < warp + (1 << lg_w); ++v) {
      s += ws[v][lane];
      m = fmaxf(m, wx[v][lane]);
    }
    // the tile in bin order: k first, then r
    const int at = ((q & ((1 << lg_tk) - 1)) << lg_rows) + (q >> lg_tk);
    ts[at] = s;
    tx[at] = m;
  }
  __syncthreads();
  const int p = threadIdx.x;
  if (p >= (kFoldWarps * 32) >> lg_w) return;
  const int rp = r0 + (p & ((1 << lg_rows) - 1));
  if (rp >= c) return;
  const long long bin = row * nfft + static_cast<long long>(c) * ((kt << lg_tk) + (p >> lg_rows)) + rp;
  log_sum[bin] = ts[p];
  max_out[bin] = tx[p];
}

cudaError_t launch_fold(const float* part_log, const float* part_max, float* log_sum,
                               float* max_out, int batch, int n_blocks, int nfft, int c,
                               cudaStream_t stream) {
  int lg_w = 0;
  while (lg_w < 5 && (1 << lg_w) < n_blocks) ++lg_w;
  // TK: the tile's parts all of C where at least 8 k a part fit; else 8 k
  // of as many parts as fit (one 32-byte sector a part), but at W = 32 (a
  // tile of 32 entries) 32 k of one part, its bins written at a stride of C
  const int lg_slots = 10 - lg_w;
  int lg_tk = lg_slots;
  if (c > 1) {
    int lg_c = 0;
    while ((1 << lg_c) < c) ++lg_c;
    lg_tk = lg_slots - lg_c;
    if (lg_tk < 3) lg_tk = lg_w == 5 ? lg_slots : 3;
  }
  const int per = nfft / c;
  if (nfft % c || per % (1 << lg_tk)) return cudaErrorInvalidValue;
  const int row_tiles = (c + (1 << (lg_slots - lg_tk)) - 1) >> (lg_slots - lg_tk);
  chan_fold_kernel<<<dim3((per >> lg_tk) * row_tiles, batch), kFoldWarps * 32, 0, stream>>>(
      part_log, part_max, log_sum, max_out, n_blocks, nfft, c, lg_w, lg_tk);
  return cudaGetLastError();
}

}  // namespace

}  // namespace chan
}  // namespace iqt
