// Cyclic-prefix correlation of a capture at a set of CP start indices.
//
// Replaces: iqwaveform_tpu/ops/pallas/corr_pallas.py
//   corr_at_indices_pallas (_movsum_norm_kernel).
//
// With z[t] = x[t] conj(x[t + nfft]) and CP rows s + [0, ncp):
//
//   out[j] = sum_s sum_{c < ncp} z[s + c + j] = movsum_ncp(acc)[j],
//   acc[l] = sum_s z[s + l],  l in [0, span), span = n_lags + ncp - 1,
//
// for the lags j in [0, n_lags = nfft + ncp), and the same sums of |a|^2
// and |b|^2 (a = x[t], b = x[t + nfft]) for the normalization. A pair with
// t + nfft >= n contributes zero, as the JAX kernel's zero pad does. The TPU
// kernel takes the moving sum as a matrix product against a banded 0/1
// operator, for its matrix unit; here it is a plain loop over shared
// memory.
//
// What bounds it on an H100: bytes. The index set of a whole capture
// touches every sample once as a and once as b, and reading it once is 8 B
// a sample: 246 MB for 1 s at 30.72 MS/s, 0.073 ms at 3.35 TB/s. The
// arithmetic, about 12 flop per start and position, is some 0.4 GFLOP
// there, far below that.
//
// Pass 1 (corr_ring_kernel<P>): a block owns a run of consecutive sorted
// starts (a group) and a tile of acc positions [l0, l0 + len): one tile
// unless a window outgrows shared memory. Start s needs x[s + l] and
// x[s + l + nfft] for l in the tile, the window [s + l0, s + l0 + len +
// nfft). Consecutive windows overlap (at LTE 20 MHz a window is 4383
// samples and starts are 2192-2208 apart), so the block keeps the stretch
// its windows cover in a ring in shared memory and brings in only the part
// of each window past what the ring holds, with 1-D bulk copies
// (cp.async.bulk, the TMA) that complete on the window's mbarrier. A gap
// between windows (a sparse symbol set, frames far apart) is skipped: the
// next piece follows the last in the ring, wherever it lies in the
// capture. One thread starts the copies kStages - 1 windows ahead of the
// arithmetic; the ring holds kStages windows, so a piece never lands on a
// slot a window still in use reads. Each thread keeps four sums (Re z,
// Im z, |a|^2, |b|^2) for each of its P positions in registers and reads a
// and b from the ring: the capture passes through L2 about once, not once
// as a and once as b.
//   Where a ring of kStages windows of len + nfft does not fit, the a and b
// sub-windows [s + l0, + len) and [s + l0 + nfft, + len) go to two rings
// (split), and the lags are tiled so that both fit.
//   Bulk copies take 16-byte addresses and sizes, and a sample is 8 B. The
// kernel addresses x from the 16-byte-aligned element below it (h = 1 for
// a view such as x[1:]): pieces start and end on even elements, and copies
// are clamped to the 16-byte granules inside x. A sample of x at an odd
// end of that range is stored by the producing thread itself. Ring slots
// of elements outside x are never read into a sum: a pair with t >= n -
// nfft is skipped by the same test as the plain version's zero pad.
// Pass 2 (corr_fold_kernel): the groups' partials summed in a fixed order:
// lane j of a column sums groups j, j + 8, ... in order, then the lanes are
// summed in order. Skipped with one group.
// Pass 3 (corr_finish_kernel): a block owns a tile of lags, takes the
// ncp-wide moving sum of the folded sums of its tile plus the ncp - 1 halo
// in shared memory, and normalizes: (re, im) / sqrt(sum|a|^2 sum|b|^2),
// which is 0/0 = NaN at a lag whose pairs all fall past the end, or (re,
// im) / (n_starts ncp). No float atomics: the result is the same on every
// run. Offsets into the capture are 64-bit.
#include <cstdint>

#include "fft.cuh"

namespace {

constexpr int kRingThreads = 256;  // pass 1: threads per block, at most
constexpr int kHeader = 128;       // pass 1: shared bytes before the ring
constexpr int kStages = 3;         // pass 1: windows a ring holds
constexpr int kFoldCols = 32;      // pass 2: columns per block
constexpr int kFoldLanes = 8;      // pass 2: lanes per column
constexpr int kTileLags = 128;     // pass 3: lags per block

// what the producing thread tells the others about one start
struct Window {
  int ra;   // ring slot of x[s + l0]
  int rb;   // ring slot of x[s + l0 + nfft]
  int rem;  // positions of the tile whose pairs lie inside x (may be <= 0)
};
static_assert(kStages * (8 + sizeof(Window)) <= kHeader, "header");

// one ring's fill: the element past the last one brought in (even; -1
// before the first) and its slot
struct Fill {
  long long end;
  int slot;
};

struct Copy {
  float2* dst;
  const float2* src;
  int len;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits for the phase of `parity` to complete; a copy that never lands
// traps (a launch failure the wrapper raises) instead of spinning forever
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (long long tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1LL << 26)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(float2* dst, const float2* src,
                                          int len, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(static_cast<uint32_t>(len) * 8u), "r"(smem_u32(bar))
      : "memory");
}

// plans the copies that bring the window [e, e + w) of one ring in: the
// part past what the ring holds, from an even element to an even end;
// stores the samples at an odd end of x (edge_lo, edge_hi: their elements,
// or -1) itself. Returns the ring slot of element e.
__device__ __forceinline__ int bring(Fill& f, long long e, int w, int ring_len,
                                     float2* ring, const float2* xa,
                                     long long g0, long long g1,
                                     long long edge_lo, long long edge_hi,
                                     Copy* copies, int& n_copies) {
  const long long p1 = (e + w + 1) & ~1LL;
  long long p0;
  int slot_e;
  if (e < f.end) {  // the window overlaps what the ring holds
    p0 = f.end;
    slot_e = f.slot - static_cast<int>(f.end - e);
    if (slot_e < 0) slot_e += ring_len;
  } else {  // the first window, or one past a gap: a new run
    p0 = e & ~1LL;
    slot_e = f.slot + static_cast<int>(e - p0);
    if (slot_e >= ring_len) slot_e -= ring_len;
  }
  if (p1 <= p0) return slot_e;  // a repeated start: nothing new
  const int slot0 = f.slot;
  const long long c0 = max(p0, g0), c1 = min(p1, g1);
  if (c1 > c0) {
    int slot = slot0 + static_cast<int>(c0 - p0);
    if (slot >= ring_len) slot -= ring_len;
    const int len = static_cast<int>(c1 - c0);
    const int first = min(len, ring_len - slot);
    copies[n_copies++] = {ring + slot, xa + c0, first};
    if (len > first) copies[n_copies++] = {ring, xa + c0 + first, len - first};
  }
  const long long edges[2] = {edge_lo, edge_hi};
  for (long long edge : edges) {
    if (edge >= p0 && edge < p1) {
      int slot = slot0 + static_cast<int>(edge - p0);
      if (slot >= ring_len) slot -= ring_len;
      ring[slot] = xa[edge];
    }
  }
  f.end = p1;
  f.slot = slot0 + static_cast<int>(p1 - p0);
  if (f.slot >= ring_len) f.slot -= ring_len;
  return slot_e;
}

// xa: the 16-byte-aligned element h (0 or 1) below x[0]; x has n samples.
// Block (tile, group) writes part[group][0..3][l0 + l] for l < len.
template <int P>
__global__ void __launch_bounds__(kRingThreads, 2)
corr_ring_kernel(const float2* __restrict__ xa, long long n,
                 const long long* __restrict__ starts, float* __restrict__ part,
                 int h, int nfft, int n_starts, int group_size, int span,
                 int tile, int split, int ring_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  Window* windows = reinterpret_cast<Window*>(smem + 8 * kStages);
  float2* ring_a = reinterpret_cast<float2*>(smem + kHeader);
  float2* ring_b = split ? ring_a + ring_len : ring_a;

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int l0 = blockIdx.x * tile;
  const int len = min(tile, span - l0);
  const int w = split ? len : len + nfft;
  const int g = blockIdx.y;
  const int i0 = g * group_size;
  const int count = min(group_size, n_starts - i0);
  constexpr int ahead = kStages - 1;

  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) bar_init(&bars[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the producing thread's state (thread 0; the others never use it)
  Fill fa{-1, 0}, fb{-1, 0};
  const long long g0 = h ? 2 : 0;         // the 16-byte granules inside x
  const long long g1 = (n + h) & ~1LL;
  const long long edge_lo = h ? 1 : -1;   // x[0] at an odd element
  const long long last = n + h - 1;       // x[n - 1] at an even element
  const long long edge_hi = (n > 0 && (last & 1) == 0) ? last : -1;
  const long long limit = n - nfft;       // pairs at t >= limit fall past the end

  auto produce = [&](int stage, long long s) {
    Copy copies[4];
    int n_copies = 0;
    const long long e = s + l0 + h;
    Window win;
    win.ra = bring(fa, e, w, ring_len, ring_a, xa, g0, g1, edge_lo, edge_hi,
                   copies, n_copies);
    if (split) {
      win.rb = bring(fb, e + nfft, w, ring_len, ring_b, xa, g0, g1, edge_lo,
                     edge_hi, copies, n_copies);
    } else {
      win.rb = win.ra + nfft;
      if (win.rb >= ring_len) win.rb -= ring_len;
    }
    win.rem = static_cast<int>(
        max(-1LL, min(static_cast<long long>(len), limit - s - l0)));
    windows[stage] = win;
    uint32_t bytes = 0;
    for (int c = 0; c < n_copies; ++c) bytes += 8u * copies[c].len;
    // order the ring's earlier generic stores before the bulk writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_arrive_tx(&bars[stage], bytes);
    for (int c = 0; c < n_copies; ++c) {
      bulk_load(copies[c].dst, copies[c].src, copies[c].len, &bars[stage]);
    }
  };

  long long s_next = 0;  // the start produced next, loaded an iteration early
  if (tid == 0) {
    for (int k = 0; k < min(ahead, count); ++k) produce(k, starts[i0 + k]);
    if (ahead < count) s_next = starts[i0 + ahead];
  }

  float acc[P][4];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
  }
  int stage = 0, pstage = ahead;
  uint32_t parity = 0;
  for (int i = 0; i < count; ++i) {
    if (tid == 0 && i + ahead < count) {
      // the stage of start i - 1, which every thread has finished reading
      produce(pstage, s_next);
      if (i + ahead + 1 < count) s_next = starts[i0 + i + ahead + 1];
    }
    if (++pstage == kStages) pstage = 0;
    bar_wait(&bars[stage], parity);
    const Window win = windows[stage];
    const int lim = min(len, win.rem);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int l = tid + k * T;
      if (l < lim) {
        int ia = win.ra + l;
        if (ia >= ring_len) ia -= ring_len;
        int ib = win.rb + l;
        if (ib >= ring_len) ib -= ring_len;
        const float2 a = ring_a[ia];
        const float2 b = ring_b[ib];
        acc[k][0] += a.x * b.x + a.y * b.y;
        acc[k][1] += a.y * b.x - a.x * b.y;
        acc[k][2] += a.x * a.x + a.y * a.y;
        acc[k][3] += b.x * b.x + b.y * b.y;
      }
    }
    __syncthreads();
    if (++stage == kStages) {
      stage = 0;
      parity ^= 1u;
    }
  }

  float* p = part + static_cast<long long>(g) * 4 * span + l0;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int l = tid + k * T;
    if (l < len) {
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r * span + l] = acc[k][r];
    }
  }
}

// acc[c] = sum_g part[g][c] for the columns c < rows * span of a group's
// (4, span) partials, in a fixed order
__global__ void __launch_bounds__(kFoldCols* kFoldLanes)
corr_fold_kernel(const float* __restrict__ part, float* __restrict__ acc,
                 int n_groups, int span, int rows) {
  __shared__ float sums[kFoldLanes][kFoldCols];
  const int c = blockIdx.x * kFoldCols + threadIdx.x;
  const int j = threadIdx.y;
  const bool live = c < rows * span;
  float s = 0.f;
  if (live) {
    const long long stride = 4LL * span;
    for (int gi = j; gi < n_groups; gi += kFoldLanes) s += part[gi * stride + c];
  }
  sums[j][threadIdx.x] = s;
  __syncthreads();
  if (j == 0 && live) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kFoldLanes; ++q) t += sums[q][threadIdx.x];
    acc[c] = t;
  }
}

// sums: the folded (4, span) sums, rows k < `rows` at k * span
__global__ void __launch_bounds__(kTileLags)
corr_finish_kernel(const float* __restrict__ sums, float2* __restrict__ out,
                   int span, int n_lags, int ncp, bool norm, float scale) {
  extern __shared__ float acc[];
  const int j0 = blockIdx.x * blockDim.x;
  const int width = blockDim.x + ncp - 1;
  const int rows = norm ? 4 : 2;
  for (int k = 0; k < rows; ++k) {
    for (int q = threadIdx.x; q < width; q += blockDim.x) {
      const int l = j0 + q;
      acc[k * width + q] = l < span ? sums[static_cast<long long>(k) * span + l] : 0.f;
    }
  }
  __syncthreads();

  const int j = j0 + threadIdx.x;
  if (j >= n_lags) return;
  // the rows' sums side by side: four independent chains of ncp adds
  float m[4] = {0.f, 0.f, 0.f, 0.f};
  const float* row = acc + threadIdx.x;
  for (int c = 0; c < ncp; ++c) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < rows) m[k] += row[k * width + c];
    }
  }
  if (norm) {
    const float d = sqrtf(m[2] * m[3]);
    out[j] = make_float2(m[0] / d, m[1] / d);
  } else {
    out[j] = make_float2(m[0] / scale, m[1] / scale);
  }
}

// the positions a thread of the ring kernel holds: the compiled instances
// (P_SET in ops/kernels/corr.py)
#define IQT_CORR_P(X) X(1) X(2) X(4) X(6) X(8) X(10) X(12) X(16)

}  // namespace

// once per device, before the first launch: allow up to `max_smem` bytes
// of dynamic shared memory for every ring instance and pass 3
extern "C" int iqt_corr_prepare(int max_smem) {
  cudaError_t err;
#define IQT_ALLOW(P)                                            \
  err = iqt::allow_smem(corr_ring_kernel<P>, max_smem);         \
  if (err != cudaSuccess) return err;
  IQT_CORR_P(IQT_ALLOW)
#undef IQT_ALLOW
  return iqt::allow_smem(corr_finish_kernel, max_smem);
}

// xa: the 16-byte-aligned element h (0 or 1) below the (n,) complex64
// capture; starts: (n_starts,) int64, sorted, non-negative; part:
// (n_groups, 4, span) float32 scratch with n_groups * group_size >=
// n_starts; acc: (4, span) float32 scratch (unused with one group); out:
// (n_lags,) complex64, n_lags = nfft + ncp, span = n_lags + ncp - 1. The
// ring kernel's grid is (n_tiles, n_groups) blocks of `threads`, each
// holding p positions of a tile of `tile`, with `smem` bytes: a ring (two
// if `split`) of ring_len samples, kStages windows. scale = n_starts * ncp
// (the divisor when norm is 0).
extern "C" int iqt_corr(const void* xa, const void* starts, void* part,
                        void* acc, void* out, long long n, int h, int nfft,
                        int ncp, int n_starts, int group_size, int n_groups,
                        int span, int n_lags, int tile, int n_tiles, int split,
                        int ring_len, int p, int threads, int smem, int norm,
                        float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<float*>(part);
  if (threads > kRingThreads) return cudaErrorInvalidValue;
  const dim3 grid1(n_tiles, n_groups);
  const auto x2 = static_cast<const float2*>(xa);
  const auto st = static_cast<const long long*>(starts);
  switch (p) {
#define IQT_LAUNCH(P)                                                       \
  case P:                                                                   \
    corr_ring_kernel<P><<<grid1, threads, smem, s>>>(                       \
        x2, n, st, pp, h, nfft, n_starts, group_size, span, tile, split,    \
        ring_len);                                                          \
    break;
    IQT_CORR_P(IQT_LAUNCH)
#undef IQT_LAUNCH
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = norm ? 4 : 2;
  const float* folded = pp;
  if (n_groups > 1) {
    auto fa = static_cast<float*>(acc);
    const int blocks = (rows * span + kFoldCols - 1) / kFoldCols;
    corr_fold_kernel<<<blocks, dim3(kFoldCols, kFoldLanes), 0, s>>>(
        pp, fa, n_groups, span, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    folded = fa;
  }
  const size_t smem3 =
      static_cast<size_t>(rows) * (kTileLags + ncp - 1) * sizeof(float);
  corr_finish_kernel<<<(n_lags + kTileLags - 1) / kTileLags, kTileLags, smem3,
                       s>>>(folded, static_cast<float2*>(out), span, n_lags,
                            ncp, norm != 0, scale);
  return cudaGetLastError();
}
