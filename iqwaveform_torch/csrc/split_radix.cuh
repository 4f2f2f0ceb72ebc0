// The radix-C step of the split routes (csrc/ola_split.cu, the frame-batch
// OLA chain; csrc/chan_split.cu, the channelizer statistics): the C-point
// DFT across the C parts of M points of a frame of N = C M points, on TN
// consecutive offsets n < M at once (a tile), in shared memory.
//
// A block holds the tile's C TN points, element c of column t at c TN + t,
// in two buffers, and runs the C-point DFT of every column as Stockham
// passes over the step's plan (RadixPlan): radices 2, 3, 4, 5 and 7 through
// the butterflies of csrc/fft.cuh (dft_small), any prime p above 7 through
// a generic pass that computes each of its p outputs as a sum of p terms,
// O(p) operations a point. Every twiddle, of the passes and of the DFTs in
// them, comes from one table tab = exp(-+2 pi i j / C), j < C, with the
// direction's sign, built on the host in float64 and rounded once.
//
// The tile: TN = 2^lt, the widest power of two up to 512 columns with C TN
// <= kPoints (tile_log2): 512 columns at C <= 4, 32 at C = 64, one at C
// above 1024. Its shared memory (radix_smem) is dynamic: two buffers of C
// TN points and the table of C entries, at most 48 KiB at C = 2048.
#pragma once

#include "fft.cuh"

namespace iqt {
namespace split {

constexpr int kRadixThreads = 256;
constexpr int kMaxC = 2048;
constexpr int kPoints = 2048;
// 2048 = 2^11: no C up to kMaxC has more prime factors
constexpr int kMaxStages = 11;

// a radix step's plan: its radices in the order of the passes (those of
// ops/kernels/_build.py split_radices: 4s, a 2, 3s, 5s, 7s, then the primes
// above 7 in ascending order)
struct RadixPlan {
  int stages;
  int radix[kMaxStages];
};

// log2 of the tile width at C parts: the widest power of two from 1 to 512
// columns with C TN <= kPoints
__host__ __device__ constexpr int tile_log2(int c) {
  int lt = 9;
  while (lt > 0 && (c << lt) > kPoints) --lt;
  return lt;
}

// a radix step's dynamic shared memory at C parts: two buffers of the
// tile, then the table
__host__ __device__ constexpr size_t radix_smem(int c) {
  return (2 * static_cast<size_t>(c << tile_log2(c)) + c) * sizeof(float2);
}

// whether p is a prime (the generic pass's radices; csrc/fft.cuh)
using iqt::is_prime;

// a plan the step runs at C parts (C <= kMaxC): radices of 2, 3, 4, 5, 7
// or a prime above 7 whose product is C
inline bool plan_ok(int c, const RadixPlan& plan) {
  if (c < 1 || c > kMaxC) return false;
  if (plan.stages < 0 || plan.stages > kMaxStages) return false;
  long long prod = 1;
  for (int s = 0; s < plan.stages; ++s) {
    const int r = plan.radix[s];
    if (r != 4 && !is_prime(r)) return false;
    prod *= r;
  }
  return prod == c;
}

// the same at parts of M points that the tile divides (TN = 2^tile_log2(C)
// columns a block, none ragged)
inline bool plan_ok(int c, int m, const RadixPlan& plan) {
  return m >= 1 && m % (1 << tile_log2(c)) == 0 && plan_ok(c, plan);
}

// one Stockham pass of radix RADIX over the C-point columns of `src`, by
// the THREADS threads of the block:
// butterfly b < C / RADIX, k = b mod ns, reads points b + r C / RADIX,
// multiplies point r by exp(-+2 pi i r k / (ns RADIX)) = tab[r k C / (ns
// RADIX)], takes the RADIX-point DFT and writes point r to (b - k) RADIX + k
// + r ns of `dst`. A warp takes 32 columns of one butterfly where TN >= 32:
// conflict-free.
// The pass reads point (row, t) through `load(row, t)` (row < C, t < TN):
// radix_pass below reads it from a buffer of C TN points, element row TN +
// t; radix_step_from's first pass from wherever its caller keeps the tile.
template <int RADIX, bool INV, int THREADS = kRadixThreads, class Load>
__device__ __forceinline__ void radix_pass_from(Load load, float2* dst, const float2* tab, int c,
                                                int ns, int lt) {
  const int nb = c / RADIX;
  const int step = c / (ns * RADIX);
  const int tn = 1 << lt;
  for (int e = threadIdx.x; e < nb << lt; e += THREADS) {
    const int t = e & (tn - 1);
    const int b = e >> lt;
    const int k = b % ns;
    float2 v[RADIX];
#pragma unroll
    for (int r = 0; r < RADIX; ++r) v[r] = load(b + r * nb, t);
#pragma unroll
    for (int r = 1; r < RADIX; ++r) v[r] = cmul(v[r], tab[r * k * step]);
    dft_small<RADIX>(v, INV);
    const int base = (b - k) * RADIX + k;
#pragma unroll
    for (int r = 0; r < RADIX; ++r) dst[((base + r * ns) << lt) + t] = v[r];
  }
}

template <int RADIX, bool INV, int THREADS = kRadixThreads>
__device__ __forceinline__ void radix_pass(const float2* src, float2* dst, const float2* tab,
                                           int c, int ns, int lt) {
  radix_pass_from<RADIX, INV, THREADS>(
      [src, lt](int row, int t) { return src[(row << lt) + t]; }, dst, tab, c, ns, lt);
}

// the same pass at a prime radix p above 7, one output point a thread: output
// r of butterfly b (b < C / p, k = b mod ns) is sum_j src[b + j C / p] exp(-+2
// pi i j (k / (ns p) + r / p)), and the exponent j (k + r ns) C / (ns p) is
// an index of tab taken mod C, so each term costs one table read and one
// complex multiply-add. Term j goes to accumulator j mod kPrimeAcc, in
// order, and the accumulators are added as a tree: a large p rounds as
// p / kPrimeAcc terms in a row.
constexpr int kPrimeAcc = 8;

template <bool INV, int THREADS = kRadixThreads, class Load>
__device__ __forceinline__ void prime_pass_from(Load load, float2* dst, const float2* tab, int c,
                                                int p, int ns, int lt) {
  const int nb = c / p;
  const int step = c / (ns * p);
  const int tn = 1 << lt;
  for (int e = threadIdx.x; e < c << lt; e += THREADS) {
    const int t = e & (tn - 1);
    const int o = e >> lt;
    const int r = o / nb;
    const int b = o - r * nb;
    const int k = b % ns;
    const int q = (k + r * ns) * step;  // < ns p step = C
    float2 acc[kPrimeAcc];
#pragma unroll
    for (int a = 0; a < kPrimeAcc; ++a) acc[a] = make_float2(0.f, 0.f);
    int at = 0;
    for (int j0 = 0; j0 < p; j0 += kPrimeAcc) {
#pragma unroll
      for (int a = 0; a < kPrimeAcc; ++a) {
        if (j0 + a < p) {
          const float2 v = load(b + (j0 + a) * nb, t);
          const float2 w = tab[at];
          acc[a].x = fmaf(v.x, w.x, fmaf(-v.y, w.y, acc[a].x));
          acc[a].y = fmaf(v.x, w.y, fmaf(v.y, w.x, acc[a].y));
          at += q;
          if (at >= c) at -= c;
        }
      }
    }
#pragma unroll
    for (int h = 1; h < kPrimeAcc; h <<= 1) {
#pragma unroll
      for (int a = 0; a + h < kPrimeAcc; a += 2 * h)
        acc[a] = make_float2(acc[a].x + acc[a + h].x, acc[a].y + acc[a + h].y);
    }
    dst[((((b - k) * p + k) + r * ns) << lt) + t] = acc[0];
  }
}

template <bool INV, int THREADS = kRadixThreads>
__device__ __forceinline__ void prime_pass(const float2* src, float2* dst, const float2* tab,
                                           int c, int p, int ns, int lt) {
  prime_pass_from<INV, THREADS>([src, lt](int row, int t) { return src[(row << lt) + t]; }, dst,
                                tab, c, p, ns, lt);
}

// The same pass at a prime radix p from 11 to kRegPrime, one butterfly
// column a thread: the column's p points in registers, the Stockham
// twiddle exp(-+2 pi i j k / (ns p)) = tab[j k step] on each (j k step < C:
// no wrap), then the p-point DFT by pairs of outputs r and p - r, whose
// kernels are conjugate: with y_j the twiddled points and w = exp(-+2 pi i
// j r / p) = tab[(j r mod p) C / p], A = sum y_j.x w.x, B = sum y_j.y w.y,
// C' = sum y_j.x w.y, D = sum y_j.y w.x over j >= 1 (each in order j = 1,
// 2, ...), output r is (y_0.x + A - B, y_0.y + C' + D) and output p - r
// (y_0.x + A + B, y_0.y + D - C'); output 0 the sum of the points in order.
// 2 (p - 1) fused multiply-adds an output, a column's points read once,
// against prime_pass's p complex multiply-adds and p reads an output. MAXP
// (at most kRegPrime) bounds p: the column takes 2 MAXP registers, which a
// kernel allocates whether or not its plan has such a prime.
constexpr int kRegPrime = 31;

template <bool INV, int THREADS, int MAXP, class Load>
__device__ __forceinline__ void prime_pass_cols(Load load, float2* dst, const float2* tab, int c,
                                                int p, int ns, int lt) {
  static_assert(MAXP >= 11 && MAXP <= kRegPrime, "a prime from 11 to kRegPrime");
  const int nb = c / p;
  const int step = c / (ns * p);
  const int cp = c / p;
  const int tn = 1 << lt;
  for (int e = threadIdx.x; e < nb << lt; e += THREADS) {
    const int t = e & (tn - 1);
    const int b = e >> lt;
    const int k = b % ns;
    float2 v[MAXP];
#pragma unroll
    for (int j = 0; j < MAXP; ++j) {
      if (j < p) {
        v[j] = load(b + j * nb, t);
        if (j > 0 && k > 0) v[j] = cmul(v[j], tab[j * k * step]);
      }
    }
    const int base = (b - k) * p + k;
    float2 s0 = v[0];
#pragma unroll
    for (int j = 1; j < MAXP; ++j) {
      if (j < p) s0 = make_float2(s0.x + v[j].x, s0.y + v[j].y);
    }
    dst[(base << lt) + t] = s0;
    for (int r = 1; 2 * r < p; ++r) {
      float a = 0.f, bb = 0.f, cc = 0.f, d = 0.f;
      int m = 0;
#pragma unroll
      for (int j = 1; j < MAXP; ++j) {
        if (j < p) {
          m += r;
          if (m >= p) m -= p;
          const float2 w = tab[m * cp];
          a = fmaf(v[j].x, w.x, a);
          bb = fmaf(v[j].y, w.y, bb);
          cc = fmaf(v[j].x, w.y, cc);
          d = fmaf(v[j].y, w.x, d);
        }
      }
      dst[((base + r * ns) << lt) + t] = make_float2(v[0].x + (a - bb), v[0].y + (cc + d));
      dst[((base + (p - r) * ns) << lt) + t] = make_float2(v[0].x + (a + bb), v[0].y + (d - cc));
    }
  }
}

// one pass of radix r (2, 3, 4, 5, 7 or a prime above 7: up to MAXP in
// registers, above by prime_pass; MAXP 0: every prime by prime_pass) from
// `load` into dst
template <bool INV, int THREADS, int MAXP, class Load>
__device__ __forceinline__ void any_pass(Load load, float2* dst, const float2* tab, int c, int r,
                                         int ns, int lt) {
  switch (r) {
    case 2: radix_pass_from<2, INV, THREADS>(load, dst, tab, c, ns, lt); break;
    case 3: radix_pass_from<3, INV, THREADS>(load, dst, tab, c, ns, lt); break;
    case 4: radix_pass_from<4, INV, THREADS>(load, dst, tab, c, ns, lt); break;
    case 5: radix_pass_from<5, INV, THREADS>(load, dst, tab, c, ns, lt); break;
    case 7: radix_pass_from<7, INV, THREADS>(load, dst, tab, c, ns, lt); break;
    default:
      if constexpr (MAXP > 0) {
        if (r <= MAXP) {
          prime_pass_cols<INV, THREADS, MAXP>(load, dst, tab, c, r, ns, lt);
          break;
        }
      }
      prime_pass_from<INV, THREADS>(load, dst, tab, c, r, ns, lt);
      break;
  }
}

// The step's C-point DFT of the TN columns in buf[0] (C TN points each of
// buf[0] and buf[1], tab the C entries of the table, all in shared memory;
// the block's writes of buf[0] and tab done before the call, behind a
// barrier) by the THREADS threads of the block. Returns the buffer that
// holds the output (0 or 1); a barrier follows each pass.
template <bool INV, int THREADS = kRadixThreads>
__device__ __forceinline__ int radix_step(float2* const (&buf)[2], const float2* tab, int c,
                                          int lt, const RadixPlan& plan) {
  int cur = 0, ns = 1;
  for (int s = 0; s < plan.stages; ++s) {
    const int r = plan.radix[s];
    float2* const src = buf[cur];
    float2* const dst = buf[cur ^ 1];
    switch (r) {
      case 2: radix_pass<2, INV, THREADS>(src, dst, tab, c, ns, lt); break;
      case 3: radix_pass<3, INV, THREADS>(src, dst, tab, c, ns, lt); break;
      case 4: radix_pass<4, INV, THREADS>(src, dst, tab, c, ns, lt); break;
      case 5: radix_pass<5, INV, THREADS>(src, dst, tab, c, ns, lt); break;
      case 7: radix_pass<7, INV, THREADS>(src, dst, tab, c, ns, lt); break;
      default: prime_pass<INV, THREADS>(src, dst, tab, c, r, ns, lt); break;
    }
    __syncthreads();
    cur ^= 1;
    ns *= r;
  }
  return cur;
}

// radix_step with the tile's points read through `first(row, t)` (row <
// C, t < TN) by the first pass, which writes buf[1]; a plan of one pass (a
// prime C) never touches buf[0]; primes from 11 to MAXP through
// prime_pass_cols. At least one pass; returns the buffer that holds the
// output; a barrier follows each pass.
template <bool INV, int THREADS, int MAXP, class First>
__device__ __forceinline__ int radix_step_from(First first, float2* const (&buf)[2],
                                               const float2* tab, int c, int lt,
                                               const RadixPlan& plan) {
  any_pass<INV, THREADS, MAXP>(first, buf[1], tab, c, plan.radix[0], 1, lt);
  __syncthreads();
  int cur = 1, ns = plan.radix[0];
  for (int s = 1; s < plan.stages; ++s) {
    const int r = plan.radix[s];
    const float2* src = buf[cur];
    any_pass<INV, THREADS, MAXP>([src, lt](int row, int t) { return src[(row << lt) + t]; },
                           buf[cur ^ 1], tab, c, r, ns, lt);
    __syncthreads();
    cur ^= 1;
    ns *= r;
  }
  return cur;
}

// The cross twiddle exp(-2 pi i q / N) of the radix step's output r at
// offset n, q = r n (< C M = N, exact in int), from two tables the host
// builds in float64 and rounds once (ops/kernels/chan_stats.py
// factored_tables): hi[j] = exp(-2 pi i j L / N), lo[l] = exp(-2 pi i l /
// N), L = 2^lg with L^2 >= N; q = (q >> lg) L + (q mod L). Both tables are a
// few thousand entries (2048 + 1024 at N = 2^21), read through the read-only
// cache, in place of an N-entry table of exp(-2 pi i r n / N).
__device__ __forceinline__ float2 cross_twiddle(int q, const float2* __restrict__ hi,
                                                const float2* __restrict__ lo, int lg) {
  return cmul(__ldg(&hi[q >> lg]), __ldg(&lo[q & ((1 << lg) - 1)]));
}

// whether a plan has a prime pass from 11 to maxp (the register column)
inline bool has_prime_upto(const RadixPlan& plan, int maxp) {
  for (int s = 0; s < plan.stages; ++s)
    if (plan.radix[s] >= 11 && plan.radix[s] <= maxp) return true;
  return false;
}

// the host side of a plan: plan[0] stages, plan[1 ..] the radices (the
// wrappers' int array), as a RadixPlan
inline RadixPlan plan_from(const int* plan) {
  RadixPlan p{};
  p.stages = plan[0];
  for (int s = 0; s < p.stages && s < kMaxStages; ++s) p.radix[s] = plan[1 + s];
  return p;
}

}  // namespace split
}  // namespace iqt
