// Register-resident Stockham FFT passes on a plan chosen at run time.
//
// csrc/fft_reg.cuh compiles one plan per size (reg::Plan<N>), so every
// index is a constant; this header runs any size N from a plan the host
// builds (ops/kernels/fused_ola.py plan_radices / frame_plan) and passes to
// the kernel as one __grid_constant__ struct, so that one instance per
// element type covers every size pair.
//
// The plan: radix-16 passes first, then one pass of radix 8, 4 or 2 for the
// rest of 2^a, then the odd radices (3, 5, 7) in ascending order, then the
// primes above 7 in ascending order. The passes are those of fft_reg.cuh
// (autosort, natural order in and out): pass s with radix R, NS = the
// product of the radices before it, NB = N / R butterflies,
//
//   butterfly b < NB, k = b mod NS:
//     v[r] = in[b + r NB]                              r < R
//     v[r] *= exp(sign 2 pi i r k / (NS R))            (none where NS = 1)
//     v = DFT_R(v)                                     in registers
//     out[(b - k) R + k + r NS] = v[r]
//
// Every power-of-two pass comes before the odd ones, so its NS is a power
// of two and k is a mask. An odd pass's NS is not: k = b - q NS with q =
// __umulhi(b, magic) >> shift, the host's multiplier for NS (exact for
// every b < N; tests/test_torch_ola_plan.py checks every b), never `/`.
//
// Each pass of radix 2-16 dispatches on its radix through a switch to a
// function whose radix is a template argument, so the butterfly and its R
// points stay in registers. A thread of a group of G lanes takes
// butterflies lane, lane + G, ...: at most ceil(PMAX / R) of them, PMAX the
// most points a thread holds (the host picks G with N <= PMAX G), all read
// before the group's barrier and written after it (the exchange is in
// place, in shared memory: every pass reads and writes the padded buffer,
// and the caller stages the frame in and reads the transform out).
//
// A prime radix P above 7, known only at run time (pass_prime), takes the
// same pass output by output: a thread computes outputs e = lane + i G of
// the pass (at most PMAX of them), each the sum over j < P of in[b + j NB]
// times exp(sign 2 pi i j (k + r NS) / (NS P)), the Stockham twiddle and
// the P-point DFT in one root of order NS P, from the exchange buffer;
// holds them in the transform's register array until the group's barrier,
// then writes them. O(P) complex multiply-adds a point (Rader or Bluestein
// would take O(log P)): the host puts these passes last, where NS P = N.
//
// Twiddles: pass s's table is (R - 1) rows of nh high factors exp(sign 2 pi
// i r kh LS / (NS R)) then LS low factors exp(sign 2 pi i r kl / (NS R)),
// k = kh LS + kl, LS = 2^ceil(log2(NS) / 2) and at least 16, nh = ceil(NS /
// LS) (0 where NS <= LS), as fft_reg.cuh splits them; a prime pass's is one
// row of nh = ceil(NS P / LS) high roots exp(sign 2 pi i h LS / (NS P))
// then LS low roots exp(sign 2 pi i l / (NS P)), LS = 2^ceil(log2(NS P) /
// 2) and at least 16 (a few hundred entries where one root a point would
// take N). All built on the host in float64, rounded once to float32,
// copied into shared memory once a block. The exchange buffer is padded by
// one float2 in 16 (reg::pad).
#pragma once

#include "fft_reg.cuh"

namespace iqt {
namespace plan {

// the most passes of one transform: 2^15 in radix-16 passes and one of 8,
// 4 or 2, then up to 11 odd radices (the host refuses a plan of more)
constexpr int kMaxPasses = 16;
// a prime pass's terms summed in float32 before each compensated addition
// to the output's running sum (prime_term_sum; at 8, ptxas spilled 4 bytes
// in split_plan_passes_kernel)
constexpr int kPrimeBlock = 4;

// one pass of a plan (all ints, in this order, as the host packs them)
struct Pass {
  int radix;
  int ns;      // the product of the radices before this pass
  int nb;      // N / radix butterflies
  unsigned magic;  // k = b - (__umulhi(b, magic) >> shift) ns (odd radices, ns > 1)
  int shift;
  int tw;      // this pass's table: offset in the frame's tables
  int ls;      // low span LS (a power of two, >= 16; of NS P at a prime P > 7)
  int ls_log2;
  int nh;      // high factors a row (0: none; at a prime, ceil(NS P / LS) >= 1)
  int row;     // nh + ls
};

struct Transform {
  int n;
  int passes;
  Pass pass[kMaxPasses];
};

// the points of pass R's butterflies a thread holds at most
template <int PMAX, int R>
__host__ __device__ constexpr int butterflies() {
  return (PMAX + R - 1) / R;
}

// v[r] *= exp(sign 2 pi i r k / (NS R)) from pass p's table t
template <int R>
__device__ __forceinline__ void twiddle(float2 (&v)[R], int k, const float2* t, const Pass& p) {
  const unsigned kl = static_cast<unsigned>(k) & (p.ls - 1);
  const unsigned kh = static_cast<unsigned>(k) >> p.ls_log2;
#pragma unroll
  for (int r = 1; r < R; ++r) {
    const float2* tr = t + (r - 1) * p.row;
    float2 w = tr[p.nh + kl];
    if (p.nh > 0) w = cmul(tr[kh], w);
    v[r] = cmul(v[r], w);
  }
}

// the barrier of frame group g (`group` lanes): a warp's own, else named
// barrier 1 + g (barrier 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int group, int g) {
  if (group == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(group) : "memory");
  }
}

// The trim between an OLA frame's transforms, read by the inverse's first
// pass: its point j is forward bin in_lo + j - out_lo where j is in
// [out_lo, out_hi) and that bin in [zero_lo, zero_hi), else zero.
struct Trim {
  int zero_lo, zero_hi, in_lo, out_lo, out_hi;
  __device__ float2 read(const float2* buf, int j) const {
    float2 v = make_float2(0.f, 0.f);
    if (j >= out_lo && j < out_hi) {
      const int k = in_lo + (j - out_lo);
      if (k >= zero_lo && k < zero_hi) v = buf[reg::pad(k)];
    }
    return v;
  }
};

// pass p at compile-time radix R in the padded exchange buffer `buf`, for
// lane `lane` of frame group g (`group` lanes): every point of the lane's
// butterflies read into v (the transform's one array of S points a thread,
// shared by every radix: with an array of its own in each radix's body,
// inlined into one switch, ptxas spilled them to a stack frame of their
// summed size, where any one radix alone spilled none), through the trim
// (Trim, or csrc/fft_cluster.cuh ClusterTrim) where TRIM (the inverse's first pass), the barrier
// `mid` (the group's, or the cluster's where the reads reach another
// block's buffer), each butterfly's points written.
template <int R, bool INV, int B, bool TRIM, int S, class Load, class Mid>
__device__ __forceinline__ void pass_r(const Pass& p, float2 (&v)[S], float2* buf,
                                       const float2* tabs, const Load& trim, int lane,
                                       int group, Mid mid) {
  static_assert(B * R <= S, "the shared array holds the pass's points");
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int b = lane + i * group;
    if (b < p.nb) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = b + r * p.nb;
        v[i * R + r] = TRIM ? trim.read(buf, j) : buf[reg::pad(j)];
      }
    }
  }
  mid();
  const float2* t = tabs + p.tw;
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int b = lane + i * group;
    if (b < p.nb) {
      int k;
      if constexpr ((R & (R - 1)) == 0) {
        k = b & (p.ns - 1);
      } else {
        k = p.ns == 1 ? 0
                      : b - static_cast<int>(__umulhi(static_cast<unsigned>(b), p.magic) >>
                                             p.shift) * p.ns;
      }
      float2 u[R];
#pragma unroll
      for (int r = 0; r < R; ++r) u[r] = v[i * R + r];
      if (p.ns > 1) twiddle<R>(u, k, t, p);
      reg::dft<R, INV>(u);
      const int base = (b - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) buf[reg::pad(base + r * p.ns)] = u[r];
    }
  }
}

// s += x in float32 with the rounding error carried in c (Knuth's
// two-sum: exact whatever the magnitudes; no multiplication to contract)
__device__ __forceinline__ void two_sum(float& s, float& c, float x) {
  const float t = s + x;
  const float bp = t - s;
  c += (s - (t - bp)) + (x - bp);
  s = t;
}

// output r of butterfly b of prime pass p (k = b mod NS, step = k + r NS <
// NS P): the sum over j < P of in[b + j NB] exp(sign 2 pi i j step / (NS
// P)), the root of index m = j step mod NS P from the pass's table as
// high[m >> ls_log2] low[m mod LS]. Terms in blocks of kPrimeBlock summed
// in float32, each block added to a compensated sum: the rounding of a
// sum of P terms grows as sqrt(kPrimeBlock), not sqrt(P).
template <bool TRIM, class Load>
__device__ __forceinline__ float2 prime_term_sum(const Pass& p, const float2* buf,
                                                 const float2* t, const Load& trim, int b,
                                                 int step) {
  const int order = p.ns * p.radix;
  const float2* high = t;
  const float2* low = t + p.nh;
  const int lmask = p.ls - 1;
  float sx = 0.f, sy = 0.f, cx = 0.f, cy = 0.f;
  int m = 0, at = b;
#pragma unroll 1
  for (int j0 = 0; j0 < p.radix; j0 += kPrimeBlock) {
    float px = 0.f, py = 0.f;
#pragma unroll
    for (int jj = 0; jj < kPrimeBlock; ++jj) {
      if (j0 + jj < p.radix) {
        const float2 x = TRIM ? trim.read(buf, at) : buf[reg::pad(at)];
        const float2 w = cmul(high[m >> p.ls_log2], low[m & lmask]);
        px = fmaf(x.x, w.x, fmaf(-x.y, w.y, px));
        py = fmaf(x.x, w.y, fmaf(x.y, w.x, py));
        at += p.nb;
        m += step;
        if (m >= order) m -= order;
      }
    }
    two_sum(sx, cx, px);
    two_sum(sy, cy, py);
  }
  return make_float2(sx + cx, sy + cy);
}

// the butterfly b, output r and k = b mod NS of a prime pass's output e =
// r NB + b
__device__ __forceinline__ void prime_output(const Pass& p, int e, int& b, int& r, int& k) {
  r = static_cast<int>(static_cast<unsigned>(e) / static_cast<unsigned>(p.nb));
  b = e - r * p.nb;
  k = p.ns == 1 ? 0
                : b - static_cast<int>(__umulhi(static_cast<unsigned>(b), p.magic) >> p.shift) *
                          p.ns;
}

// pass p at a prime radix P above 7 in the padded exchange buffer, for lane
// `lane` of a group of G lanes (a template argument: with the group's size
// read at run time ptxas spilled in this pass): outputs e = lane + i G (i <
// PMAX, e < N), in the order r NB + b (consecutive lanes read consecutive
// points where NB >= 32), each summed from the buffer (through the trim
// where TRIM), into v[i] of the transform's register array (selected by an
// unrolled compare, so that the array stays in registers while one copy of
// the sum serves every i), the barrier `mid`, each output written to (b -
// k) P + k + r NS. Kept out of pass_r: a per-output loop there would widen
// every radix's register slots.
template <int PMAX, bool TRIM, int G, int S, class Load, class Mid>
__device__ __forceinline__ void pass_prime(const Pass& p, float2 (&v)[S], float2* buf,
                                           const float2* tabs, const Load& trim, int lane,
                                           Mid mid) {
  static_assert(PMAX <= S, "the shared array holds a thread's outputs");
  const int n = p.nb * p.radix;
  const float2* t = tabs + p.tw;
#pragma unroll 1
  for (int i = 0; i < PMAX; ++i) {
    const int e = lane + i * G;
    if (e >= n) break;
    int b, r, k;
    prime_output(p, e, b, r, k);
    const float2 s = prime_term_sum<TRIM>(p, buf, t, trim, b, k + r * p.ns);
#pragma unroll
    for (int u = 0; u < PMAX; ++u)
      if (u == i) v[u] = s;
  }
  mid();
#pragma unroll 1
  for (int i = 0; i < PMAX; ++i) {
    const int e = lane + i * G;
    if (e >= n) break;
    int b, r, k;
    prime_output(p, e, b, r, k);
    float2 s = v[0];
#pragma unroll
    for (int u = 1; u < PMAX; ++u)
      if (u == i) s = v[u];
    buf[reg::pad((b - k) * p.radix + k + r * p.ns)] = s;
  }
}

// pass_prime at the group's size, one instance a power of two from 32 to
// 512 lanes (a caller whose group is a constant keeps one)
template <int PMAX, bool TRIM, int S, class Load, class Mid>
__device__ __forceinline__ void pass_prime_by_group(const Pass& p, float2 (&v)[S], float2* buf,
                                                    const float2* tabs, const Load& trim,
                                                    int lane, int group, Mid mid) {
  switch (group) {
    case 32: pass_prime<PMAX, TRIM, 32>(p, v, buf, tabs, trim, lane, mid); break;
    case 64: pass_prime<PMAX, TRIM, 64>(p, v, buf, tabs, trim, lane, mid); break;
    case 128: pass_prime<PMAX, TRIM, 128>(p, v, buf, tabs, trim, lane, mid); break;
    case 256: pass_prime<PMAX, TRIM, 256>(p, v, buf, tabs, trim, lane, mid); break;
    default: pass_prime<PMAX, TRIM, 512>(p, v, buf, tabs, trim, lane, mid); break;
  }
}

// the points a thread of PMAX holds in a pass at most: the largest R
// ceil(PMAX / R) over the radices
template <int PMAX>
__host__ __device__ constexpr int slots() {
  constexpr int radices[] = {16, 8, 4, 2, 3, 5, 7};
  int most = 0;
  for (int r : radices) {
    const int n = r * ((PMAX + r - 1) / r);
    if (n > most) most = n;
  }
  return most;
}

// pass p by its radix (the host built the plan from the instance's radices;
// a prime above 7 by pass_prime)
template <bool INV, int PMAX, bool TRIM, int S, class Load, class Mid>
__device__ __forceinline__ void pass(const Pass& p, float2 (&v)[S], float2* buf,
                                     const float2* tabs, const Load& trim, int lane, int group,
                                     Mid mid) {
#define IQT_PLAN_RADIX(R)                                                                     \
  case R:                                                                                     \
    pass_r<R, INV, butterflies<PMAX, R>(), TRIM>(p, v, buf, tabs, trim, lane, group, mid);   \
    break;
  switch (p.radix) {
    IQT_PLAN_RADIX(16)
    IQT_PLAN_RADIX(8)
    IQT_PLAN_RADIX(4)
    IQT_PLAN_RADIX(2)
    IQT_PLAN_RADIX(3)
    IQT_PLAN_RADIX(5)
    IQT_PLAN_RADIX(7)
    default:
      pass_prime_by_group<PMAX, TRIM>(p, v, buf, tabs, trim, lane, group, mid);
      break;
  }
#undef IQT_PLAN_RADIX
}

// The transform of plan tp by lane `lane` of a group of `group` lanes, in
// place in `buf` (natural order in and out; TRIM: pass 0 reads its points
// through `trim`): each pass by its radix, the barrier `sync` between each
// pass's reads and writes and after each pass, so that the caller reads
// `buf` after the call; pass 0 waits at `first_mid` between its reads and
// its writes (the cluster's barrier where it reads another block's buffer,
// which that block's own pass 0 then overwrites).
template <bool INV, int PMAX, bool TRIM, class Load, class First, class Sync>
__device__ __forceinline__ void fft(const Transform& tp, float2* buf, const float2* tabs,
                                    const Load& trim, int lane, int group, First first_mid,
                                    Sync sync) {
  float2 v[slots<PMAX>()];
  pass<INV, PMAX, TRIM>(tp.pass[0], v, buf, tabs, trim, lane, group, first_mid);
  sync();
#pragma unroll 1
  for (int s = 1; s < tp.passes; ++s) {
    pass<INV, PMAX, false>(tp.pass[s], v, buf, tabs, trim, lane, group, sync);
    sync();
  }
}

// the same by frame group g, every barrier the group's
template <bool INV, int PMAX, bool TRIM, class Load>
__device__ __forceinline__ void fft(const Transform& tp, float2* buf, const float2* tabs,
                                    const Load& trim, int lane, int group, int g) {
  const auto sync = [group, g] { group_sync(group, g); };
  fft<INV, PMAX, TRIM>(tp, buf, tabs, trim, lane, group, sync, sync);
}

// the host's check of a transform's plan for an instance of PMAX points a
// thread and groups of `group` lanes: one pass at least, its radices (2-16,
// or a prime above 7 whose table's roots cover NS P), in the plan's order,
// multiply to n, every NS and NB follows from them, and a thread's
// butterflies (a prime pass's outputs) hold every point
// (tests/test_torch_ola_plan.py and tests/test_torch_ola_primes.py model
// the rest: the multipliers, the tables)
template <int PMAX>
inline bool transform_ok(const Transform& tp, int group) {
  if (tp.passes < 1 || tp.passes > kMaxPasses || tp.n < 1) return false;
  long long ns = 1;
  for (int s = 0; s < tp.passes; ++s) {
    const Pass& p = tp.pass[s];
    const int r = p.radix;
    const bool prime = r > 7 && is_prime(r);
    if (r != 16 && r != 8 && r != 4 && r != 2 && r != 3 && r != 5 && r != 7 && !prime)
      return false;
    if (p.ns != ns || static_cast<long long>(p.nb) * r != tp.n) return false;
    if (p.ls < 16 || (p.ls & (p.ls - 1)) || (1 << p.ls_log2) != p.ls || p.row != p.nh + p.ls)
      return false;
    if (prime) {
      if (static_cast<long long>(p.nh) * p.ls < ns * r || p.nb * r > group * PMAX) return false;
    } else if (p.nb > static_cast<long long>(group) * ((PMAX + r - 1) / r)) {
      return false;
    }
    ns *= r;
  }
  return ns == tp.n;
}

}  // namespace plan
}  // namespace iqt
