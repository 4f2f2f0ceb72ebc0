// Register-resident Stockham FFT passes on a plan chosen at run time.
//
// csrc/fft_reg.cuh compiles one plan per size (reg::Plan<N>), so every
// index is a constant; this header runs any size N from a plan the host
// builds (ops/kernels/fused_ola.py plan_radices / frame_plan) and passes to
// the kernel as one __grid_constant__ struct, so that one instance per
// element type covers every size pair.
//
// The plan: radix-16 passes first, then one pass of radix 8, 4 or 2 for the
// rest of 2^a, then the odd radices (3, 5, 7, 11, 13) in ascending order,
// then the primes above 13 in ascending order. The passes are those of
// fft_reg.cuh (autosort, natural order in and out): pass s with radix R, NS
// = the product of the radices before it, NB = N / R butterflies,
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
// points stay in registers (11 and 13 too: pass_pairs, by conjugate pairs
// of outputs on compile-time roots). A thread of a group of
// G lanes takes butterflies lane, lane + G, ...: floor(PMAX / R) of them in
// registers, PMAX the most points a thread holds (the host picks G with N
// <= PMAX G), all read before the group's barrier and written after it (the
// exchange is in place, in shared memory: every pass reads and writes the
// padded buffer, and the caller stages the frame in and reads the transform
// out); at a radix PMAX does not divide (3, 5, 7, 11, 13) a thread computes
// one more butterfly first and parks its outputs in a side buffer after the
// exchange buffer, copied to their places after the barrier (held,
// side_points: with ceil(PMAX / R) butterflies in registers, 39 points at
// 13, ptxas spilled in the plan and split kernels).
//
// A prime radix P above 13, known only at run time (pass_prime), takes the
// same pass output by output: a thread computes outputs e = lane + i G of
// the pass (at most PMAX of them), each the sum over j < P of in[b + j NB]
// times exp(sign 2 pi i j (k + r NS) / (NS P)), the Stockham twiddle and
// the P-point DFT in one root of order NS P, from the exchange buffer;
// holds them in the transform's register array until the group's barrier,
// then writes them. O(P) complex multiply-adds a point: the host puts these
// passes last, where NS P = N, and takes a part that is one such prime by
// Rader's algorithm where it can (csrc/ola_split.cu), on two transforms of
// P - 1 points whose radices are all of the switch's.
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
// the largest prime of a register pass (pass_r); a prime above it is a
// pass of pass_prime
constexpr int kRegPrimeMax = 13;

// a radix of pass_r: 2, 4, 8, 16, 3, 5, 7, 11, 13
__host__ __device__ constexpr bool reg_radix(int r) {
  return r == 16 || r == 8 || r == 4 || r == 2 || r == 3 || r == 5 || r == 7 || r == 11 ||
         r == 13;
}
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

// the butterflies a lane holds in registers in a pass of radix R:
// floor(PMAX / R) (2 at 11 and 13, 4 at 7, 6 at 5, 10 at 3 for PMAX = 32);
// at a radix PMAX does not divide a lane parks the outputs of one more in
// the side buffer (ceil(PMAX / R) - floor(PMAX / R) = 1)
template <int PMAX, int R>
__host__ __device__ constexpr int held() {
  return PMAX / R;
}

// the float2 of the side buffer of transform tp at groups of `group`
// lanes: the most over its passes of a radix PMAX does not divide of (NB -
// floor(PMAX / R) G) R, the outputs of the butterflies beyond a lane's held
// ones
template <int PMAX>
__host__ __device__ inline int side_points(const Transform& tp, int group) {
  int most = 0;
  for (int s = 0; s < tp.passes; ++s) {
    const Pass& p = tp.pass[s];
    if (p.radix < 1 || PMAX % p.radix == 0 || p.radix > kRegPrimeMax) continue;
    const int over = p.nb - PMAX / p.radix * group;
    if (over > 0 && over * p.radix > most) most = over * p.radix;
  }
  return most;
}

// pass p at compile-time radix R in the padded exchange buffer `buf`, for
// lane `lane` of frame group g (`group` lanes): every point of the lane's
// butterflies read into v (the transform's one array of S points a thread,
// shared by every radix: with an array of its own in each radix's body,
// inlined into one switch, ptxas spilled them to a stack frame of their
// summed size, where any one radix alone spilled none), through the trim
// (Trim, or csrc/fft_cluster.cuh ClusterTrim) where TRIM (the inverse's first pass), the barrier
// `mid` (the group's, or the cluster's where the reads reach another
// block's buffer), each butterfly's points written.
template <int R, bool INV, int PMAX, bool TRIM, int S, class Load, class Mid>
__device__ __forceinline__ void pass_r(const Pass& p, float2 (&v)[S], float2* buf, float2* side,
                                       const float2* tabs, const Load& trim, int lane,
                                       int group, Mid mid) {
  constexpr int B = held<PMAX, R>();
  static_assert(B * R <= S, "the shared array holds the pass's points");
  const float2* t = tabs + p.tw;
  const auto k_of = [&p](int b) {
    if constexpr ((R & (R - 1)) == 0) {
      return b & (p.ns - 1);
    } else {
      return p.ns == 1 ? 0
                       : b - static_cast<int>(__umulhi(static_cast<unsigned>(b), p.magic) >>
                                              p.shift) * p.ns;
    }
  };
  // butterfly b's points in u: twiddled, transformed, each to store(r, u_r)
  const auto finish = [&](float2 (&u)[R], int b, auto store) {
    // a TRIM pass is pass 0, NS = 1: no twiddles in its instance
    if constexpr (!TRIM) {
      if (p.ns > 1) twiddle<R>(u, k_of(b), t, p);
    }
    reg::dft<R, INV>(u);
#pragma unroll
    for (int r = 0; r < R; ++r) store(r, u[r]);
  };
  constexpr bool PARK = PMAX % R != 0;
  const int over = p.nb - B * group;
  const int bo = lane + B * group;
  if constexpr (PARK) {
    if (bo < p.nb) {
      float2 u[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = bo + r * p.nb;
        u[r] = TRIM ? trim.read(buf, j) : buf[reg::pad(j)];
      }
      float2* const park = side + (bo - B * group);
      finish(u, bo, [=](int r, float2 y) { park[r * over] = y; });
    }
  }
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
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int b = lane + i * group;
    if (b < p.nb) {
      float2 u[R];
#pragma unroll
      for (int r = 0; r < R; ++r) u[r] = v[i * R + r];
      const int k = k_of(b);
      const int base = (b - k) * R + k, ns = p.ns;
      finish(u, b, [=](int r, float2 y) { buf[reg::pad(base + r * ns)] = y; });
    }
  }
  if constexpr (PARK) {
    if (bo < p.nb) {
      const int k = k_of(bo);
      const int base = (bo - k) * R + k;
      const float2* const park = side + (bo - B * group);
#pragma unroll
      for (int r = 0; r < R; ++r) buf[reg::pad(base + r * p.ns)] = park[r * over];
    }
  }
}

// pass p at a register prime R (11, 13) as pass_r, the butterfly's DFT
// split around the barrier (csrc/fft.cuh prime_fold, prime_out), a lane
// holding held<PMAX, R>() butterflies lane + i G: each read, twiddled and
// folded into conjugate sums and differences in v before `mid`, its
// outputs computed pair by pair after it and written as they come. The
// lane's butterfly beyond them (b = lane + H G < NB) goes first, whole,
// through v's first R slots, its outputs parked in `side` (point r at r O
// + b - H G, O = NB - H G; side_points) and copied to their places after
// `mid`; only the lane touches them, so they need no barrier of their own.
template <int R, bool INV, int PMAX, bool TRIM, int S, class Load, class Mid>
__device__ __forceinline__ void pass_pairs(const Pass& p, float2 (&v)[S], float2* buf,
                                           float2* side, const float2* tabs, const Load& trim,
                                           int lane, int group, Mid mid) {
  constexpr int B = held<PMAX, R>();
  static_assert(B >= 1 && B * R <= S, "the shared array holds the held butterflies");
  const float2* t = tabs + p.tw;
  const auto k_of = [&p](int b) {
    return p.ns == 1 ? 0
                     : b - static_cast<int>(__umulhi(static_cast<unsigned>(b), p.magic) >>
                                            p.shift) * p.ns;
  };
  // butterfly b's points into u; then twiddled and folded
  const auto read = [&](float2* u, int b) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = b + r * p.nb;
      u[r] = TRIM ? trim.read(buf, j) : buf[reg::pad(j)];
    }
  };
  const auto turn = [&](float2* u, int b) {
    // a TRIM pass is pass 0, NS = 1: no twiddles in its instance
    if (!TRIM && p.ns > 1) {
      const unsigned k = static_cast<unsigned>(k_of(b));
      const unsigned kl = k & (p.ls - 1), kh = k >> p.ls_log2;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2* tr = t + (r - 1) * p.row;
        float2 w = tr[p.nh + kl];
        if (p.nh > 0) w = cmul(tr[kh], w);
        u[r] = cmul(u[r], w);
      }
    }
    prime_fold<R>(u);
  };
  const int over = p.nb - B * group;
  const int bo = lane + B * group;
  if (bo < p.nb) {
    read(v, bo);
    turn(v, bo);
    float2* const park = side + (bo - B * group);
    prime_out<R>(v, INV, [=](int m, float2 y) { park[m * over] = y; });
  }
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int b = lane + i * group;
    if (b < p.nb) {
      read(v + i * R, b);
      turn(v + i * R, b);
    }
  }
  mid();
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int b = lane + i * group;
    if (b < p.nb) {
      const int k = k_of(b);
      const int base = (b - k) * R + k, ns = p.ns;
      prime_out<R>(v + i * R, INV,
                   [=](int m, float2 y) { buf[reg::pad(base + m * ns)] = y; });
    }
  }
  if (bo < p.nb) {
    const int k = k_of(bo);
    const int base = (bo - k) * R + k;
    const float2* const park = side + (bo - B * group);
#pragma unroll
    for (int m = 0; m < R; ++m) buf[reg::pad(base + m * p.ns)] = park[m * over];
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

// pass p at a prime radix P above 13 in the padded exchange buffer, for lane
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
// floor(PMAX / R) over the radices (32 at PMAX = 32: radix 16)
template <int PMAX>
__host__ __device__ constexpr int slots() {
  constexpr int radices[] = {16, 8, 4, 2, 3, 5, 7, 11, 13};
  int most = 0;
  for (int r : radices) {
    const int n = r * (PMAX / r);
    if (n > most) most = n;
  }
  return most;
}

// pass p by its radix (the host built the plan from the instance's radices;
// a prime above 13 by pass_prime, which GENERIC = false leaves out of the
// instance: a transform whose plan transform_ok<PMAX, false> took has none)
template <bool INV, int PMAX, bool TRIM, bool GENERIC, int S, class Load, class Mid>
__device__ __forceinline__ void pass(const Pass& p, float2 (&v)[S], float2* buf, float2* side,
                                     const float2* tabs, const Load& trim, int lane, int group,
                                     Mid mid) {
#define IQT_PLAN_RADIX(R)                                                                     \
  case R:                                                                                     \
    pass_r<R, INV, PMAX, TRIM>(p, v, buf, side, tabs, trim, lane, group, mid);               \
    break;
  switch (p.radix) {
    IQT_PLAN_RADIX(16)
    IQT_PLAN_RADIX(8)
    IQT_PLAN_RADIX(4)
    IQT_PLAN_RADIX(2)
    IQT_PLAN_RADIX(3)
    IQT_PLAN_RADIX(5)
    IQT_PLAN_RADIX(7)
    case 11:
      pass_pairs<11, INV, PMAX, TRIM>(p, v, buf, side, tabs, trim, lane, group, mid);
      break;
    case 13:
      pass_pairs<13, INV, PMAX, TRIM>(p, v, buf, side, tabs, trim, lane, group, mid);
      break;
    default:
      if constexpr (GENERIC)
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
// which that block's own pass 0 then overwrites). GENERIC = false: a plan
// with no pass of pass_prime (transform_ok<PMAX, false>).
template <bool INV, int PMAX, bool TRIM, bool GENERIC = true, class Load, class First, class Sync>
__device__ __forceinline__ void fft(const Transform& tp, float2* buf, float2* side,
                                    const float2* tabs, const Load& trim, int lane, int group,
                                    First first_mid, Sync sync) {
  float2 v[slots<PMAX>()];
  pass<INV, PMAX, TRIM, GENERIC>(tp.pass[0], v, buf, side, tabs, trim, lane, group, first_mid);
  sync();
#pragma unroll 1
  for (int s = 1; s < tp.passes; ++s) {
    pass<INV, PMAX, false, GENERIC>(tp.pass[s], v, buf, side, tabs, trim, lane, group, sync);
    sync();
  }
}

// the same by frame group g, every barrier the group's
template <bool INV, int PMAX, bool TRIM, bool GENERIC = true, class Load>
__device__ __forceinline__ void fft(const Transform& tp, float2* buf, float2* side,
                                    const float2* tabs, const Load& trim, int lane, int group,
                                    int g) {
  const auto sync = [group, g] { group_sync(group, g); };
  fft<INV, PMAX, TRIM, GENERIC>(tp, buf, side, tabs, trim, lane, group, sync, sync);
}

// the host's check of a transform's plan for an instance of PMAX points a
// thread and groups of `group` lanes: one pass at least, its radices (of
// pass_r, or, where GENERIC, a prime above 13 whose table's roots cover NS
// P), in the plan's order, multiply to n, every NS and NB follows from
// them, and a thread's butterflies (a prime pass's outputs) hold every
// point (tests/test_torch_ola_plan.py and tests/test_torch_ola_primes.py
// model the rest: the multipliers, the tables)
template <int PMAX, bool GENERIC = true>
inline bool transform_ok(const Transform& tp, int group) {
  if (tp.passes < 1 || tp.passes > kMaxPasses || tp.n < 1) return false;
  long long ns = 1;
  for (int s = 0; s < tp.passes; ++s) {
    const Pass& p = tp.pass[s];
    const int r = p.radix;
    const bool prime = GENERIC && r > kRegPrimeMax && is_prime(r);
    if (!reg_radix(r) && !prime) return false;
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
