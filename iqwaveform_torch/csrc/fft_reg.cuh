// Register-resident Stockham FFT passes at compile-time sizes.
//
// A transform of N points runs as a few passes of radix 16 (and one of
// radix 8, 4, 3, 2, 5, 10 or 15), each in the autosort (Stockham) form: no
// digit-reversal table, input and output in natural order. Pass s, with
// NS = the product of the radices before it and NB = N / R butterflies:
//
//   butterfly b < NB, k = b mod NS:
//     v[r] = in[b + r NB]                              r < R
//     v[r] *= exp(sign 2 pi i r k / (NS R))            (none in pass 0)
//     v = DFT_R(v)                                     in registers
//     out[(b - k) R + k + r NS] = v[r]
//
// Thread t of T takes butterflies t, t + T, ...: a pass reads R points
// per butterfly from shared memory (or, in a transform's first pass, from
// wherever the caller's loader reads, such as device memory, coalesced),
// waits at one barrier until every thread holds its points, and writes
// its results back (or, in the last pass, wherever the caller's storer
// writes). The exchange buffer is padded by one float2 every 16
// (pad(i) = i + i / 16): pass 0 writes at stride R = 16 float2, which
// would put a half-warp's 16 stores into two banks; padded, they fall on
// 16 distinct bank pairs. Every other access of a half-warp is to 16
// consecutive indices and stays conflict-free.
//
// Twiddles come from small tables in shared memory, which the caller
// fills from a table built on the host in float64 and rounded once to
// float32: for pass s, exp(sign 2 pi i r k / (NS R)) = H_r[k / LS] *
// L_r[k mod LS], with LS about sqrt(NS) and at least 16 (H_r is 1 where
// NS <= LS). Lanes of a warp hold consecutive k, so L reads are
// consecutive and H reads a broadcast. Every index is a shift, a mask or
// a constant.
//
// A pass may also run for a group of T threads inside a larger block
// (pass_lane): the group's own lane index takes the place of threadIdx.x
// and its own barrier that of __syncthreads.
//
// Sizes and plans (tests/test_torch_fft_reg.py holds a numpy model of
// them against np.fft): 16384 = 16.16.16.4, 15360 = 16.16.4.15, 12288 =
// 16.16.16.3, 10240 = 16.16.4.10, 8192 = 16.16.16.2, 6144 = 16.16.8.3,
// 5120 = 16.16.4.5, 4096 = 16.16.16, 3072 = 16.16.4.3, 2048 = 16.16.8 and
// 1024 = 16.16.4; the small frames of csrc/fft_small.cuh 512 = 16.16.2,
// 256 = 16.16, 128 = 16.8 and 64 = 16.4 (tests/test_torch_fft_small.py).
// A radix that is no power of two comes last, so that NS
// is one in every pass (k = b mod NS is a mask); radices 10 and 15 are the
// prime-factor DFTs of fft.cuh.
#pragma once

#include "fft.cuh"

namespace iqt {
namespace reg {

// an H100 block's opt-in dynamic shared memory
constexpr size_t kSmemOptin = 232448;

template <int N>
struct Plan;
template <>
struct Plan<16384> {
  static constexpr int stages = 4;
  __host__ __device__ static constexpr int radix(int s) { return s < 3 ? 16 : 4; }
};
template <>
struct Plan<12288> {
  static constexpr int stages = 4;
  __host__ __device__ static constexpr int radix(int s) { return s < 3 ? 16 : 3; }
};
template <>
struct Plan<8192> {
  static constexpr int stages = 4;
  __host__ __device__ static constexpr int radix(int s) { return s < 3 ? 16 : 2; }
};
template <>
struct Plan<6144> {
  static constexpr int stages = 4;
  __host__ __device__ static constexpr int radix(int s) { return s < 2 ? 16 : (s == 2 ? 8 : 3); }
};
template <>
struct Plan<15360> {
  static constexpr int stages = 4;
  __host__ __device__ static constexpr int radix(int s) { return s < 2 ? 16 : (s == 2 ? 4 : 15); }
};
template <>
struct Plan<10240> {
  static constexpr int stages = 4;
  __host__ __device__ static constexpr int radix(int s) { return s < 2 ? 16 : (s == 2 ? 4 : 10); }
};
template <>
struct Plan<5120> {
  static constexpr int stages = 4;
  __host__ __device__ static constexpr int radix(int s) { return s < 2 ? 16 : (s == 2 ? 4 : 5); }
};
template <>
struct Plan<3072> {
  static constexpr int stages = 4;
  __host__ __device__ static constexpr int radix(int s) { return s < 2 ? 16 : (s == 2 ? 4 : 3); }
};
template <>
struct Plan<2048> {
  static constexpr int stages = 3;
  __host__ __device__ static constexpr int radix(int s) { return s < 2 ? 16 : 8; }
};
template <>
struct Plan<4096> {
  static constexpr int stages = 3;
  __host__ __device__ static constexpr int radix(int) { return 16; }
};
template <>
struct Plan<1024> {
  static constexpr int stages = 3;
  __host__ __device__ static constexpr int radix(int s) { return s < 2 ? 16 : 4; }
};
template <>
struct Plan<512> {
  static constexpr int stages = 3;
  __host__ __device__ static constexpr int radix(int s) { return s < 2 ? 16 : 2; }
};
template <>
struct Plan<256> {
  static constexpr int stages = 2;
  __host__ __device__ static constexpr int radix(int) { return 16; }
};
template <>
struct Plan<128> {
  static constexpr int stages = 2;
  __host__ __device__ static constexpr int radix(int s) { return s < 1 ? 16 : 8; }
};
template <>
struct Plan<64> {
  static constexpr int stages = 2;
  __host__ __device__ static constexpr int radix(int s) { return s < 1 ? 16 : 4; }
};

// NS of pass s: the product of the radices before it
template <int N>
__host__ __device__ constexpr int span(int s) {
  int ns = 1;
  for (int i = 0; i < s; ++i) ns *= Plan<N>::radix(i);
  return ns;
}

__host__ __device__ constexpr int pad(int i) { return i + (i >> 4); }
__host__ __device__ constexpr int padded_size(int n) { return n + n / 16; }

// LS of a pass: 2^ceil(log2(NS) / 2), at least 16
__host__ __device__ constexpr int low_span(int ns) {
  int lg = 0;
  while ((1 << lg) < ns) ++lg;
  const int ls = 1 << ((lg + 1) / 2);
  return ls < 16 ? 16 : ls;
}
__host__ __device__ constexpr int high_count(int ns) {
  return ns > low_span(ns) ? ns / low_span(ns) : 0;
}
// a pass's table: for r = 1 .. R-1, a row of high_count H entries then
// low_span L entries; pass 0 has none
__host__ __device__ constexpr int table_row(int ns) { return high_count(ns) + low_span(ns); }
__host__ __device__ constexpr int table_size(int ns, int r) {
  return ns == 1 ? 0 : (r - 1) * table_row(ns);
}
template <int N>
__host__ __device__ constexpr int table_offset(int s) {
  int off = 0;
  for (int i = 0; i < s; ++i) off += table_size(span<N>(i), Plan<N>::radix(i));
  return off;
}
template <int N>
__host__ __device__ constexpr int table_total() {
  return table_offset<N>(Plan<N>::stages);
}

// z * exp(-+ 2 pi i m / 16) for the m of the 4 x 4 split of a radix-16 DFT
template <bool INV>
__device__ __forceinline__ float2 mul_w16(float2 z, int m) {
  constexpr float c1 = 0.92387953251128675613f;  // cos(pi / 8)
  constexpr float s1 = 0.38268343236508977173f;  // sin(pi / 8)
  constexpr float h = 0.70710678118654752440f;
  float2 w;
  switch (m) {
    case 1: w = make_float2(c1, -s1); break;
    case 2: w = make_float2(h, -h); break;
    case 3: w = make_float2(s1, -c1); break;
    case 4: return rot90(z, INV);
    case 6: w = make_float2(-h, -h); break;
    default: w = make_float2(-c1, s1); break;  // m = 9
  }
  if (INV) w.y = -w.y;
  return cmul(z, w);
}

// radix-16 DFT as 4 x 4: n = 4 n1 + n2, k = k1 + 4 k2
template <bool INV>
__device__ __forceinline__ void dft16(float2 (&v)[16]) {
  float2 y[4][4];
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {
    float2 a[4] = {v[n2], v[4 + n2], v[8 + n2], v[12 + n2]};
    dft_small<4>(a, INV);
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) y[n2][k1] = (n2 && k1) ? mul_w16<INV>(a[k1], n2 * k1) : a[k1];
  }
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    float2 b[4] = {y[0][k1], y[1][k1], y[2][k1], y[3][k1]};
    dft_small<4>(b, INV);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = b[k2];
  }
}

// radix-8 DFT as 4 x 2: n = 2 n1 + n2, k = k1 + 4 k2
template <bool INV>
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  float2 a[4] = {v[0], v[2], v[4], v[6]};
  float2 b[4] = {v[1], v[3], v[5], v[7]};
  dft_small<4>(a, INV);
  dft_small<4>(b, INV);
  b[1] = mul_w16<INV>(b[1], 2);
  b[2] = rot90(b[2], INV);
  b[3] = mul_w16<INV>(b[3], 6);
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    v[k1] = make_float2(a[k1].x + b[k1].x, a[k1].y + b[k1].y);
    v[k1 + 4] = make_float2(a[k1].x - b[k1].x, a[k1].y - b[k1].y);
  }
}

template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 16) {
    dft16<INV>(v);
  } else if constexpr (R == 8) {
    dft8<INV>(v);
  } else {
    dft_small<R>(v, INV);
  }
}

// v[r] *= exp(-+ 2 pi i r k / (NS R)) from pass table t
template <int NS, int R>
__device__ __forceinline__ void twiddle(float2 (&v)[R], int k, const float2* t) {
  if constexpr (NS > 1) {
    constexpr int ls = low_span(NS), nh = high_count(NS), row = table_row(NS);
    const unsigned kl = static_cast<unsigned>(k) & (ls - 1);
    const unsigned kh = static_cast<unsigned>(k) / ls;
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const float2* tr = t + (r - 1) * row;
      float2 w = tr[nh + kl];
      if constexpr (nh > 0) w = cmul(tr[kh], w);
      v[r] = cmul(v[r], w);
    }
  }
}

// pass S of the N-point plan for the butterflies lane, lane + T, ... of a
// group of T threads (lane < T): point i comes in through `load(slot, i)`
// and output i goes out through `store(slot, i, v)`, where slot = round *
// R + r is a compile-time constant once the pass is unrolled (a caller may
// keep per-point state in registers by it); SYNC calls `sync()`, the
// group's barrier, between the last load and the first store (needed
// whenever both touch the same buffer)
template <int N, int S, bool INV, int T, bool SYNC, class Load, class Store, class Sync>
__device__ __forceinline__ void pass_lane(int lane, const float2* tw, Load load, Store store,
                                          Sync sync) {
  constexpr int R = Plan<N>::radix(S);
  constexpr int NS = span<N>(S);
  constexpr int NB = N / R;
  constexpr int BPT = (NB + T - 1) / T;
  constexpr bool ragged = NB % T != 0;
  float2 v[BPT][R];
#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    const int b = lane + i * T;
    if (!ragged || b < NB) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[i][r] = load(i * R + r, b + r * NB);
    }
  }
  if constexpr (SYNC) sync();
  const float2* t = tw + table_offset<N>(S);
#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    const int b = lane + i * T;
    if (!ragged || b < NB) {
      const int k = b & (NS - 1);
      twiddle<NS, R>(v[i], k, t);
      dft<R, INV>(v[i]);
      const int base = (b - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) store(i * R + r, base + r * NS, v[i][r]);
    }
  }
}

// pass S by a whole block of T threads: points in through `load(i)`, out
// through `store(i, v)`, __syncthreads where SYNC
template <int N, int S, bool INV, int T, bool SYNC, class Load, class Store>
__device__ __forceinline__ void pass(const float2* tw, Load load, Store store) {
  pass_lane<N, S, INV, T, SYNC>(
      threadIdx.x, tw, [&load](int, int i) { return load(i); },
      [&store](int, int i, float2 v) { store(i, v); }, [] { __syncthreads(); });
}

template <int N, int S, bool INV, int T>
__device__ __forceinline__ void middle_passes(float2* buf, const float2* tw) {
  if constexpr (S < Plan<N>::stages - 1) {
    pass<N, S, INV, T, true>(
        tw, [buf](int i) { return buf[pad(i)]; },
        [buf](int i, float2 v) { buf[pad(i)] = v; });
    __syncthreads();
    middle_passes<N, S + 1, INV, T>(buf, tw);
  }
}

// The N-point transform (forward: exp(-...), inverse: exp(+...), no
// scaling) by a block of T threads. Pass 0 takes its points through
// `first(i)` (SYNC_FIRST: it reads `buf`, so a barrier separates its
// loads from its stores); the passes between go through `buf` (padded,
// padded_size(N) float2); the last gives its points to `last(i, v)` in
// natural order. The caller synchronizes before anything else touches
// `buf` after the last pass's loads. `tw` holds the transform's tables,
// pass by pass at table_offset<N>(s), each with its sign.
template <int N, bool INV, int T, bool SYNC_FIRST, class First, class Last>
__device__ __forceinline__ void fft(float2* buf, const float2* tw, First first, Last last) {
  static_assert(Plan<N>::stages >= 2, "a plan of at least two passes");
  pass<N, 0, INV, T, SYNC_FIRST>(tw, first, [buf](int i, float2 v) { buf[pad(i)] = v; });
  __syncthreads();
  middle_passes<N, 1, INV, T>(buf, tw);
  pass<N, Plan<N>::stages - 1, INV, T, true>(tw, [buf](int i) { return buf[pad(i)]; }, last);
}

// the thread's index, read through asm the compiler may not hoist or merge
// with an earlier read: index math of one transform then holds no
// register across the passes of another
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

template <int N, int S, bool INV, int T>
__device__ __forceinline__ void fresh_middle_passes(float2* buf, const float2* tw) {
  if constexpr (S < Plan<N>::stages - 1) {
    pass_lane<N, S, INV, T, true>(
        fresh_tid(), tw, [buf](int, int i) { return buf[pad(i)]; },
        [buf](int, int i, float2 v) { buf[pad(i)] = v; }, [] { __syncthreads(); });
    __syncthreads();
    fresh_middle_passes<N, S + 1, INV, T>(buf, tw);
  }
}

// fft above with the lane of every pass read anew (fresh_tid)
template <int N, bool INV, int T, bool SYNC_FIRST, class First, class Last>
__device__ __forceinline__ void fft_fresh(float2* buf, const float2* tw, First first, Last last) {
  static_assert(Plan<N>::stages >= 2, "a plan of at least two passes");
  pass_lane<N, 0, INV, T, SYNC_FIRST>(
      fresh_tid(), tw, [&first](int, int i) { return first(i); },
      [buf](int, int i, float2 v) { buf[pad(i)] = v; }, [] { __syncthreads(); });
  __syncthreads();
  fresh_middle_passes<N, 1, INV, T>(buf, tw);
  pass_lane<N, Plan<N>::stages - 1, INV, T, true>(
      fresh_tid(), tw, [buf](int, int i) { return buf[pad(i)]; },
      [&last](int, int i, float2 v) { last(i, v); }, [] { __syncthreads(); });
}

// The detector-binned power of one frame from pass 0 of a plan whose
// first radix is 16, run by T lanes: pw[r] = |x|^2 of sample lane + T r
// (r < 16). The NAVG samples of one detector bin sit in NAVG adjacent
// lanes at one r, so a transposing shuffle reduction bins them with no
// second read of the frame: each of log2(NAVG) steps halves the sums a
// lane holds and exchanges the other half with the lane `o` away (16 -
// 16 / NAVG shuffles a lane); lane l then holds the sums of r = (l mod
// NAVG) * 16 / NAVG + j, which it writes as means at out[(lane + T r) /
// NAVG]. NAVG is a power of two up to 16, so every partner is in the
// same warp.
template <int NAVG, int T>
__device__ __forceinline__ void bin_power(const float (&pw)[16], int lane, float* out) {
  static_assert(NAVG >= 1 && NAVG <= 16 && (NAVG & (NAVG - 1)) == 0, "NAVG in 1, 2, 4, 8, 16");
  constexpr int kSteps = NAVG >= 16 ? 4 : NAVG >= 8 ? 3 : NAVG >= 4 ? 2 : NAVG >= 2 ? 1 : 0;
  constexpr int kKept = 16 / NAVG;
  float v[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = pw[r];
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int o = (NAVG / 2) >> step;
    const int n = 8 >> step;
    const bool hi = (lane & o) != 0;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const float send = hi ? v[j] : v[j + n];
      const float keep = hi ? v[j + n] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  const int r0 = (lane & (NAVG - 1)) * kKept;
#pragma unroll
  for (int j = 0; j < kKept; ++j)
    out[lane / NAVG + (T / NAVG) * (r0 + j)] = v[j] / static_cast<float>(NAVG);
}

}  // namespace reg
}  // namespace iqt
