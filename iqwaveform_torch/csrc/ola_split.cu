// The frame-batch OLA chain on frames above one block's shared memory that
// no thread-block cluster pair takes, split into parts that pass through
// device memory.
//
// Replaces: iqwaveform_tpu/ops/pallas/fused_ola_pallas.py fused_ola_packed
//   and fused_ola_pallas, the per-frame chain (times w_in, forward DFT of
//   N1 points, the [zero_lo, zero_hi) mask, the trim of bins [in_lo, ...)
//   to [out_lo, out_hi) of an N2-bin spectrum, inverse DFT, times w_out /
//   N2), with the contract of ops/kernels/fused_ola.py fused_ola_frames.
//   The host route (frames_route 'split') takes every pair that
//   CLUSTER_PAIRS does not list and whose larger frame no block holds, or
//   whose sizes have a prime factor above 7 and split into parts of
//   csrc/fft_reg.cuh's plans, or that no other frame kernel holds, where
//   both sizes are C M, C <= 2048 of any prime factors and M <= 16384
//   points: a size of csrc/fft_reg.cuh's plans (1024-16384) where one
//   divides, else a part size of any factors on a plan the host builds at
//   run time (csrc/fft_plan.cuh; ops/kernels/fused_ola.py split_shape:
//   38400 = 3 x 12800, 2053 x 1024 = 256 x 8212); the forward and inverse
//   may differ: N1 = C1 M1, N2 = C2 M2.
//   The frames are complex64, or (2, n) planes of float32, int16 or
//   bfloat16 (the storage tiers), which the forward radix step, the only
//   kernel that reads them, dequantizes on load (csrc/ola_frames.cuh Src),
//   either as a batch of frames or straight from rows of n_in samples at a
//   hop, the samples past a row's end from its halo (Edge: the 2:1 route
//   of ops/kernels/fused_ola.py, whose overlap-add is csrc/ola_add.cu).
//
// The algorithm is the cluster kernel's (csrc/fft_cluster.cuh), with
// device memory in place of distributed shared memory as the exchange
// between parts, and one launch per step:
//   1. split_radix_kernel<false>, the forward radix-C1 step: a block takes
//      TN consecutive offsets n < M1 of one frame (TN a power of two from
//      1 to 512, C1 TN <= 2048: 32 at C1 = 64, 8 at C1 = 160, 1 above
//      1024; csrc/split_radix.cuh tile_log2; the last tile of a part size
//      TN does not divide takes the columns below M1); it reads samples c M1 + n
//      (c < C1) times w_in (TN consecutive samples a part: coalesced from
//      TN = 8 up), takes their C1-point DFT in
//      shared memory (split_radix.cuh radix_step: Stockham passes of radix
//      4, 2, 3, 5 and 7 over the TN columns, and of any prime above 7
//      through its generic pass), and stores output r times
//      exp(-2 pi i n r / N1) at offset n of part r of the scratch `a`
//      (batch, frames, C1, M1);
//   2. split_fwd_passes_kernel<M1>, one block per (frame, part r): the
//      register-resident M1-point passes of fft_reg.cuh on part r (a part
//      size on a run-time plan: split_plan_passes_kernel<false>, below,
//      several parts a block), whose
//      last pass holds forward bins K = C1 k + r; it stores each bin that
//      survives the mask and the trim (K in [lo, hi), lo = max(zero_lo,
//      in_lo), hi = min(zero_hi, in_lo + out_hi - out_lo)) as inverse bin
//      j = K + out_lo - in_lo, at offset j / C2 of inverse part j mod C2 of
//      y, taken as scratch (batch, frames, C2, M2). Nothing else is stored:
//      the inverse never reads the other bins.
//   3. split_inv_passes_kernel<M2> (or split_plan_passes_kernel<true>),
//      one block per (frame, part p): its
//      pass 0 reads bin j = C2 i + p of part p where step 2 stored it, zero
//      elsewhere; the M2-point inverse passes; the last pass stores each
//      point n times `post`[n] and `scale` back over the part it read
//      (each block reads its whole part in pass 0, before the barriers of
//      the passes that precede its stores): for C2 = 1 that is y itself,
//      post = w_out and scale = 1 / N2; else post = exp(+2 pi i p n / N2).
//   4. split_radix_kernel<true>, the inverse radix-C2 step (C2 > 1 only):
//      a block takes TN offsets n < M2 of one frame, reads point n of every
//      part, takes the C2-point inverse DFT, and writes output s times
//      w_out[s M2 + n] / N2 at sample s M2 + n of y: the very addresses it
//      read, so y is transformed in place.
// Plain stores only, each address written by one block: the result does not
// depend on the order in which blocks run. Scratch: `a`, batch * frames *
// N1 complex64 from the caller (the wrapper's torch.empty), y itself for
// the inverse side.
//
// Tables (ops/kernels/fused_ola.py _split_tables), built on the host in
// float64 and rounded once to float32: each passes kernel's pass tables
// (copied into its shared memory, as fused_ola_frames_reg_kernel does),
// the cross twiddles of each side (C x M, read from device memory where
// consecutive threads read consecutive entries) and exp(-+2 pi i j / C),
// j < C, of each radix step, with its sign.
//
// Bound on an H100 (device memory: each input sample read once, each
// output written once, 8 B each). This simple version moves the frame
// through device memory three times more: the forward radix step writes
// `a` (N1 points) and the passes read it; the inverse side writes and
// reads y in place once per step. The radix steps run any C (its plan is a
// launch argument) in one instance per direction and element type; a prime
// factor above 7 costs O(p) operations a point there (the generic pass);
// the passes kernels are
// one instance per size of REG_PLANS and direction (no 15360-point inverse),
// and one per direction on a run-time plan for every other part size, whose
// primes above 7 cost O(p) a point too (csrc/fft_plan.cuh pass_prime). Not
// done here: the
// radix steps folded into the neighbouring passes (the cluster kernel's
// gather), and the scratch kept in L2.
#include <cstring>

#include "fft.cuh"
#include "fft_reg.cuh"
#include "ola_frames.cuh"
#include "split_radix.cuh"

namespace {

namespace R = iqt::reg;
namespace S = iqt::split;

// A radix-C step on TN = 2^lt offsets of one frame (blockIdx.x = frame *
// ceil(m / TN) + tile, blockIdx.y = batch row; the last tile of a part size
// that TN does not divide takes only its columns below m, zeros in the
// others, stored nowhere): point (c, n) of the frame lies at
// in + c * m + n (elements of E: complex64, or a plane whose imaginary
// plane lies in_plane elements further), times pre[c * m + n] where pre is
// given; the C-point DFT of csrc/split_radix.cuh (dft_tab = exp(-+2 pi i j
// / C), j < C, with the direction's sign); output (r, n) times post[r * m +
// n] and `scale` to out + r * m + n. `in` and `out` may be the same frames
// (step 4, E = float2): a block reads all its points before it writes any.
// `edge` (step 1): a frame that reaches past its row's n_in samples reads
// the samples there from the row's halo, zeros after it (csrc/ola_frames.cuh
// Edge; n_in = 0 at step 4 and wherever the frames lie inside their rows).
template <bool INV, class E>
__global__ void __launch_bounds__(S::kRadixThreads)
split_radix_kernel(const E* in, long long in_batch, long long in_frame, long long in_plane,
                   iqt::ola::Edge<E> edge, const float2* __restrict__ pre, const float2* __restrict__ post, float scale,
                   const float2* __restrict__ dft_tab, float2* out, long long out_batch,
                   long long out_frame, int m, int c, int lt, S::RadixPlan plan) {
  extern __shared__ float2 smem[];
  float2* const buf[2] = {smem, smem + (c << lt)};
  float2* tab = smem + 2 * (c << lt);
  const int tn = 1 << lt;
  const int tiles = (m + tn - 1) >> lt;
  const int f = blockIdx.x / tiles;
  const int n0 = (blockIdx.x - f * tiles) << lt;
  const int cols = min(tn, m - n0);
  const long long start = f * in_frame;
  const E* src = in + blockIdx.y * in_batch + start + n0;
  float2* dst = out + blockIdx.y * out_batch + f * out_frame + n0;
  for (int e = threadIdx.x; e < c; e += S::kRadixThreads) tab[e] = __ldg(&dft_tab[e]);
  if (edge.reaches(start, static_cast<long long>(c) * m)) {
    // the frame at src - n0 (its imaginary plane in_plane further)
    const E* xf = src - n0;
    const E* xi = iqt::ola::Src<E>::imag(xf, in_plane);
    for (int e = threadIdx.x; e < c << lt; e += S::kRadixThreads) {
      const int at = (e >> lt) * m + (e & (tn - 1));
      float2 v = make_float2(0.f, 0.f);
      if ((e & (tn - 1)) < cols) {
        v = edge.read(xf, xi, start, n0 + at, blockIdx.y);
        if (pre != nullptr) v = iqt::cmul(v, __ldg(&pre[n0 + at]));
      }
      buf[0][e] = v;
    }
  } else {
    for (int e = threadIdx.x; e < c << lt; e += S::kRadixThreads) {
      const int at = (e >> lt) * m + (e & (tn - 1));
      float2 v = make_float2(0.f, 0.f);
      if ((e & (tn - 1)) < cols) {
        if constexpr (iqt::ola::Src<E>::kRows == 1) {
          v = src[at];
        } else {
          v = make_float2(iqt::ola::to_float(src[at]), iqt::ola::to_float(src[in_plane + at]));
        }
        if (pre != nullptr) v = iqt::cmul(v, __ldg(&pre[n0 + at]));
      }
      buf[0][e] = v;
    }
  }
  __syncthreads();
  const int cur = S::radix_step<INV>(buf, tab, c, lt, plan);
  for (int e = threadIdx.x; e < c << lt; e += S::kRadixThreads) {
    if ((e & (tn - 1)) >= cols) continue;
    const int at = (e >> lt) * m + (e & (tn - 1));
    const float2 v = buf[cur][e];
    dst[at] = iqt::cmul(make_float2(v.x * scale, v.y * scale), __ldg(&post[n0 + at]));
  }
}

// the passes kernels' threads: 512 from 8192 points up (two radix-16
// butterflies a thread at 16384, as fused_ola_frames_reg_kernel), 256 below
template <int M>
__host__ __device__ constexpr int passes_threads() {
  return M >= 8192 ? 512 : 256;
}

template <int M>
__host__ __device__ constexpr size_t passes_smem() {
  return static_cast<size_t>(R::padded_size(M) + R::table_total<M>()) * sizeof(float2);
}

// Step 2 (blockIdx.x = frame * c1 + r, blockIdx.y = batch row): part r of
// the frame's `a` through the M-point forward passes; each forward bin K =
// c1 k + r in [lo, hi) to inverse bin j = K + d of the frame's y, stored at
// (j mod c2) * m2 + j / c2.
template <int M>
__global__ void __launch_bounds__(passes_threads<M>(), 1)
split_fwd_passes_kernel(const float2* __restrict__ a, const float2* __restrict__ tw,
                        float2* __restrict__ y, int n_frames, int c1, int c2, int m2, int lo,
                        int hi, int d) {
  constexpr int T = passes_threads<M>();
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tws = smem + R::padded_size(M);
  // pass 0 reads no table; the barrier after it orders these stores before
  // the first table read
  for (int e = threadIdx.x; e < R::table_total<M>(); e += T) tws[e] = __ldg(&tw[e]);
  const int f = blockIdx.x / c1;
  const int r = blockIdx.x - f * c1;
  const long long frame = static_cast<long long>(blockIdx.y) * n_frames + f;
  const float2* part = a + frame * c1 * M + static_cast<long long>(r) * M;
  float2* yf = y + frame * c2 * m2;
  R::fft<M, false, T, false>(
      buf, tws, [part](int i) { return part[i]; },
      [=](int k, float2 v) {
        const int K = c1 * k + r;
        if (K >= lo && K < hi) {
          const int j = K + d;
          yf[(j % c2) * m2 + j / c2] = v;
        }
      });
}

// Step 3 (blockIdx.x = frame * c2 + p, blockIdx.y = batch row): part p of
// the frame's y, bin j = c2 i + p read where j - d lies in [lo, hi), zero
// elsewhere, through the M-point inverse passes, each point n times
// post[p * M + n] and `scale`, stored back in place.
template <int M>
__global__ void __launch_bounds__(passes_threads<M>(), 1)
split_inv_passes_kernel(float2* y, const float2* __restrict__ tw,
                        const float2* __restrict__ post, float scale, int n_frames, int c2,
                        int lo, int hi, int d) {
  constexpr int T = passes_threads<M>();
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tws = smem + R::padded_size(M);
  for (int e = threadIdx.x; e < R::table_total<M>(); e += T) tws[e] = __ldg(&tw[e]);
  const int f = blockIdx.x / c2;
  const int p = blockIdx.x - f * c2;
  const long long frame = static_cast<long long>(blockIdx.y) * n_frames + f;
  float2* part = y + (frame * c2 + p) * M;
  const float2* pp = post + static_cast<long long>(p) * M;
  R::fft<M, true, T, false>(
      buf, tws,
      [=](int i) {
        const int K = c2 * i + p - d;
        return (K >= lo && K < hi) ? part[i] : make_float2(0.f, 0.f);
      },
      [=](int n, float2 v) {
        part[n] = iqt::cmul(make_float2(v.x * scale, v.y * scale), __ldg(&pp[n]));
      });
}

// A part size on a run-time plan (ops/kernels/fused_ola.py part_plan): the
// part's plan::Transform (csrc/fft_plan.cuh, primes above 13 included),
// its pass tables' float2 count, the lanes of a part, the parts a block
// and the float2 of a part's exchange buffer, as csrc/ola_frames.cuh
// FramePlan groups frames. A part that is a prime m above 13 whose m - 1
// has only radices of the register passes (rader = 1; 16381 = 4 x 9 x 5 x
// 7 x 13 + 1 among them) runs by Rader's algorithm: t is then the (m -
// 1)-point forward transform, which it runs twice.
struct PartPlan {
  iqt::plan::Transform t;
  int tw_count;
  int group;
  int parts;
  int buf;
  int rader;
};

constexpr int kPartThreads = iqt::ola::kPlanThreads;
constexpr int kPartPoints = iqt::ola::kPlanPoints;

// Steps 2 and 3 at a part size on a run-time plan: part u = blockIdx.x
// plan.parts + g of batch row blockIdx.y (frame f = u / c, part r = u mod c,
// c = c1 forward, c2 inverse) on frame group g of plan.group lanes. INV =
// false (step 2): part r of the frame's `a`, staged into the group's
// exchange buffer, through the forward passes; each forward bin K = c1 k
// + r in [lo, hi) to inverse bin j = K + d of the frame's y, at (j mod c2)
// m2 + j / c2. INV (step 3): part p of the frame's y, bin i staged where
// c2 i + p - d lies in [lo, hi), zero elsewhere; the inverse passes; point
// n times post[p M + n] and `scale` back over the part. A group reads its
// whole part before its passes and writes only after them; no two groups
// touch one part.
//
// RADER: the part is a prime m, its DFT (exp(-2 pi i n k / m) forward,
// exp(+...) in INV) by Rader's algorithm inside the group, with L = m - 1
// and g a generator of the integers mod m (the host's tables: idx[q] = g^q
// mod m, then idx[L + q] = g^-q mod m; b the L-point DFT of exp(-+2 pi i
// g^-q / m), q < L, over L):
//   1. a_q = x[g^q] gathered from device memory into the exchange buffer
//      (through the mask in INV), x_0 to the float2 after the padded
//      buffer;
//   2. the L-point forward transform in place: A; A[0], the sum of every
//      x_n but x_0, to the float2 after x_0;
//   3. conj(A[k] b[k]) in place, then the same forward transform: its
//      conjugate is c, the cyclic convolution of a with the roots (the
//      inverse transform as conj(DFT(conj(.))): one transform's tables);
//   4. X[0] = x_0 + A[0], X[g^-q] = x_0 + c_q, stored as above: the forward
//      bins scattered into y's inverse parts, the inverse's points back
//      over the part (L2 takes the scattered stores).
// O(log m) a point where the single prime pass took O(m); one buffer of L
// points in place (a second, of m, does not fit a block beside it at m =
// 16381), the permutations in the device loads and stores.
template <bool INV, bool RADER>
__global__ void __launch_bounds__(kPartThreads, 1)
split_plan_passes_kernel(const float2* a, float2* y, const float2* __restrict__ tw,
                         const float2* __restrict__ post, float scale, int n_frames, int c1,
                         int c2, int m2, int lo, int hi, int d,
                         const float2* __restrict__ rader_b, const int* __restrict__ rader_idx,
                         const __grid_constant__ PartPlan plan) {
  namespace P = iqt::plan;
  extern __shared__ float2 smem[];
  for (int e = threadIdx.x; e < plan.tw_count; e += kPartThreads) smem[e] = __ldg(&tw[e]);
  __syncthreads();
  const int group = plan.group;
  const int g = threadIdx.x / group;
  const int lane = threadIdx.x - g * group;
  const int c = INV ? c2 : c1;
  const int u = blockIdx.x * plan.parts + g;
  // a group with no part leaves: every later barrier is its own group's
  if (g >= plan.parts || u >= n_frames * c) return;
  const int m = RADER ? plan.t.n + 1 : plan.t.n;
  float2* buf = smem + plan.tw_count + g * plan.buf;
  // the part's frame and index, from a read of the block's index that the
  // compiler does not merge with another: taken again after the transforms,
  // so that none of them is live across the passes (kept, they spilled 4-12
  // B a thread), and by a Rader part at each point it stores (taken once
  // after its two transforms, they spilled 36-48 B)
  const auto part_of = [&](long long& frame, int& r) {
    unsigned bx, by;
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bx));
    asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(by));
    const int u2 = static_cast<int>(bx) * plan.parts + g;
    const int f = u2 / c;
    r = u2 - f * c;
    frame = static_cast<long long>(by) * n_frames + f;
  };
  long long frame;
  int r;
  part_of(frame, r);
  // point i of the part as the transform reads it: a's, or y's through the mask
  const float2* fwd_part = a + (frame * c1 + r) * m;
  float2* inv_part = y + (frame * c2 + r) * m;
  const auto load = [=](int i) {
    if constexpr (!INV) {
      return fwd_part[i];
    } else {
      const int K = c2 * i + r - d;
      return (K >= lo && K < hi) ? inv_part[i] : make_float2(0.f, 0.f);
    }
  };
  // output k of part r of the frame's transform to where the next step reads it
  const auto store = [&](long long frame, int r, int k, float2 v) {
    float2* inv_part = y + (frame * c2 + r) * m;
    if constexpr (!INV) {
      const int K = c1 * k + r;
      if (K >= lo && K < hi) {
        const int j = K + d;
        y[frame * c2 * m2 + (j % c2) * m2 + j / c2] = v;
      }
    } else {
      inv_part[k] = iqt::cmul(make_float2(v.x * scale, v.y * scale),
                              __ldg(&post[static_cast<long long>(r) * m + k]));
    }
  };
  if constexpr (!RADER) {
    for (int i = lane; i < m; i += group) buf[R::pad(i)] = load(i);
    P::group_sync(group, g);
    // the passes at an odd radix park a lane's last butterfly after the buffer
    P::fft<INV, kPartPoints, false>(plan.t, buf, buf + R::padded_size(m), smem, P::Trim{}, lane,
                                    group, g);
    part_of(frame, r);
    for (int k = lane; k < m; k += group) store(frame, r, k, buf[R::pad(k)]);
  } else {
    const int L = plan.t.n;
    // x_0 and A[0] after the padded buffer (no pass touches them), then
    // the side buffer of the passes at an odd radix
    float2* const side = buf + R::padded_size(L) + 2;
    for (int q = lane; q < L; q += group) buf[R::pad(q)] = load(__ldg(&rader_idx[q]));
    if (lane == 0) buf[R::padded_size(plan.t.n)] = load(0);
    P::group_sync(group, g);
    P::fft<false, kPartPoints, false, false>(plan.t, buf, side, smem, P::Trim{}, lane, group, g);
    // A[0] held, then conj(A[k] b[k]) in place (bin 0 is lane 0's own)
    if (lane == 0) buf[R::padded_size(plan.t.n) + 1] = buf[R::pad(0)];
    for (int q = lane; q < L; q += group) {
      const float2 v = iqt::cmul(buf[R::pad(q)], __ldg(&rader_b[q]));
      buf[R::pad(q)] = make_float2(v.x, -v.y);
    }
    P::group_sync(group, g);
    P::fft<false, kPartPoints, false, false>(plan.t, buf, buf + R::padded_size(plan.t.n) + 2, smem,
                                             P::Trim{}, lane, group, g);
    const auto store_at = [&](int k, float2 v) {
      long long frame_k;
      int r_k;
      part_of(frame_k, r_k);
      store(frame_k, r_k, k, v);
    };
    const float2 x0 = buf[R::padded_size(plan.t.n)];
    if (lane == 0)
      store_at(0, make_float2(x0.x + buf[R::padded_size(plan.t.n) + 1].x,
                              x0.y + buf[R::padded_size(plan.t.n) + 1].y));
    for (int q = lane; q < L; q += group) {
      const float2 v = buf[R::pad(q)];
      store_at(__ldg(&rader_idx[L + q]), make_float2(x0.x + v.x, x0.y - v.y));
    }
  }
}

// whether `p` is a part plan the run-time passes kernel runs at m points
// with n_tw table entries: its transform (plan::transform_ok, one pass at
// least), groups of a power of two from 32 to 512 lanes holding m at
// kPartPoints a lane, at most 15 named barriers a block, a padded buffer
// and the side buffer (plan::side_points); a Rader part: m a prime above
// 13, its transform of m - 1 points with no pass of pass_prime, the buffer
// two float2 longer before the side buffer
inline bool part_plan_ok(const PartPlan& p, int m, int n_tw) {
  namespace P = iqt::plan;
  const int g = p.group;
  const int n = p.rader ? m - 1 : m;
  if (!(p.t.n == n && g >= 32 && g <= kPartThreads && (g & (g - 1)) == 0 && p.parts >= 1 &&
        p.parts * g <= kPartThreads && (g == 32 || p.parts <= 15) && p.tw_count == n_tw &&
        n <= kPartPoints * g))
    return false;
  if (p.rader == 0)
    return P::transform_ok<kPartPoints>(p.t, g) &&
           p.buf >= R::padded_size(m) + P::side_points<kPartPoints>(p.t, g);
  return p.rader == 1 && m > P::kRegPrimeMax && iqt::is_prime(m) &&
         P::transform_ok<kPartPoints, false>(p.t, g) &&
         p.buf >= R::padded_size(n) + 2 + P::side_points<kPartPoints>(p.t, g);
}

template <bool INV, bool RADER>
cudaError_t launch_plan_passes(const PartPlan& p, int batch, int n_frames, cudaStream_t stream,
                               const float2* a, float2* y, const float2* tw, const float2* post,
                               float scale, int c1, int c2, int m2, int lo, int hi, int d,
                               const float2* rader_b, const int* rader_idx) {
  const long long parts = static_cast<long long>(n_frames) * (INV ? c2 : c1);
  const long long blocks = (parts + p.parts - 1) / p.parts;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(p.tw_count + p.parts * p.buf) * sizeof(float2);
  split_plan_passes_kernel<INV, RADER>
      <<<dim3(static_cast<unsigned>(blocks), batch), kPartThreads, smem, stream>>>(
          a, y, tw, post, scale, n_frames, c1, c2, m2, lo, hi, d, rader_b, rader_idx, p);
  return cudaGetLastError();
}

// the instance of the part's plan: Rader's where p.rader
template <bool INV>
cudaError_t plan_passes(const PartPlan& p, int batch, int n_frames, cudaStream_t stream,
                        const float2* a, float2* y, const float2* tw, const float2* post,
                        float scale, int c1, int c2, int m2, int lo, int hi, int d,
                        const float2* rader_b, const int* rader_idx) {
  return p.rader ? launch_plan_passes<INV, true>(p, batch, n_frames, stream, a, y, tw, post,
                                                 scale, c1, c2, m2, lo, hi, d, rader_b, rader_idx)
                 : launch_plan_passes<INV, false>(p, batch, n_frames, stream, a, y, tw, post,
                                                  scale, c1, c2, m2, lo, hi, d, nullptr, nullptr);
}

// the compiled part sizes (ops/kernels/fused_ola.py REG_PLANS): F(M); the
// inverse side has no 15360-point instance (ptxas spilled 4 bytes a thread
// there, the radix-15 last pass at 512 threads; SPLIT_INV_PLANS)
#define IQT_SPLIT_INV_SIZES(F) \
  F(16384)                     \
  F(12288)                     \
  F(10240)                     \
  F(8192)                      \
  F(6144)                      \
  F(5120)                      \
  F(4096)                      \
  F(3072)                      \
  F(2048)                      \
  F(1024)
#define IQT_SPLIT_FWD_SIZES(F) \
  F(15360)                     \
  IQT_SPLIT_INV_SIZES(F)

template <int M>
cudaError_t launch_fwd_passes(int batch, int n_frames, cudaStream_t stream, const float2* a,
                              const float2* tw, float2* y, int c1, int c2, int m2, int lo,
                              int hi, int d) {
  split_fwd_passes_kernel<M><<<dim3(n_frames * c1, batch), passes_threads<M>(),
                               passes_smem<M>(), stream>>>(a, tw, y, n_frames, c1, c2, m2, lo,
                                                           hi, d);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_inv_passes(int batch, int n_frames, cudaStream_t stream, float2* y,
                              const float2* tw, const float2* post, float scale, int c2, int lo,
                              int hi, int d) {
  split_inv_passes_kernel<M><<<dim3(n_frames * c2, batch), passes_threads<M>(),
                               passes_smem<M>(), stream>>>(y, tw, post, scale, n_frames, c2,
                                                           lo, hi, d);
  return cudaGetLastError();
}

cudaError_t fwd_passes(int m1, int batch, int n_frames, cudaStream_t stream, const float2* a,
                       const float2* tw, float2* y, int c1, int c2, int m2, int lo, int hi,
                       int d) {
#define IQT_FWD(M) \
  if (m1 == M) return launch_fwd_passes<M>(batch, n_frames, stream, a, tw, y, c1, c2, m2, lo, hi, d);
  IQT_SPLIT_FWD_SIZES(IQT_FWD)
#undef IQT_FWD
  return cudaErrorInvalidValue;
}

cudaError_t inv_passes(int m2, int batch, int n_frames, cudaStream_t stream, float2* y,
                       const float2* tw, const float2* post, float scale, int c2, int lo, int hi,
                       int d) {
#define IQT_INV(M) \
  if (m2 == M) return launch_inv_passes<M>(batch, n_frames, stream, y, tw, post, scale, c2, lo, hi, d);
  IQT_SPLIT_INV_SIZES(IQT_INV)
#undef IQT_INV
  return cudaErrorInvalidValue;
}

// the table length of the M-point passes where M is compiled, else -1
int passes_table(int m) {
#define IQT_TABLE(M) \
  if (m == M) return R::table_total<M>();
  IQT_SPLIT_FWD_SIZES(IQT_TABLE)
#undef IQT_TABLE
  return -1;
}

}  // namespace

// once per device, before the first launch: every passes kernel's dynamic
// shared memory (above 48 KiB from 5120 points up)
extern "C" int iqt_ola_split_prepare(int max_smem) {
  cudaError_t err;
#define IQT_ALLOW_FWD(M) \
  if ((err = iqt::allow_smem(split_fwd_passes_kernel<M>, passes_smem<M>()))) return err;
#define IQT_ALLOW_INV(M) \
  if ((err = iqt::allow_smem(split_inv_passes_kernel<M>, passes_smem<M>()))) return err;
  IQT_SPLIT_FWD_SIZES(IQT_ALLOW_FWD)
  IQT_SPLIT_INV_SIZES(IQT_ALLOW_INV)
#undef IQT_ALLOW_FWD
#undef IQT_ALLOW_INV
  if ((err = iqt::allow_smem(split_plan_passes_kernel<false, false>, max_smem))) return err;
  if ((err = iqt::allow_smem(split_plan_passes_kernel<true, false>, max_smem))) return err;
  if ((err = iqt::allow_smem(split_plan_passes_kernel<false, true>, max_smem))) return err;
  if ((err = iqt::allow_smem(split_plan_passes_kernel<true, true>, max_smem))) return err;
  return cudaSuccess;
}

// The split frame chain: frames x (batch, n_frames, nfft) of `layout`
// (csrc/fused_ola.cu IQT_LAYOUTS: 0 complex64, 1-3 planes of float32, int16,
// bfloat16, the imaginary plane plane_stride elements after the real one)
// at the given element strides (the last one 1), a row's samples at and past
// n_in > 0 read from the halo (n_halo a row at halo + b halo_batch, the
// imaginary plane halo_plane further; n_in = 0: none), y (batch, n_frames,
// nfft_out) contiguous, a (batch, n_frames, nfft) contiguous scratch. nfft = c1 m1,
// nfft_out = c2 m2; plan1 / plan2 the radix steps' plans, host arrays of
// the stage count and the radices (csrc/split_radix.cuh plan_from);
// tw_fwd / tw_inv the m1- and m2-point pass tables (n_fwd / n_inv
// entries), fwd_cross (c1 x m1), inv_cross (c2 x m2), dft1 (c1), dft2 (c2);
// [lo, hi) the forward bins kept, d = out_lo - in_lo; part1 / part2 the
// part1_ints / part2_ints ints of a side's PartPlan (ops/kernels/fused_ola.py
// part_plan) where its part size runs on a run-time plan, else null and 0
// (a compiled size); rader1_b / rader1_idx, rader2_b / rader2_idx a side's
// Rader tables (split_plan_passes_kernel) where its PartPlan has rader =
// 1, else null. Launches steps 1-3, and step 4 where c2 > 1, on
// `stream`; returns the first error. A size, plan or table that no instance
// takes: cudaErrorInvalidValue, before any launch.
extern "C" int iqt_ola_split(const void* x, int layout, long long batch_stride,
                             long long frame_stride, long long plane_stride, const void* halo,
                             long long halo_batch, long long halo_plane, int n_in, int n_halo,
                             const void* w_in,
                             const void* w_out, const void* tw_fwd, const void* tw_inv,
                             const void* fwd_cross, const void* inv_cross,
                             const void* dft1, const void* dft2, void* a, void* y, int n_fwd,
                             int n_inv, int batch, int n_frames, int c1, int m1,
                             const int* plan1, int c2, int m2, const int* plan2, int lo, int hi,
                             int d, const int* part1, int part1_ints, const int* part2,
                             int part2_ints, const void* rader1_b, const int* rader1_idx,
                             const void* rader2_b, const int* rader2_idx, void* stream) {
  constexpr int kPartInts = static_cast<int>(sizeof(PartPlan) / sizeof(int));
  PartPlan q1{}, q2{};
  if (part1 != nullptr) {
    if (part1_ints != kPartInts) return cudaErrorInvalidValue;
    std::memcpy(&q1, part1, sizeof q1);
    if (!part_plan_ok(q1, m1, n_fwd)) return cudaErrorInvalidValue;
  } else if (passes_table(m1) != n_fwd) {
    return cudaErrorInvalidValue;
  }
  if (part2 != nullptr) {
    if (part2_ints != kPartInts) return cudaErrorInvalidValue;
    std::memcpy(&q2, part2, sizeof q2);
    if (!part_plan_ok(q2, m2, n_inv)) return cudaErrorInvalidValue;
  } else if (passes_table(m2) != n_inv) {
    return cudaErrorInvalidValue;
  }
  if ((q1.rader && (rader1_b == nullptr || rader1_idx == nullptr)) ||
      (q2.rader && (rader2_b == nullptr || rader2_idx == nullptr)))
    return cudaErrorInvalidValue;
  if (layout < 0 || layout > 3) return cudaErrorInvalidValue;
  const S::RadixPlan p1 = S::plan_from(plan1), p2 = S::plan_from(plan2);
  if (!S::plan_ok(c1, p1) || !S::plan_ok(c2, p2)) return cudaErrorInvalidValue;
  const int lt1 = S::tile_log2(c1), lt2 = S::tile_log2(c2);
  // each side's tiles a frame: ceil(m / TN)
  const int tiles1 = (m1 + (1 << lt1) - 1) >> lt1, tiles2 = (m2 + (1 << lt2) - 1) >> lt2;
  if (static_cast<long long>(n_frames) * (tiles1 > tiles2 ? tiles1 : tiles2) >= (1LL << 31))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto yp = static_cast<float2*>(y);
  auto ap = static_cast<float2*>(a);
  const long long n1 = static_cast<long long>(c1) * m1;
  const long long n2 = static_cast<long long>(c2) * m2;
  const float inv_n2 = 1.0f / static_cast<float>(n2);
  cudaError_t err;
  // 1. the forward radix-c1 step into `a`, reading the layout's elements
  const auto forward = [&](auto element) {
    using E = decltype(element);
    split_radix_kernel<false, E><<<dim3(n_frames * tiles1, batch), S::kRadixThreads,
                                   S::radix_smem(c1), s>>>(
        static_cast<const E*>(x), batch_stride, frame_stride, plane_stride,
        iqt::ola::Edge<E>{static_cast<const E*>(halo), halo_batch, halo_plane, n_in, n_halo},
        static_cast<const float2*>(w_in), static_cast<const float2*>(fwd_cross), 1.0f,
        static_cast<const float2*>(dft1), ap, n_frames * n1, n1, m1, c1, lt1, p1);
  };
  switch (layout) {
    case 0: forward(float2{}); break;
    case 1: forward(float{}); break;
    case 2: forward(short{}); break;
    default: forward(__nv_bfloat16{}); break;
  }
  if ((err = cudaGetLastError())) return err;
  // 2. the m1-point forward passes, the kept bins into y's inverse parts
  const auto tw1 = static_cast<const float2*>(tw_fwd);
  err = part1 != nullptr
            ? plan_passes<false>(q1, batch, n_frames, s, ap, yp, tw1, nullptr, 1.0f, c1, c2, m2,
                                 lo, hi, d, static_cast<const float2*>(rader1_b), rader1_idx)
            : fwd_passes(m1, batch, n_frames, s, ap, tw1, yp, c1, c2, m2, lo, hi, d);
  if (err) return err;
  // 3. the m2-point inverse passes in place; at c2 = 1 the output itself
  const bool last = c2 == 1;
  const auto tw2 = static_cast<const float2*>(tw_inv);
  const auto post = static_cast<const float2*>(last ? w_out : inv_cross);
  const float scale = last ? inv_n2 : 1.0f;
  err = part2 != nullptr
            ? plan_passes<true>(q2, batch, n_frames, s, nullptr, yp, tw2, post, scale, c1, c2,
                                m2, lo, hi, d, static_cast<const float2*>(rader2_b), rader2_idx)
            : inv_passes(m2, batch, n_frames, s, yp, tw2, post, scale, c2, lo, hi, d);
  if (err) return err;
  if (last) return cudaSuccess;
  // 4. the inverse radix-c2 step in place, scaled, windowed
  split_radix_kernel<true, float2>
      <<<dim3(n_frames * tiles2, batch), S::kRadixThreads, S::radix_smem(c2), s>>>(
          yp, n_frames * n2, n2, 0, iqt::ola::Edge<float2>{}, nullptr,
          static_cast<const float2*>(w_out), inv_n2,
          static_cast<const float2*>(dft2), yp, n_frames * n2, n2, m2, c2, lt2, p2);
  return cudaGetLastError();
}
