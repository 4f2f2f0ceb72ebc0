// Fixed-edge histogram counts: counts[b] = #{e[b-1] < p <= e[b]}.
//
// Replaces: iqwaveform_tpu/ops/pallas/hist_pallas.py
//   histogram_edge_counts_pallas (_hist_impl / _hist_kernel).
//
// A sample's bin is the number of edges strictly below it, which with
// exact float32 compares is searchsorted(edges, p, 'left'); a NaN sample
// goes to the last bin, where a sort places it. Integer atomics commute,
// so the counts are exact and the same on every run.
//
// What bounds it on an H100: it reads 4 B per sample, 2 MB for the
// flagship's 524,288 binned samples and 34 MB for the blackman design's
// 8,392,704, under a microsecond and about 10 us at 3.35 TB/s; a launch
// costs more than the flagship's data. What costs is the search per
// sample, the atomics and the fixed work of each block.
//
// hist_bucket_kernel (ops/kernels/hist.py hist_route takes it wherever its
// shared memory fits, up to about 27,000 edges on an H100):
// - The bucket table. A float32's bit pattern, with the sign folded in
//   (order_key: -0 taken as +0, negatives bit-inverted, positives with the
//   top bit set), orders as the float does. Each block builds, in its
//   prologue, a table over the keys between the first and the last edge,
//   cut into at most kBuckets buckets by the top bits: the smallest shift
//   s for which key(e_last) >> s - key(e_0) >> s < kBuckets. table[j] is
//   the number of edges whose bucket is below j: each edge adds one to
//   its bucket's counter (integer atomics), and a block-wide scan sums
//   them. A sample of bucket j then lies above every edge before
//   table[j] and not above any edge from table[j + 1] on, so its bin is
//   a binary search of exact float compares over that range alone; below
//   the first bucket it is 0, above the last n_edges. The monitor's edges
//   (2048, uniform in dB over 150 dB, about 41 an octave) get s = 17, six
//   mantissa bits a bucket: zero or one compare a sample. Any sorted edges
//   stay exact (duplicates, negatives, infinities): a bucket of many edges
//   only lengthens its search. Denormals compare exactly (no
//   --use_fast_math, so no flush to zero). The search runs while any lane
//   of the warp searches, its steps predicated, so the lanes stay
//   converged and no divergent branch needs a convergence barrier.
// - The grid: blocks of 512 threads, at least one float4 a thread and at
//   most two blocks an SM, so that the flagship's 524,288 samples fill a
//   wave (256 blocks) and longer rows walk the grid with two float4 loads
//   in flight a thread, their 8 bins found before any is counted. A row
//   whose start is not 16-byte aligned has its up to three head samples
//   and its tail counted one by one.
// - Contention: one shared int32 counter a bin and block, one atomicAdd a
//   sample. The APD of noise falls in a few hundred bins at most, so a
//   warp's atomics share addresses; on an H100 that costs little: a row
//   all in one bin takes about as long as the blackman step's samples
//   spread over their bins (chip_smoke.py phase 10 times both), and
//   aggregating a warp's lanes of one bin with __match_any_sync before
//   the atomic costs more than it saves at every path shape.
// - The flush: each block adds its nonzero counters to the int32 table
//   (zeroed by the wrapper) with global atomics.
//
// hist_kernel, the older design (a 12-step binary search a sample over all
// edges, a grid capped at 2 blocks an SM but sized at 8192 samples a
// block, one sample in flight a thread, one shared atomic a sample),
// serves tables too large for the bucket kernel's shared memory and small
// enough for its own (27,000-29,055 edges on an H100).
//
// The slices (hist_route 'slices', every table above both): the bucket
// kernel run once for each slice of at most 26,999 edges that one block's
// table holds, each a pass over the samples (two for 40,000 edges, four
// for 100,000). Slice [lo, hi) of the edges counts a sample p in its local
// bin l = #{e[lo .. hi) < p} at global bin lo + l where e[lo - 1] < p
// (always in the first slice) and l < hi - lo (always in the last): the
// slice whose (e[lo - 1], e[hi - 1]] holds p. Bin 0 is counted only by the
// first slice, bin E and NaN only by the last; the slices' bins are
// disjoint, so each global counter has one writer per row and stays exact.
//
// Shapes: samples are indexed in 64 bits; a row of 2^31 samples or more
// takes int64 counts (a block's shared counters stay int32: the grid gives
// each block fewer than 2^30 samples of a row), below that int32; the rows
// run on the grid's y dimension, at most 65535 of them at once, each block
// walking rows y, y + 65535, ... with the table it built once.
#include <stdint.h>

#include "fft.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSamplesPerThread = 16;

// a block's counters into the row's global counts: int32, or int64 for
// rows of 2^31 samples or more (the wrapper's choice, as unsigned long
// long: counts are never negative)
__device__ __forceinline__ void flush(int* out, int v) { atomicAdd(out, v); }
__device__ __forceinline__ void flush(unsigned long long* out, int v) {
  atomicAdd(out, static_cast<unsigned long long>(v));
}

template <class Count>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ p, const float* __restrict__ edges,
            Count* __restrict__ counts, long long n, int n_edges, int batch) {
  extern __shared__ float sh[];
  float* e = sh;
  int* c = reinterpret_cast<int*>(sh + n_edges);

  for (int i = threadIdx.x; i < n_edges; i += blockDim.x) e[i] = edges[i];
  for (int row = blockIdx.y; row < batch; row += gridDim.y) {
    const float* pr = p + row * n;
    Count* out = counts + static_cast<long long>(row) * (n_edges + 1);
    for (int i = threadIdx.x; i <= n_edges; i += blockDim.x) c[i] = 0;
    __syncthreads();

    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < n; i += stride) {
      const float v = pr[i];
      int lo = 0;
      int hi = n_edges;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (e[mid] < v) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      if (v != v) lo = n_edges;
      atomicAdd(&c[lo], 1);
    }
    __syncthreads();

    for (int i = threadIdx.x; i <= n_edges; i += blockDim.x) {
      if (c[i]) flush(&out[i], c[i]);
    }
    __syncthreads();  // the counters are zeroed for the next row after this
  }
}

// ---- the bucket-table kernel --------------------------------------------

constexpr int kBkThreads = 512;
constexpr int kBkWarps = kBkThreads / 32;
constexpr int kLogBuckets = 12;
constexpr int kBuckets = 1 << kLogBuckets;
constexpr int kBkUnroll = 2;  // float4 loads in flight a thread
constexpr int kBkBlocksPerSm = 2;

// a float's bits as an unsigned key in the float's order (-0 as +0)
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the smallest shift that cuts [k_lo, k_hi] into at most kBuckets buckets
__device__ __forceinline__ int bucket_shift(unsigned k_lo, unsigned k_hi) {
  const unsigned d = k_hi - k_lo;
  int s = d ? 32 - __clz(d) - kLogBuckets : 0;
  if (s < 0) s = 0;
  while ((k_hi >> s) - (k_lo >> s) >= static_cast<unsigned>(kBuckets)) ++s;
  return s;
}

struct Buckets {
  const float* e;    // the edges, in shared memory
  const int* table;  // nb + 1 entries
  int n_edges;
  int shift;
  unsigned b_lo;     // the first edge's bucket
  unsigned nb;       // buckets in the table

  // the number of edges strictly below v; n_edges for NaN. Every lane of
  // the warp calls: the search's loop runs while any lane still searches,
  // its steps predicated, so the lanes leave it together
  __device__ __forceinline__ int bin(float v) const {
    const unsigned kb = order_key(v) >> shift;
    const unsigned j = kb - b_lo;
    const bool below = kb < b_lo;
    const bool inside = !below && j < nb;
    const unsigned jj = inside ? j : 0u;
    const int t0 = table[jj];
    const int t1 = table[jj + 1];
    int lo = inside ? t0 : (below ? 0 : n_edges);
    int hi = inside ? t1 : lo;
    while (__any_sync(0xffffffffu, lo < hi)) {
      const bool act = lo < hi;
      const int mid = (lo + hi) >> 1;
      const bool up = act && e[act ? mid : 0] < v;
      lo = up ? mid + 1 : lo;
      hi = act && !up ? mid : hi;
    }
    return v != v ? n_edges : lo;
  }
};

// one count in the block's counter of `bin`; bin < 0 counts nothing
__device__ __forceinline__ void count(int* c, int bin) {
  if (bin >= 0) atomicAdd(&c[bin], 1);
}

// the bins of a float4's samples (-1 each where !ok), by every lane: their
// table and edge reads are issued before any of their counts' atomics
__device__ __forceinline__ void bins4(int (&b)[4], const Buckets& bk, float4 v, bool ok) {
  const int x = bk.bin(v.x);
  const int y = bk.bin(v.y);
  const int z = bk.bin(v.z);
  const int w = bk.bin(v.w);
  b[0] = ok ? x : -1;
  b[1] = ok ? y : -1;
  b[2] = ok ? z : -1;
  b[3] = ok ? w : -1;
}

// A slice's test of a sample of local bin b (Slice::keep): whether the
// slice counts it. The whole table is one slice that counts every sample.
struct Slice {
  float e_prev;  // the edge before the slice's first (unused in the first)
  bool first;
  bool last;

  __device__ __forceinline__ int keep(float v, int b, int n_edges) const {
    if (v != v) return last ? b : -1;
    const bool above = first || v > e_prev;
    return above && (b < n_edges || last) ? b : -1;
  }
};

template <bool SLICED, class Count>
__global__ void __launch_bounds__(kBkThreads)
hist_bucket_kernel(const float* __restrict__ p, const float* __restrict__ edges,
                   Count* __restrict__ counts, long long n, int n_edges, long long count_stride,
                   int batch, int first, int last) {
  // dynamic shared memory only: iqt_hist_prepare opts the kernel in to
  // the device's whole opt-in size, which leaves no room for static arrays
  extern __shared__ float sh[];
  float* e = sh;
  int* table = reinterpret_cast<int*>(sh + n_edges);
  int* warp_sums = table + kBuckets + 1;
  int* c = warp_sums + kBkWarps;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the edges' key range and its buckets, the same in every thread (an
  // unsorted last edge is taken as the first, so the table stays in bounds)
  const unsigned k_lo = order_key(__ldg(edges));
  const unsigned k_hi = max(k_lo, order_key(__ldg(edges + n_edges - 1)));
  const int shift = bucket_shift(k_lo, k_hi);
  const unsigned b_lo = k_lo >> shift;
  const unsigned nb = (k_hi >> shift) - b_lo + 1;
  const int m = static_cast<int>(nb) + 1;

  for (int i = tid; i < m; i += kBkThreads) table[i] = 0;
  for (int i = tid; i < n_edges; i += kBkThreads) e[i] = edges[i];
  __syncthreads();
  for (int i = tid; i < n_edges; i += kBkThreads) {
    const unsigned kb = order_key(e[i]) >> shift;
    const unsigned j = kb < b_lo ? 0u : min(kb - b_lo, nb - 1);
    atomicAdd(&table[j + 1], 1);
  }
  __syncthreads();

  // inclusive scan of table[0, m): each thread sums a run of `per`
  // entries, the warps scan the runs' sums by shuffles, warp 0 the warps'
  const int per = (m + kBkThreads - 1) / kBkThreads;
  const int s0 = min(tid * per, m);
  const int s1 = min(s0 + per, m);
  int run = 0;
  for (int i = s0; i < s1; ++i) run += table[i];
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kBkWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kBkWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  int acc = incl - run + (warp ? warp_sums[warp - 1] : 0);
  for (int i = s0; i < s1; ++i) {
    acc += table[i];
    table[i] = acc;
  }

  const Buckets bk{e, table, n_edges, shift, b_lo, nb};
  // the slice's test (first: edges[-1] is not read)
  const Slice sl{first ? 0.f : __ldg(edges - 1), first != 0, last != 0};
  // a sample's counter: its bin, or -1 where the slice does not count it
  const auto bin_of = [&](float v, int b) { return SLICED ? sl.keep(v, b, n_edges) : b; };
  for (int row = blockIdx.y; row < batch; row += gridDim.y) {
    const float* pr = p + row * n;
    Count* out = counts + row * count_stride;
    for (int i = tid; i <= n_edges; i += kBkThreads) c[i] = 0;
    __syncthreads();  // the table's scan, or the previous row's flush, is done
    // the row's float4 body from its first 16-byte boundary; the head and
    // the tail, at most 3 samples each, go to warp 0 of block 0
    const int head = static_cast<int>(
        min(static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(pr) & 15)) & 15) / 4, n));
    const long long n4 = (n - head) / 4;
    const float4* p4 = reinterpret_cast<const float4*>(pr + head);
    const long long stride = static_cast<long long>(gridDim.x) * kBkThreads;
    long long q = static_cast<long long>(blockIdx.x) * kBkThreads + tid;
    // q - lane is the same in every lane of a warp, so each loop's test is
    // the warp's: the unrolled loop runs while all lanes have kBkUnroll
    // float4s, the next while any has one
    for (; q - lane + 31 + (kBkUnroll - 1) * stride < n4; q += kBkUnroll * stride) {
      float4 v[kBkUnroll];
      int b[kBkUnroll][4];
#pragma unroll
      for (int u = 0; u < kBkUnroll; ++u) v[u] = __ldg(p4 + q + u * stride);
#pragma unroll
      for (int u = 0; u < kBkUnroll; ++u) bins4(b[u], bk, v[u], true);
#pragma unroll
      for (int u = 0; u < kBkUnroll; ++u) {
        count(c, bin_of(v[u].x, b[u][0]));
        count(c, bin_of(v[u].y, b[u][1]));
        count(c, bin_of(v[u].z, b[u][2]));
        count(c, bin_of(v[u].w, b[u][3]));
      }
    }
    for (; q - lane < n4; q += stride) {
      const bool ok = q < n4;
      const float4 v = ok ? __ldg(p4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      int b[4];
      bins4(b, bk, v, ok);
      count(c, b[0] < 0 ? -1 : bin_of(v.x, b[0]));
      count(c, b[1] < 0 ? -1 : bin_of(v.y, b[1]));
      count(c, b[2] < 0 ? -1 : bin_of(v.z, b[2]));
      count(c, b[3] < 0 ? -1 : bin_of(v.w, b[3]));
    }
    if (blockIdx.x == 0 && warp == 0) {
      const long long rest = head + 4 * n4;  // tail samples start here
      const long long i = lane < head ? lane : rest + (lane - head);
      const bool ok = lane < head || (lane - head < 3 && i < n);
      const float v = ok ? pr[i] : 0.f;
      const int b = bk.bin(v);
      count(c, ok ? bin_of(v, b) : -1);
    }
    __syncthreads();

    for (int i = tid; i <= n_edges; i += kBkThreads) {
      if (c[i]) flush(&out[i], c[i]);
    }
    __syncthreads();  // the counters are zeroed for the next row after this
  }
}

}  // namespace

// once per device, before the first launch: allow up to `max_smem` bytes
// of dynamic shared memory (the edges, the bucket table and the counts)
extern "C" int iqt_hist_prepare(int max_smem) {
  cudaError_t err;
  if ((err = iqt::allow_smem(hist_kernel<int>, max_smem))) return err;
  if ((err = iqt::allow_smem(hist_kernel<unsigned long long>, max_smem))) return err;
  if ((err = iqt::allow_smem(hist_bucket_kernel<false, int>, max_smem))) return err;
  if ((err = iqt::allow_smem(hist_bucket_kernel<false, unsigned long long>, max_smem)))
    return err;
  if ((err = iqt::allow_smem(hist_bucket_kernel<true, int>, max_smem))) return err;
  return iqt::allow_smem(hist_bucket_kernel<true, unsigned long long>, max_smem);
}

namespace {

// the grid's rows: all of them, at most 65535 at once (each block walks
// its rows at that stride)
unsigned grid_rows(int batch) { return static_cast<unsigned>(batch < 65535 ? batch : 65535); }

// at least enough blocks a row that no block counts 2^30 samples of it
long long floor_blocks(long long n) { return (n + (1LL << 30) - 1) >> 30; }

}  // namespace

// p: (batch, n) float32; edges: (n_edges,) float32, sorted; counts:
// (batch, n_edges + 1), zeroed by the caller, int32 (wide = 0) or int64
// (wide = 1). hist_kernel.
extern "C" int iqt_hist(const void* p, const void* edges, void* counts, int batch, long long n,
                        int n_edges, int wide, int sm_count, void* stream) {
  const size_t smem = sizeof(float) * n_edges + sizeof(int) * (n_edges + 1);
  long long blocks = (n + kThreads * kSamplesPerThread - 1) / (kThreads * kSamplesPerThread);
  const long long cap = 2LL * sm_count;
  if (blocks > cap) blocks = cap;
  if (blocks < floor_blocks(n)) blocks = floor_blocks(n);
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks), grid_rows(batch));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto pp = static_cast<const float*>(p);
  const auto e = static_cast<const float*>(edges);
  if (wide) {
    hist_kernel<unsigned long long><<<grid, kThreads, smem, s>>>(
        pp, e, static_cast<unsigned long long*>(counts), n, n_edges, batch);
  } else {
    hist_kernel<int><<<grid, kThreads, smem, s>>>(pp, e, static_cast<int*>(counts), n, n_edges,
                                                  batch);
  }
  return cudaGetLastError();
}

// the same contract by hist_bucket_kernel, over the edges in slices of at
// most `slice` (n_edges itself: one pass, every sample counted), one launch
// a slice: shared memory of a slice's edges, kBuckets + 1 table entries,
// kBkWarps warp sums and its edges + 1 counters (the wrapper's route checks
// that it fits). The grid: ceil(n / (4 kBkThreads)) blocks a row, at most
// kBkBlocksPerSm a SM over all rows, at least one.
extern "C" int iqt_hist_bucket(const void* p, const void* edges, void* counts, int batch,
                               long long n, int n_edges, int slice, int wide, int sm_count,
                               void* stream) {
  if (slice < 1) return cudaErrorInvalidValue;
  long long blocks = (n + 4 * kBkThreads - 1) / (4 * kBkThreads);
  long long cap = static_cast<long long>(kBkBlocksPerSm) * sm_count / batch;
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  if (blocks < floor_blocks(n)) blocks = floor_blocks(n);
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks), grid_rows(batch));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto pp = static_cast<const float*>(p);
  const auto e = static_cast<const float*>(edges);
  const long long stride = n_edges + 1LL;
  const bool sliced = slice < n_edges;
  for (int lo = 0; lo < n_edges; lo += slice) {
    const int len = n_edges - lo < slice ? n_edges - lo : slice;
    const size_t smem = sizeof(float) * len + sizeof(int) * (kBuckets + 1 + kBkWarps) +
                        sizeof(int) * (len + 1);
    const int first = lo == 0;
    const int last = lo + len == n_edges;
#define IQT_BUCKET(SLICED, COUNT)                                                        \
  hist_bucket_kernel<SLICED, COUNT><<<grid, kBkThreads, smem, s>>>(                      \
      pp, e + lo, static_cast<COUNT*>(counts) + lo, n, len, stride, batch, first, last)
    if (sliced && wide) {
      IQT_BUCKET(true, unsigned long long);
    } else if (sliced) {
      IQT_BUCKET(true, int);
    } else if (wide) {
      IQT_BUCKET(false, unsigned long long);
    } else {
      IQT_BUCKET(false, int);
    }
#undef IQT_BUCKET
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
