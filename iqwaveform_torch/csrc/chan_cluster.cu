// The channelizer statistics at frames above one block: a frame on a
// thread-block cluster.
//
// Replaces: iqwaveform_tpu/ops/pallas/chan_stats_pallas.py
//   chan_stats_packed_pallas and chan_stats_pallas (_chan_call /
//   _chan_stats_kernel), with the contract of csrc/chan_stats.cu, at the
//   frame sizes of IQT_CHAN_CLUSTER_SIZES below (20480-65536 points of the
//   form 2^a 3^b 5^c with b, c <= 1: 96 channels of 256 points, 64 of 512,
//   ...; and 15360, whose one-block instance spills), in every mode and at
//   every navg of 1-128 (at 15360 the channel-only mode keeps the one-block
//   chan_power_reg_kernel). The host route (ops/kernels/chan_stats.py
//   chan_route) picks it by size.
//
// One cluster of C blocks walks a run of frames of one row (blockIdx.y;
// blockIdx.x = C cluster + rank); each block holds M = N / C points in its
// own padded exchange buffer and runs the register-resident M-point passes
// of csrc/fft_reg.cuh. The forward split in frequency of csrc/
// fft_cluster.cuh leaves block r the bins C k + r (k < M). Per frame:
//   1. cluster barrier: every block is done with its buffer (and rank 0
//      with the others' channel partials) of the previous frame;
//   2. the radix-C step: block `rank` owns the offsets n of its slice of
//      [0, M), in whole runs of 128 (the largest navg): it reads samples c
//      M + n (c < C) of the frame, coalesced, bins their |y|^2 over the
//      lanes of a warp (chan_common.cuh bin_sample: each block bins the
//      samples of its own slice), takes their C-point DFT of the windowed
//      values in registers and stores output r times exp(-2 pi i r n / N)
//      at n in block r's buffer (distributed shared memory);  cluster
//      barrier;
//   3. the M-point passes in its own buffer; the last writes |Y|^2 of bins
//      C k + r at k over the buffer viewed as float;  block barrier;
//   4. each thread adds ln(|Y|^2 + 1e-25) to the running sums and folds
//      |Y|^2 into the maxima of its bins; each warp sums, for each of its
//      channels, the bins C k + rank of that channel (a contiguous run of
//      k) into the block's channel partials;  cluster barrier;
//   5. rank 0 adds the C blocks' partials of each channel in rank order
//      (distributed shared memory, no float atomics) and writes chp[b, f,
//      c]. More channels than the partials hold go in chunks, a cluster
//      barrier between.
// Each pass reads the thread's lane (and the radix-C step the block's rank)
// anew, as the one-block kernel does (chan_common.cuh fresh_lane). The
// running sums and (where they fit, chan_common.cuh StatsSmem) the maxima
// live in shared memory; at M = 16384 the maxima run in the block's part
// of the cluster's partial row in device memory (L2). At
// the end each block writes its M partials at r M + k of the cluster's
// row, and chan_fold_kernel folds the rows in a fixed order and puts entry
// r M + k at bin C k + r. A last cluster barrier keeps every block alive
// while rank 0 reads its partials.
//
// Bound on an H100: one read of y (8 B/sample) and the writes of the
// channel and binned power; the FFT work is below that at 67 TFLOP/s.
// What it pays besides the one-block kernel's costs: three cluster
// barriers a frame, the radix-C step through distributed shared memory
// and the cross twiddles read from device memory (L2). The cross twiddles
// and pass tables come from the host, built in float64 and rounded once
// (ops/kernels/chan_stats.py cluster_tables).
#include "chan_common.cuh"
#include "fft_cluster.cuh"

namespace {

namespace CH = iqt::chan;
namespace CL = iqt::cluster;
namespace R = iqt::reg;

template <int N, int C>
struct Shape {
  static constexpr int m = N / C;
  static_assert(m * C == N && m % 128 == 0, "C divides N into whole runs of 128");
  // the binned-power sums of 32 and the channel partials share it
  static constexpr int scratch = N / 32;
  using Smem = CH::StatsSmem<m, scratch>;
  // the host table: m's forward pass tables, then the cross twiddles (C x m)
  static constexpr int cross = R::table_total<m>();
  static constexpr int tw_count = cross + C * m;
};

template <int N, int C, int T>
__global__ void __launch_bounds__(T, 1)
chan_stats_cluster_kernel(const float2* __restrict__ y, const float2* __restrict__ w,
                          const float2* __restrict__ tw, float* __restrict__ part_log,
                          float* __restrict__ part_max, float* __restrict__ chp,
                          float* __restrict__ pbin, long long row_len, int n_frames,
                          int channel_count, int abins, int skip_half, int frames_per_cluster,
                          int lg_navg) {
  using S = Shape<N, C>;
  using SM = typename S::Smem;
  constexpr int M = S::m;
  static_assert(T % 32 == 0, "whole warps");
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tws = smem + SM::exchange;
  float* ws = reinterpret_cast<float*>(tws + SM::tables);
  float* ls = ws + S::scratch;
  float* sp = reinterpret_cast<float*>(buf);
  CL::cg::cluster_group cluster = CL::cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const bool psd = part_log != nullptr;
  const int row = blockIdx.y;
  const int cl = blockIdx.x / C;
  const long long base =
      (static_cast<long long>(row) * (gridDim.x / C) + cl) * N + static_cast<long long>(rank) * M;
  float* mx = SM::max_in_smem ? ls + M : part_max + base;

  for (int e = t; e < SM::tables; e += T) tws[e] = __ldg(&tw[e]);
  if (psd) CH::stats_reset(ls, mx, M);

  const float2* yr = y + row * row_len;
  const int bins = N >> lg_navg;
  float* pr = pbin ? pbin + static_cast<long long>(row) * n_frames * bins : nullptr;
  float* cr = chp + static_cast<long long>(row) * n_frames * channel_count;
  const float2* cross = tw + S::cross;
  const int warp = t >> 5;
  const int f0 = cl * frames_per_cluster;
  const int f1 = min(f0 + frames_per_cluster, n_frames);
  for (int f = f0; f < f1; ++f) {
    const float2* fr = yr + static_cast<long long>(f) * N;
    float* pb = pr ? pr + static_cast<long long>(f) * bins : nullptr;
    float* cf = cr + static_cast<long long>(f) * channel_count;
    cluster.sync();  // 1.

    // 2. the radix-C step over this block's slice (its bounds, and the
    // lane, read anew: see chan_common.cuh fresh_lane)
    const int rk = CH::fresh_rank();
    const int lo = CL::slice_lo(M / 128, rk, C) * 128;
    const int hi = CL::slice_lo(M / 128, rk + 1, C) * 128;
    for (int n = lo + CH::fresh_lane(); n < hi; n += T) {
      float2 v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = fr[c * M + n];  // all C loads in flight first
      if (pb) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          CH::bin_sample(v[c].x * v[c].x + v[c].y * v[c].y, c * M + n, lg_navg, pb, ws);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = iqt::cmul(v[c], __ldg(&w[c * M + n]));
      iqt::dft_small<C>(v, false);
      cluster.map_shared_rank(buf, 0)[R::pad(n)] = v[0];
#pragma unroll
      for (int r = 1; r < C; ++r)
        cluster.map_shared_rank(buf, r)[R::pad(n)] = iqt::cmul(v[r], __ldg(&cross[r * M + n]));
    }
    cluster.sync();
    if (pb && lg_navg > 5) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        CH::bin_fold(ws, lg_navg, (c * M + lo) >> lg_navg, (c * M + hi) >> lg_navg, pb);
    }

    // 3. the M-point passes in this block's buffer
    R::pass_lane<M, 0, false, T, true>(
        CH::fresh_lane(), tws, [buf](int, int i) { return buf[R::pad(i)]; },
        [buf](int, int i, float2 v) { buf[R::pad(i)] = v; }, [] { __syncthreads(); });
    __syncthreads();
    CH::passes_from<M, 1, T>(buf, tws, [sp](int k, float2 v) { sp[k] = v.x * v.x + v.y * v.y; });
    __syncthreads();

    // 4. the statistics of bins C k + rank, the channel partials
    if (psd) CH::stats_add(sp, ls, mx, M);
    for (int c0 = 0; c0 < channel_count; c0 += S::scratch) {
      const int c1 = min(c0 + S::scratch, channel_count);
      if (c0 > 0) cluster.sync();  // rank 0 is done with the previous chunk
      for (int c = c0 + warp; c < c1; c += T / 32) {
        const int b0 = skip_half + c * abins;
        const float s = CH::warp_run_sum(sp, (b0 - rank + C - 1) / C, (b0 + abins - rank + C - 1) / C);
        if ((t & 31) == 0) ws[c - c0] = s;
      }
      cluster.sync();
      // 5. rank 0 adds the blocks' partials in rank order
      if (rank == 0) {
        for (int c = c0 + t; c < c1; c += T) {
          float s = 0.f;
#pragma unroll
          for (int r = 0; r < C; ++r) s += cluster.map_shared_rank(ws, r)[c - c0];
          cf[c] = s;
        }
      }
    }
  }
  cluster.sync();  // no block exits while rank 0 reads its partials

  if (psd) CH::stats_write(ls, mx, SM::max_in_smem, part_log + base, part_max + base, M);
}

// F(N, C, T): the cluster sizes, N = C M with M a size of IQT_CHAN_SIZES
// and T its threads. Where N has more than one split, the kept one leaves
// no ptxas spill: parts of 15360 (30720 = 2 x 15360) spill under the frame
// loop, and so do 12288-point parts at 512 threads (24576 = 2 x 12288,
// 61440 = 5 x 12288: 4-16 bytes) and 6 x 10240 (61440); 61440 keeps 5 x
// 12288 at 384 threads (up to 168 registers a thread; one block an SM
// either way). 15360 itself runs here, on 5 x 3072, for the same reason
// (csrc/chan_common.cuh).
#define IQT_CHAN_CLUSTER_SIZES(F) \
  F(15360, 5, 192)                \
  F(20480, 5, 256)                \
  F(24576, 3, 512)                \
  F(30720, 5, 384)                \
  F(32768, 2, 512)                \
  F(40960, 5, 512)                \
  F(49152, 3, 512)                \
  F(61440, 5, 384)                \
  F(65536, 4, 512)

template <int N, int C, int T>
cudaLaunchConfig_t cluster_config(dim3 grid, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = Shape<N, C>::Smem::bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int N, int C, int T>
cudaError_t launch(int batch, int n_clusters, cudaStream_t stream, const float2* y,
                   const float2* w, const float2* tw, int n_tw, float* part_log, float* part_max,
                   float* chp, float* pbin, long long row_len, int n_frames, int channel_count,
                   int abins, int skip_half, int frames_per_cluster, int lg_navg) {
  if (n_tw != Shape<N, C>::tw_count) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<N, C, T>(dim3(n_clusters * C, batch), stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, chan_stats_cluster_kernel<N, C, T>, y, w, tw, part_log, part_max, chp, pbin, row_len,
      n_frames, channel_count, abins, skip_half, frames_per_cluster, lg_navg);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int N, int C, int T>
cudaError_t occupancy(int* out) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<N, C, T>(dim3(C), nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, chan_stats_cluster_kernel<N, C, T>, &cfg);
}

}  // namespace

// once per device, before the first launch: opt every instance in to its
// dynamic shared memory
extern "C" int iqt_chan_cluster_prepare(int) {
  cudaError_t err;
#define IQT_ALLOW(N, C, T)                                                  \
  if ((err = iqt::allow_smem(chan_stats_cluster_kernel<N, C, T>,           \
                             Shape<N, C>::Smem::bytes)))                    \
    return err;
  IQT_CHAN_CLUSTER_SIZES(IQT_ALLOW)
#undef IQT_ALLOW
  return cudaSuccess;
}

// out[0] = the clusters of nfft's instance the current device holds at
// once (0: it cannot launch one); after iqt_chan_cluster_prepare. Another
// nfft: cudaErrorInvalidValue.
extern "C" int iqt_chan_cluster_occupancy(int nfft, int* out) {
#define IQT_OCC(N, C, T) \
  if (nfft == N) return occupancy<N, C, T>(out);
  IQT_CHAN_CLUSTER_SIZES(IQT_OCC)
#undef IQT_OCC
  *out = 0;
  return cudaErrorInvalidValue;
}

// arguments as for iqt_chan_stats_mixed (csrc/chan_mixed.cu), with the
// grid in clusters: n_clusters clusters a row, each of frames_per_cluster
// frames, and part_log / part_max (batch, n_clusters, nfft); tw the n_tw
// entries of nfft's cluster table (ops/kernels/chan_stats.py
// cluster_tables). Another nfft, another table length or a navg outside
// 1, 2, 4, ..., 128: cudaErrorInvalidValue; a cluster the card refuses:
// the launch's error.
extern "C" int iqt_chan_stats_cluster(const void* y, const void* w, const void* tw, void* part_log,
                                      void* part_max, void* log_sum, void* max_out, void* chp,
                                      void* pbin, int n_tw, int batch, int row_len, int n_frames,
                                      int nfft, int navg, int channel_count, int abins,
                                      int skip_half, int frames_per_cluster, int n_clusters,
                                      void* stream) {
  const int lg_navg = iqt::chan::navg_log2(navg);
  if (lg_navg < 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pl = static_cast<float*>(part_log);
  auto pm = static_cast<float*>(part_max);
  cudaError_t err = cudaErrorInvalidValue;
  int c = 1;
#define IQT_LAUNCH(N, C, T)                                                                      \
  if (nfft == N) {                                                                               \
    c = C;                                                                                       \
    err = launch<N, C, T>(batch, n_clusters, s, static_cast<const float2*>(y),                   \
                          static_cast<const float2*>(w), static_cast<const float2*>(tw), n_tw,   \
                          pl, pm, static_cast<float*>(chp), static_cast<float*>(pbin), row_len,  \
                          n_frames, channel_count, abins, skip_half, frames_per_cluster,         \
                          lg_navg);                                                              \
  }
  IQT_CHAN_CLUSTER_SIZES(IQT_LAUNCH)
#undef IQT_LAUNCH
  if (err != cudaSuccess || part_log == nullptr) return err;
  return iqt::chan::launch_fold(pl, pm, static_cast<float*>(log_sum),
                                static_cast<float*>(max_out), batch, n_clusters, nfft, c, s);
}
