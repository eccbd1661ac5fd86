// EI score of TPE candidates: log-density of the "below" Parzen mixture
// minus that of the "above" mixture, for every candidate x:
//
//   out[p, j] = lse_i(log w_b,i - 0.5*((x - mu_b,i)/s_b,i)^2 - log s_b,i - log sqrt(2 pi))
//             - lse_i(... same over the above mixture ...)
//
// A component with w <= 0 contributes -1e30; inside the log, w is floored
// at 1e-12.  No truncation terms: the caller adds -log p_b + log p_a.
//
// Replaces the TPU kernel hyperopt_tpu/megakernel.py:_build_ei (body
// _make_ei_kernel), which streamed the same (max, scaled-sum) carries over
// component tables held in SMEM, on an (8, 128) candidate tiling padded to
// multiples of 1024.
//
// Layout: x and out are [P, n] row-major, each table [P, m] row-major.  P is
// the labels of one group (the tables depend on the label only; every id of
// an ask shares the history); n is ids x candidates and any count (the tail
// is masked); m = history capacity + 1 grows with the history (129, 257, ...,
// 1025 and on), so the component loop streams the tables through shared
// memory in chunks instead of sizing anything to m.
//
// What bounds it on an H100: special-function throughput.  Each candidate x
// component x model term needs at least one exp (132 SMs x 16 MUFU results
// per clock); the bytes (x and out once, the tables reread from L2 by each
// block) are small beside that.  The design, around that bound:
// - mixture_lse.cuh: log w, log s and 1/s are computed once per component
//   and block while the chunk is staged, so a term is a subtract, a
//   multiply, an FMA and one exp2 (MUFU.EX2) on a base-2 carry;
// - each thread scores CPT = 1, 2 or 4 candidates against every staged
//   component (one float4 shared-memory read per component and model,
//   shared by CPT candidates), so 2 x CPT independent carries hide the exp
//   latency;
// - when P x candidate tiles would leave the card short of blocks (the
//   single-study ask: 2 rows x 1024 candidates), the component axis is
//   split across a thread-block cluster of up to 8 blocks: each block
//   carries its share of m, and the cluster merges the carries through
//   distributed shared memory; rank 0 writes out.  Still one launch.
// The grid is (candidate tiles, splits, P); ei_diff_plan picks CPT and the
// split from the shape and the card's SM count.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mixture_lse.cuh"

namespace cg = cooperative_groups;
using mixture_lse::Carry;

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kChunk = 256;    // components staged in shared memory at once
constexpr int kMaxSplits = 8;  // the portable cluster size

template <int CPT>
__global__ void __launch_bounds__(kThreads)
ei_diff_kernel(const float* __restrict__ x,
               const float* __restrict__ wb, const float* __restrict__ mb,
               const float* __restrict__ sb, const float* __restrict__ wa,
               const float* __restrict__ ma, const float* __restrict__ sa,
               float* __restrict__ out, int n, int m) {
  constexpr int kTile = kThreads * CPT;
  __shared__ float4 tb[kChunk], ta[kChunk];
  __shared__ Carry part[2][kTile];  // this block's carries, read by rank 0
  const int splits = gridDim.y;
  const int split = blockIdx.y;
  const int p = blockIdx.z;
  const long long row_x = (long long)p * n;
  const long long row_t = (long long)p * m;
  const long long j0 = (long long)blockIdx.x * kTile + threadIdx.x;

  float xv[CPT];
  Carry cb[CPT], ca[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const long long j = j0 + c * kThreads;
    xv[c] = j < n ? x[row_x + j] : 0.0f;
    cb[c] = mixture_lse::empty_carry();
    ca[c] = mixture_lse::empty_carry();
  }

  // this block's share of the components: [lo, hi), at least one each
  const int lo = (int)((long long)m * split / splits);
  const int hi = (int)((long long)m * (split + 1) / splits);
  for (int base = lo; base < hi; base += kChunk) {
    const int cnt = min(kChunk, hi - base);
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      const long long g = row_t + base + i;
      tb[i] = mixture_lse::make_term(wb[g], mb[g], sb[g]);
      ta[i] = mixture_lse::make_term(wa[g], ma[g], sa[g]);
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < cnt; ++i) {
      const float4 b = tb[i], a = ta[i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        mixture_lse::step(b, xv[c], cb[c]);
        mixture_lse::step(a, xv[c], ca[c]);
      }
    }
    __syncthreads();
  }

  if (splits > 1) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      part[0][threadIdx.x + c * kThreads] = cb[c];
      part[1][threadIdx.x + c * kThreads] = ca[c];
    }
    cluster.sync();  // every block's carries are in its shared memory
    if (cluster.block_rank() == 0) {
      for (int r = 1; r < splits; ++r) {
        const Carry* remote = cluster.map_shared_rank(&part[0][0], r);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          mixture_lse::merge(cb[c], remote[threadIdx.x + c * kThreads]);
          mixture_lse::merge(ca[c], remote[kTile + threadIdx.x + c * kThreads]);
        }
      }
    }
    cluster.sync();  // no block leaves while rank 0 still reads its memory
    if (cluster.block_rank() != 0) return;
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const long long j = j0 + c * kThreads;
    if (j < n) out[row_x + j] = mixture_lse::score(cb[c], ca[c]);
  }
}

// The current card's SM count, queried once.
cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      cached = 0;
      return err;
    }
  }
  *sms = cached;
  return cudaSuccess;
}

template <int CPT>
cudaError_t launch(const float* x, const float* wb, const float* mb, const float* sb,
                   const float* wa, const float* ma, const float* sa, float* out, int P,
                   int n, int m, int splits, cudaStream_t stream) {
  constexpr int kTile = kThreads * CPT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n + kTile - 1) / kTile), (unsigned)splits, (unsigned)P);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // no cluster to form for one split
  return cudaLaunchKernelEx(&cfg, ei_diff_kernel<CPT>, x, wb, mb, sb, wa, ma, sa, out, n, m);
}

}  // namespace

// The launch's shape for (P, n, m): plan[0] candidates per thread, plan[1]
// component splits (the cluster size), plan[2] blocks, plan[3] threads per
// block.  Candidates per thread shrink, then the component axis splits,
// until the grid holds about two blocks per SM.  Returns the error of the
// SM-count query, and then leaves plan as it was.
extern "C" int ei_diff_plan(int P, int n, int m, int* plan) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long target = 2LL * sms;
  int cpt = 4;
  long long tiles = 0;
  for (;; cpt /= 2) {
    tiles = (n + (long long)kThreads * cpt - 1) / ((long long)kThreads * cpt);
    if ((long long)P * tiles >= target || cpt == 1) break;
  }
  const long long base = (long long)P * tiles;
  long long splits = (base >= target || base < 1) ? 1 : (target + base - 1) / base;
  if (splits > kMaxSplits) splits = kMaxSplits;
  if (splits > m) splits = m;
  if (splits < 1) splits = 1;
  plan[0] = cpt;
  plan[1] = (int)splits;
  plan[2] = (int)(base * splits);
  plan[3] = kThreads;
  return 0;
}

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
extern "C" int ei_diff_f32(const float* x, const float* wb, const float* mb,
                           const float* sb, const float* wa, const float* ma,
                           const float* sa, float* out, int P, int n, int m,
                           void* stream) {
  if (P <= 0 || n <= 0) return 0;
  int plan[4];
  const int plan_err = ei_diff_plan(P, n, m, plan);
  if (plan_err != 0) return plan_err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (plan[0]) {
    case 4: err = launch<4>(x, wb, mb, sb, wa, ma, sa, out, P, n, m, plan[1], s); break;
    case 2: err = launch<2>(x, wb, mb, sb, wa, ma, sa, out, P, n, m, plan[1], s); break;
    default: err = launch<1>(x, wb, mb, sb, wa, ma, sa, out, P, n, m, plan[1], s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
