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
// What bounds it on an H100: transcendental throughput.  Every candidate x
// component x model term costs two exp, two log (log w and log s, recomputed
// per term) and a division, all on the special-function units (16 results
// per clock per SM); the bytes moved (x, out and the tables, which every
// block rereads from L2) are small beside that.  This first version keeps
// the arithmetic of the TPU kernel term for term: one thread per candidate,
// a grid of (candidate blocks, P), f32 carries.  Hoisting log w and log s out
// of the candidate loop and one exp per term are left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // candidates per block
constexpr int kChunk = 256;     // components staged in shared memory at once
constexpr float kVeryNeg = -1e30f;
constexpr float kLogSqrt2Pi = 0.9189385332046727f;

__device__ __forceinline__ void lse_step(float comp, float& mx, float& se) {
  const float nm = fmaxf(mx, comp);
  se = se * expf(mx - nm) + expf(comp - nm);
  mx = nm;
}

__device__ __forceinline__ float component(float x, float w, float mu, float s) {
  const float logw = w > 0.0f ? logf(fmaxf(w, 1e-12f)) : kVeryNeg;
  const float z = (x - mu) / s;
  return logw - 0.5f * (z * z) - logf(s) - kLogSqrt2Pi;
}

__global__ void __launch_bounds__(kThreads)
ei_diff_kernel(const float* __restrict__ x,
               const float* __restrict__ wb, const float* __restrict__ mb,
               const float* __restrict__ sb, const float* __restrict__ wa,
               const float* __restrict__ ma, const float* __restrict__ sa,
               float* __restrict__ out, int n, int m) {
  __shared__ float tab[6][kChunk];
  const int p = blockIdx.y;
  const long long row_x = (long long)p * n;
  const long long row_t = (long long)p * m;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool live = j < n;
  const float xv = live ? x[row_x + j] : 0.0f;

  float mx_b = kVeryNeg, se_b = 0.0f, mx_a = kVeryNeg, se_a = 0.0f;
  for (int base = 0; base < m; base += kChunk) {
    const int cnt = min(kChunk, m - base);
    for (int c = threadIdx.x; c < cnt; c += kThreads) {
      const long long g = row_t + base + c;
      tab[0][c] = wb[g];
      tab[1][c] = mb[g];
      tab[2][c] = sb[g];
      tab[3][c] = wa[g];
      tab[4][c] = ma[g];
      tab[5][c] = sa[g];
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      lse_step(component(xv, tab[0][i], tab[1][i], tab[2][i]), mx_b, se_b);
      lse_step(component(xv, tab[3][i], tab[4][i], tab[5][i]), mx_a, se_a);
    }
    __syncthreads();
  }
  if (live) out[row_x + j] = (mx_b + logf(se_b)) - (mx_a + logf(se_a));
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
extern "C" int ei_diff_f32(const float* x, const float* wb, const float* mb,
                           const float* sb, const float* wa, const float* ma,
                           const float* sa, float* out, int P, int n, int m,
                           void* stream) {
  if (P <= 0 || n <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, P);
  ei_diff_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, wb, mb, sb, wa, ma, sa, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
