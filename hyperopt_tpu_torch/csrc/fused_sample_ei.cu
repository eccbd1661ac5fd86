// Fused TPE sample-and-score: every candidate is drawn from the "below"
// Parzen mixture by inverse CDF and scored by the below-minus-above
// log-density, in one pass, from uniforms drawn by the caller:
//
//   i*   = first i with uc <= cdf[i]             (the last component if none)
//   u    = clip(fma(u0, bb[i*] - ab[i*], ab[i*]), 1e-7, 1 - 1e-7)
//   x    = fma(sb[i*], ndtri(u), mb[i*])          (bounded: clamp into
//                                                  [low, nextafter(high, low)])
//   ei   = lse_i(log wb_i - 0.5((x - mb_i)/sb_i)^2 - log sb_i - log sqrt(2 pi))
//        - lse_i(... over wa, ma, sa ...)
//
// A component with w <= 0 contributes -1e30; inside the log, w is floored at
// 1e-12.  No truncation terms: the caller adds -log p_b + log p_a.  ndtri is
// Cephes' piecewise-rational formula, the one the JAX package evaluates and
// the plain torch version (tpe.ndtri) carries; its Horner steps and the two
// sampling products are single-rounding FMAs, as XLA contracts them.
//
// Replaces the TPU kernel hyperopt_tpu/megakernel.py:_build_fused (body
// _make_fused_kernel), which ran one label at a time on an (8, 128)
// candidate tiling padded to 1024 lanes, with the nine component tables in
// SMEM, and was vmapped over studies and ids.
//
// Layout: uc, u0, x and ei are [P, N] row-major; the nine tables are [P, m]
// row-major; low and high are [P].  A row p is one (study, label) of a group
// of un-quantized numeric labels that share boundedness; its N = ids x
// candidates share the row's tables, which are therefore read once per
// block, never copied per id.  m = capacity + 1 grows with the history, so
// the tables stream through shared memory in chunks and nothing is sized to
// m; the pick pass and the score pass each walk the chunks once.
//
// What bounds it on an H100: transcendental throughput.  The score pass
// costs two exp, two log and a division per candidate x component x model
// (special-function units, 16 results per clock per SM); the bytes (two
// uniforms in, two outputs, 36 bytes of tables per component and row) are
// small beside that at the cohort's shapes.  The service tick is short
// (N = ids x 24), so one row per block would leave most threads idle: a
// block holds 256 / C rows of C = next power of two >= N (at least 32, at
// most 256) candidates each, and wide rows take several blocks along N.
// This first version keeps the TPU kernel's arithmetic term for term;
// hoisting log w and log s and one exp per term are left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 1024;     // staged entries per table, shared by a block's rows
constexpr float kVeryNeg = -1e30f;
constexpr float kLogSqrt2Pi = 0.9189385332046727f;
constexpr float kUTiny = 1e-7f;
constexpr float kUHigh = 0.9999999f;  // 1 - 1e-7 in float32

// Cephes' ndtri coefficients, highest power first
__constant__ float kP0[5] = {-5.99633501014107895267e1f, 9.80010754185999661536e1f,
                             -5.66762857469070293439e1f, 1.39312609387279679503e1f,
                             -1.23916583867381258016e0f};
__constant__ float kQ0[9] = {1.0f, 1.95448858338141759834e0f, 4.67627912898881538453e0f,
                             8.63602421390890590575e1f, -2.25462687854119370527e2f,
                             2.00260212380060660359e2f, -8.20372256168333339912e1f,
                             1.59056225126211695515e1f, -1.18331621121330003142e0f};
__constant__ float kP1[9] = {4.05544892305962419923e0f, 3.15251094599893866154e1f,
                             5.71628192246421288162e1f, 4.40805073893200834700e1f,
                             1.46849561928858024014e1f, 2.18663306850790267539e0f,
                             -1.40256079171354495875e-1f, -3.50424626827848203418e-2f,
                             -8.57456785154685413611e-4f};
__constant__ float kQ1[9] = {1.0f, 1.57799883256466749731e1f, 4.53907635128879210584e1f,
                             4.13172038254672030440e1f, 1.50425385692907503408e1f,
                             2.50464946208309415979e0f, -1.42182922854787788574e-1f,
                             -3.80806407691578277194e-2f, -9.33259480895457427372e-4f};
__constant__ float kP2[9] = {3.23774891776946035970e0f, 6.91522889068984211695e0f,
                             3.93881025292474443415e0f, 1.33303460815807542389e0f,
                             2.01485389549179081538e-1f, 1.23716634817820021358e-2f,
                             3.01581553508235416007e-4f, 2.65806974686737550832e-6f,
                             6.23974539184983293730e-9f};
__constant__ float kQ2[9] = {1.0f, 6.02427039364742014255e0f, 3.67983563856160859403e0f,
                             1.37702099489081330271e0f, 2.16236993594496635890e-1f,
                             1.34204006088543189037e-2f, 3.28014464682127739104e-4f,
                             2.89247864745380683936e-6f, 6.79019408009981274425e-9f};

template <int N>
__device__ __forceinline__ float horner(const float (&c)[N], float x) {
  float y = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) y = __fmaf_rn(y, x, c[k]);
  return y;
}

__device__ float ndtri(float p) {
  const float kExpM2 = 0.1353352832366127f;          // exp(-2)
  const float kOneMinusExpM2 = 0.8646647167633873f;  // 1 - exp(-2)
  const float kNegSqrt2Pi = -2.5066282746310002f;
  const float mcp = p > kOneMinusExpM2 ? 1.0f - p : p;
  const float s = mcp == 0.0f ? 0.5f : mcp;
  float x;
  if (s > kExpM2) {
    const float w = s - 0.5f;
    const float ww = w * w;
    const float r = horner(kP0, ww) / horner(kQ0, ww);
    x = __fmaf_rn(w * ww, r, w) * kNegSqrt2Pi;
  } else {
    const float z = sqrtf(-2.0f * logf(s));
    const float first = z - logf(z) / z;
    const float iz = 1.0f / z;
    const float tail = z >= 8.0f ? horner(kP2, iz) / horner(kQ2, iz) / z
                                 : horner(kP1, iz) / horner(kQ1, iz) / z;
    x = first - tail;
  }
  return p > kOneMinusExpM2 ? x : -x;
}

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

// Copies `ntab` tables' entries [base, base + cnt) of this block's rows into
// shared memory: row r's chunk sits at [k][r * chunk, r * chunk + cnt).
__device__ __forceinline__ void stage(float (*tab)[kStage], const float* const* src,
                                      int ntab, int row0, int rows, int P, int m,
                                      int base, int cnt, int chunk) {
  for (int t = threadIdx.x; t < rows * cnt; t += kThreads) {
    const int r = t / cnt;
    const int c = t - r * cnt;
    const int p = row0 + r;
    if (p >= P) continue;
    const long long g = (long long)p * m + base + c;
    for (int k = 0; k < ntab; ++k) tab[k][r * chunk + c] = src[k][g];
  }
}

__global__ void __launch_bounds__(kThreads)
fused_kernel(const float* __restrict__ uc, const float* __restrict__ u0,
             const float* __restrict__ cdf, const float* __restrict__ mb,
             const float* __restrict__ sb, const float* __restrict__ ab,
             const float* __restrict__ bb, const float* __restrict__ wb,
             const float* __restrict__ wa, const float* __restrict__ ma,
             const float* __restrict__ sa, const float* __restrict__ low,
             const float* __restrict__ high, float* __restrict__ xo,
             float* __restrict__ eio, int P, int N, int m, int cols_log2,
             int bounded) {
  __shared__ float tab[6][kStage];
  const int cols = 1 << cols_log2;
  const int rows = kThreads >> cols_log2;  // rows per block
  const int chunk = kStage / rows;         // components per row and chunk
  const int r = threadIdx.x >> cols_log2;
  const int row0 = blockIdx.y * rows;
  const int p = row0 + r;
  const int j = blockIdx.x * cols + (threadIdx.x & (cols - 1));
  const bool live = p < P && j < N;
  const long long ix = (long long)p * N + j;
  const float ucv = live ? uc[ix] : 1.0f;
  const float u0v = live ? u0[ix] : 0.5f;

  // pass 1: the component of the first cdf entry >= uc (the last if none)
  const float* pick_src[5] = {cdf, mb, sb, ab, bb};
  bool done = false;
  float mu = 0.0f, s = 1.0f, a = 0.0f, b = 1.0f;
  for (int base = 0; base < m; base += chunk) {
    const int cnt = min(chunk, m - base);
    stage(tab, pick_src, 5, row0, rows, P, m, base, cnt, chunk);
    __syncthreads();
    const int o = r * chunk;
    for (int i = 0; i < cnt && !done; ++i) {
      if (ucv <= tab[0][o + i] || base + i == m - 1) {
        done = true;
        mu = tab[1][o + i];
        s = tab[2][o + i];
        a = tab[3][o + i];
        b = tab[4][o + i];
      }
    }
    __syncthreads();
  }

  // the draw: an inverse-CDF point inside the picked component's interval
  float u = __fmaf_rn(u0v, b - a, a);
  u = fminf(fmaxf(u, kUTiny), kUHigh);
  float x = __fmaf_rn(s, ndtri(u), mu);
  if (bounded && p < P) {
    const float lo = low[p], hi = high[p];
    x = fminf(fmaxf(x, lo), nextafterf(hi, lo));
  }

  // pass 2: both mixtures' streaming log-sum-exp at x
  const float* lse_src[6] = {wb, mb, sb, wa, ma, sa};
  float mx_b = kVeryNeg, se_b = 0.0f, mx_a = kVeryNeg, se_a = 0.0f;
  for (int base = 0; base < m; base += chunk) {
    const int cnt = min(chunk, m - base);
    stage(tab, lse_src, 6, row0, rows, P, m, base, cnt, chunk);
    __syncthreads();
    const int o = r * chunk;
    for (int i = 0; i < cnt; ++i) {
      lse_step(component(x, tab[0][o + i], tab[1][o + i], tab[2][o + i]), mx_b, se_b);
      lse_step(component(x, tab[3][o + i], tab[4][o + i], tab[5][o + i]), mx_a, se_a);
    }
    __syncthreads();
  }
  if (live) {
    xo[ix] = x;
    eio[ix] = (mx_b + logf(se_b)) - (mx_a + logf(se_a));
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
extern "C" int fused_sample_ei_f32(const float* uc, const float* u0, const float* cdf,
                                   const float* mb, const float* sb, const float* ab,
                                   const float* bb, const float* wb, const float* wa,
                                   const float* ma, const float* sa, const float* low,
                                   const float* high, float* x, float* ei, int P, int N,
                                   int m, int bounded, void* stream) {
  if (P <= 0 || N <= 0) return 0;
  int cols_log2 = 5;  // 32 candidates per row at least: one warp
  while ((1 << cols_log2) < N && cols_log2 < 8) ++cols_log2;
  const int rows = kThreads >> cols_log2;
  const dim3 grid((N + (1 << cols_log2) - 1) >> cols_log2, (P + rows - 1) / rows);
  fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      uc, u0, cdf, mb, sb, ab, bb, wb, wa, ma, sa, low, high, x, ei, P, N, m, cols_log2,
      bounded);
  return static_cast<int>(cudaGetLastError());
}
