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
// Cephes' piecewise-rational formula as XLA compiles the JAX package's
// ndtri, which the plain torch version (tpe.ndtri) carries bit for bit: its
// Horner steps and the two sampling products are single-rounding FMAs, its
// tail takes XLA's float32 log (tpe.xla_log, below as xla_logf) and a
// correctly rounded sqrt, log(sqrt(y)) is 0.5 log(y) and a / b / z is
// a / (b z).  Every rounding step is an explicit intrinsic, so nvcc's FMA
// contraction cannot move x off the plain version's bits.
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
// m.  The service tick is short (N = ids x 24), so one row per block would
// leave most threads idle: a block holds 256 / C rows of C = next power of
// two >= N (at least 32, at most 256) candidates each, and wide rows take
// several blocks along N.
//
// What bounds it on an H100: special-function throughput in the score pass,
// at least one exp per candidate x component x model (132 SMs x 16 MUFU
// results per clock); the bytes (two uniforms in, two outputs, 36 bytes of
// tables per component and row) are small beside that.  The design:
// - pick pass: only the CDF is staged; a candidate whose uc falls in the
//   staged chunk (uc <= its last entry, or the last chunk) finds its
//   component by binary search there, the same lower bound as a linear
//   scan since the CDF is non-decreasing, and then reads its four sampling
//   entries from global memory once;
// - score pass: mixture_lse.cuh's loop, with log w, log s and 1/s hoisted
//   into per-(row, component) constants computed once per block while the
//   chunk is staged, so a term is a subtract, a multiply, an FMA and one
//   exp2 on a base-2 carry.

#include <cuda_runtime.h>

#include "mixture_lse.cuh"

using mixture_lse::Carry;

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 1024;     // staged components, shared by a block's rows
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

// XLA's float32 log: polynomial (highest power first), split ln 2
__constant__ float kLogP[9] = {7.0376836292e-2f, -1.1514610310e-1f, 1.1676998740e-1f,
                               -1.2420140846e-1f, 1.4249322787e-1f, -1.6668057665e-1f,
                               2.0000714765e-1f, -2.4999993993e-1f, 3.3333331174e-1f};
constexpr float kLogQ1 = -2.12194440e-4f;
constexpr float kLogQ2 = 0.693359375f;
constexpr float kSqrtHalf = 0.707106781186547524f;

template <int N>
__device__ __forceinline__ float horner(const float (&c)[N], float x) {
  float y = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) y = __fmaf_rn(y, x, c[k]);
  return y;
}

// XLA's float32 log (Cephes' logf), the form tpe.xla_log carries, for the
// positive normal inputs ndtri gives it
__device__ __forceinline__ float xla_logf(float x) {
  const int bits = __float_as_int(x);
  const float mant = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);  // [0.5, 1)
  const bool small = mant < kSqrtHalf;
  const float e = __fsub_rn(__fadd_rn((float)((bits >> 23) - 127), 1.0f), small ? 1.0f : 0.0f);
  const float f = __fadd_rn(__fsub_rn(mant, 1.0f), small ? mant : 0.0f);
  const float f2 = __fmul_rn(f, f);
  const float f3 = __fmul_rn(f2, f);
  const float g0 = __fmaf_rn(__fmaf_rn(f, kLogP[0], kLogP[1]), f, kLogP[2]);
  const float g1 = __fmaf_rn(__fmaf_rn(f, kLogP[3], kLogP[4]), f, kLogP[5]);
  const float g2 = __fmaf_rn(__fmaf_rn(f, kLogP[6], kLogP[7]), f, kLogP[8]);
  const float y = __fmaf_rn(__fmaf_rn(__fmaf_rn(g0, f3, g1), f3, g2), f3, __fmul_rn(e, kLogQ1));
  return __fmaf_rn(e, kLogQ2, __fadd_rn(__fsub_rn(f, __fmul_rn(0.5f, f2)), y));
}

__device__ float ndtri(float p) {
  const float kExpM2 = 0.1353352832366127f;          // exp(-2)
  const float kOneMinusExpM2 = 0.8646647167633873f;  // 1 - exp(-2)
  const float kNegSqrt2Pi = -2.5066282746310002f;
  const float mcp = p > kOneMinusExpM2 ? __fsub_rn(1.0f, p) : p;
  const float s = mcp == 0.0f ? 0.5f : mcp;
  float x;
  if (s > kExpM2) {
    const float w = __fsub_rn(s, 0.5f);
    const float ww = __fmul_rn(w, w);
    const float r = __fdiv_rn(horner(kP0, ww), horner(kQ0, ww));
    x = __fmul_rn(__fmaf_rn(__fmul_rn(w, ww), r, w), kNegSqrt2Pi);
  } else {
    const float y = __fmul_rn(-2.0f, xla_logf(s));
    const float z = __fsqrt_rn(y);
    const float first = __fsub_rn(z, __fdiv_rn(__fmul_rn(xla_logf(y), 0.5f), z));
    const float iz = __fdiv_rn(1.0f, z);
    const float tail = z >= 8.0f ? __fdiv_rn(horner(kP2, iz), __fmul_rn(horner(kQ2, iz), z))
                                 : __fdiv_rn(horner(kP1, iz), __fmul_rn(horner(kQ1, iz), z));
    x = __fsub_rn(first, tail);
  }
  return p > kOneMinusExpM2 ? x : -x;
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
  // per (row, component) score constants {c, k, mu} of both mixtures; the
  // pick pass reuses tb's storage for the staged CDF
  __shared__ float4 tb[kStage], ta[kStage];
  float* const scdf = reinterpret_cast<float*>(tb);
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
  bool done = !live;
  int comp = 0;
  for (int base = 0; base < m; base += chunk) {
    const int cnt = min(chunk, m - base);
    for (int t = threadIdx.x; t < rows * cnt; t += kThreads) {
      const int rr = t / cnt;
      const int c = t - rr * cnt;
      if (row0 + rr < P) scdf[rr * chunk + c] = cdf[(long long)(row0 + rr) * m + base + c];
    }
    __syncthreads();
    const float* row = scdf + r * chunk;
    if (!done && (ucv <= row[cnt - 1] || base + cnt == m)) {
      int lo = 0, hi = cnt - 1;  // lower bound of uc in row[0, cnt)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ucv <= row[mid]) hi = mid; else lo = mid + 1;
      }
      comp = base + lo;
      done = true;
    }
    if (__syncthreads_and(done)) break;
  }

  // the draw: an inverse-CDF point inside the picked component's interval
  float mu = 0.0f, s = 1.0f, a = 0.0f, b = 1.0f;
  if (live) {
    const long long g = (long long)p * m + comp;
    mu = mb[g];
    s = sb[g];
    a = ab[g];
    b = bb[g];
  }
  float u = __fmaf_rn(u0v, __fsub_rn(b, a), a);
  u = fminf(fmaxf(u, kUTiny), kUHigh);
  float x = __fmaf_rn(s, ndtri(u), mu);
  if (bounded && p < P) {
    const float lo = low[p], hi = high[p];
    x = fminf(fmaxf(x, lo), nextafterf(hi, lo));
  }

  // pass 2: both mixtures' streaming log-sum-exp at x
  Carry cb = mixture_lse::empty_carry(), ca = mixture_lse::empty_carry();
  for (int base = 0; base < m; base += chunk) {
    const int cnt = min(chunk, m - base);
    for (int t = threadIdx.x; t < rows * cnt; t += kThreads) {
      const int rr = t / cnt;
      const int c = t - rr * cnt;
      if (row0 + rr >= P) continue;
      const long long g = (long long)(row0 + rr) * m + base + c;
      tb[rr * chunk + c] = mixture_lse::make_term(wb[g], mb[g], sb[g]);
      ta[rr * chunk + c] = mixture_lse::make_term(wa[g], ma[g], sa[g]);
    }
    __syncthreads();
    const int o = r * chunk;
#pragma unroll 4
    for (int i = 0; i < cnt; ++i) {
      mixture_lse::step(tb[o + i], x, cb);
      mixture_lse::step(ta[o + i], x, ca);
    }
    __syncthreads();
  }
  if (live) {
    xo[ix] = x;
    eio[ix] = mixture_lse::score(cb, ca);
  }
}

void plan_of(int P, int N, int* plan) {
  int cols_log2 = 5;  // 32 candidates per row at least: one warp
  while ((1 << cols_log2) < N && cols_log2 < 8) ++cols_log2;
  const int rows = kThreads >> cols_log2;
  plan[0] = cols_log2;
  plan[1] = rows;
  plan[2] = ((N + (1 << cols_log2) - 1) >> cols_log2);  // blocks along N
  plan[3] = (P + rows - 1) / rows;                        // blocks along P
}

}  // namespace

// The launch's shape for (P, N, m): plan[0] candidates per row, plan[1]
// rows per block, plan[2] blocks, plan[3] threads per block.  Returns 0:
// the plan depends on the shape alone.
extern "C" int fused_sample_ei_plan(int P, int N, int m, int* plan) {
  int g[4];
  plan_of(P, N, g);
  plan[0] = 1 << g[0];
  plan[1] = g[1];
  plan[2] = g[2] * g[3];
  plan[3] = kThreads;
  return 0;
}

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
extern "C" int fused_sample_ei_f32(const float* uc, const float* u0, const float* cdf,
                                   const float* mb, const float* sb, const float* ab,
                                   const float* bb, const float* wb, const float* wa,
                                   const float* ma, const float* sa, const float* low,
                                   const float* high, float* x, float* ei, int P, int N,
                                   int m, int bounded, void* stream) {
  if (P <= 0 || N <= 0) return 0;
  int g[4];
  plan_of(P, N, g);
  const dim3 grid(g[2], g[3]);
  fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      uc, u0, cdf, mb, sb, ab, bb, wb, wa, ma, sa, low, high, x, ei, P, N, m, g[0],
      bounded);
  return static_cast<int>(cudaGetLastError());
}
