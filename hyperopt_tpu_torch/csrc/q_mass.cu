// Quantized-bin EI score of TPE candidates: for every value-space
// candidate x of a label, the log bin mass of the "below" Parzen mixture
// minus that of the "above" mixture,
//
//   out[p, j] = log max(M_b(x), EPS) - log max(M_a(x), EPS),
//   M(x)      = sum_i w_i (cdf_i(ub) - cdf_i(lb)),
//
// with the bin [lb, ub] = [x - q/2, x + q/2] clamped to [lo, hi] (a bounded
// linear label), and for a log label (islog) the lognormal CDF of the bin
// with its lower edge at 0 and, bounded, clamped to [exp lo, exp hi].  No
// truncation terms: the caller adds -log p_b + log p_a.  The function is
// the port's tpe._q_lpdf_group, bin for bin, in float32:
//
// - cdf_i(t) = 0.5 (1 + erf((t - mu_i) / (sqrt2 * sigma_i))), erf in XLA's
//   clamped rational form with each Horner step one fmaf (what tpe._horner
//   emulates through a float64 product), an IEEE division per term and the
//   constants as float32; a log label's cdf_i(v) is cdf_i(log max(v, EPS))
//   for v > 0 and 0 otherwise, logf of each edge once per candidate;
// - the arithmetic that must round as the torch expression rounds is
//   written with __f*_rn intrinsics, which nvcc never contracts; the
//   sources build without -use_fast_math.
//
// Replaces no TPU kernel: the JAX package leaves the bin masses to XLA.  It
// was added because the torch expression materializes [G, m, N] float64
// operands for every Horner step (6.4 GB each at the batch driver's
// (3, 65536, 4097)), and the batch cell spent ~89 % of its device time
// there.
//
// What bounds it on an H100: instruction throughput.  Each candidate x
// component x mixture x bin edge is one erf: 10 Horner fmaf, two IEEE
// divisions (a MUFU.RCP and its Newton steps each), the clamp and the
// scaling, some 35 instruction slots; nothing is read from memory per term
// (measured: 6.3 ms at (3, 65536, 4097), 31 % of a 41-slot bound that
// counts a division as one slot).  The design:
// - component tiles (w, mu, sqrt2 * sigma) of both mixtures are staged in
//   shared memory, kChunk at a time, so nothing grows with m;
// - each candidate keeps its two float32 sums in registers, compensated
//   (Kahan), so the order of the sum moves the result by less than the
//   torch reduction's own rounding;
// - `lanes` consecutive threads of a warp share one candidate and take the
//   components i = lane, lane + lanes, ... in turn; their sums merge by a
//   fixed shuffle tree.  q_mass_diff_plan picks `lanes` from the shape:
//   as few as fill the card with blocks, more where a tile of candidates
//   would leave threads idle at no cost in blocks.  No atomics, so two
//   launches, and a graph replay and an eager launch, agree bit for bit.
// The grid is (candidate tiles, P).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kChunk = 256;    // components of each mixture staged at once
constexpr int kMaxLanes = 32;  // a candidate's lanes lie in one warp

// float32 constants of tpe.py, as hex
constexpr float kEps = 0x1.197998p-40f;      // EPS = 1e-12
constexpr float kSqrt2 = 0x1.6a09e6p+0f;     // _SQRT2
constexpr float kErfClamp = 0x1.df38cep+1f;  // _ERF_CLAMP
// _ERF_P and _ERF_Q, highest power first
constexpr float kP0 = 0x1.e05aa2p-13f, kP1 = 0x1.bebb44p-9f, kP2 = 0x1.a16dd6p-5f,
                kP3 = 0x1.7b4e8p-3f, kP4 = 0x1.20dd74p+0f;
constexpr float kQ0 = -0x1.fa720cp-24f, kQ1 = 0x1.8b11bep-16f, kQ2 = 0x1.0ada5p-10f,
                kQ3 = 0x1.cd0fa8p-7f, kQ4 = 0x1.c69842p-4f, kQ5 = 0x1.fd6894p-2f,
                kQ6 = 1.0f;

// tpe.erf: z clamped, (z * P(z^2)) / Q(z^2)
__device__ __forceinline__ float xla_erf(float z) {
  z = fminf(fmaxf(z, -kErfClamp), kErfClamp);
  const float z2 = __fmul_rn(z, z);
  float p = fmaf(kP0, z2, kP1);
  p = fmaf(p, z2, kP2);
  p = fmaf(p, z2, kP3);
  p = fmaf(p, z2, kP4);
  float q = fmaf(kQ0, z2, kQ1);
  q = fmaf(q, z2, kQ2);
  q = fmaf(q, z2, kQ3);
  q = fmaf(q, z2, kQ4);
  q = fmaf(q, z2, kQ5);
  q = fmaf(q, z2, kQ6);
  return __fdiv_rn(__fmul_rn(z, p), q);
}

// tpe.normal_cdf at t of the component {w, mu, sqrt2 * sigma}
__device__ __forceinline__ float ncdf(float t, const float4& c) {
  return __fmul_rn(0.5f, __fadd_rn(1.0f, xla_erf(__fdiv_rn(__fsub_rn(t, c.y), c.z))));
}

// Adds v to the compensated sum (s, e).
__device__ __forceinline__ void kahan(float v, float& s, float& e) {
  const float y = __fsub_rn(v, e);
  const float t = __fadd_rn(s, y);
  e = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// Sums v over the `lanes` consecutive lanes of a group; lane 0 of the
// group holds the total.  A fixed tree: the same order on every launch.
__device__ __forceinline__ float lane_sum(float v, int lanes) {
  for (int off = lanes / 2; off > 0; off /= 2)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off, lanes));
  return v;
}

__global__ void __launch_bounds__(kThreads)
q_mass_kernel(const float* __restrict__ x,
              const float* __restrict__ wb, const float* __restrict__ mb,
              const float* __restrict__ sb, const float* __restrict__ wa,
              const float* __restrict__ ma, const float* __restrict__ sa,
              const float* __restrict__ qv, const float* __restrict__ lov,
              const float* __restrict__ hiv, const unsigned char* __restrict__ islog,
              float* __restrict__ out, int n, int m, int lanes, int bounded,
              int has_log) {
  __shared__ float4 tb[kChunk], ta[kChunk];
  const int p = blockIdx.y;
  const long long row_x = (long long)p * n;
  const long long row_t = (long long)p * m;
  const int lane = threadIdx.x % lanes;
  const long long j = (long long)blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  const bool live = j < n;

  // the bin's edges in the CDF's argument, and whether each edge is alive
  // (a log label's edge at or below 0 has CDF 0)
  const float xv = live ? x[row_x + j] : 0.0f;
  const float q2 = __fmul_rn(qv[p], 0.5f);
  const float lo = lov[p], hi = hiv[p];
  const float ub = __fadd_rn(xv, q2), lb = __fsub_rn(xv, q2);
  float tu, tl;
  bool au = true, al = true;
  if (has_log && islog[p]) {
    float ubl = ub, lbl = fmaxf(lb, 0.0f);
    if (bounded) {
      ubl = fminf(ubl, expf(hi));
      lbl = fmaxf(lbl, expf(lo));
    }
    au = ubl > 0.0f;
    al = lbl > 0.0f;
    tu = logf(fmaxf(ubl, kEps));
    tl = logf(fmaxf(lbl, kEps));
  } else {
    tu = bounded ? fminf(ub, hi) : ub;
    tl = bounded ? fmaxf(lb, lo) : lb;
  }

  float sb_ = 0.0f, eb = 0.0f, sa_ = 0.0f, ea = 0.0f;
  for (int base = 0; base < m; base += kChunk) {
    const int cnt = min(kChunk, m - base);
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      const long long g = row_t + base + i;
      tb[i] = make_float4(wb[g], mb[g], __fmul_rn(kSqrt2, sb[g]), 0.0f);
      ta[i] = make_float4(wa[g], ma[g], __fmul_rn(kSqrt2, sa[g]), 0.0f);
    }
    __syncthreads();
    for (int i = lane; i < cnt; i += lanes) {
      const float4 b = tb[i], a = ta[i];
      const float bu = au ? ncdf(tu, b) : 0.0f, bl = al ? ncdf(tl, b) : 0.0f;
      const float cu = au ? ncdf(tu, a) : 0.0f, cl = al ? ncdf(tl, a) : 0.0f;
      kahan(__fmul_rn(b.x, __fsub_rn(bu, bl)), sb_, eb);
      kahan(__fmul_rn(a.x, __fsub_rn(cu, cl)), sa_, ea);
    }
    __syncthreads();
  }
  const float mass_b = lane_sum(__fsub_rn(sb_, eb), lanes);
  const float mass_a = lane_sum(__fsub_rn(sa_, ea), lanes);
  if (live && lane == 0)
    out[row_x + j] = __fsub_rn(logf(fmaxf(mass_b, kEps)), logf(fmaxf(mass_a, kEps)));
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

long long tiles(int n, int lanes) {
  const long long per_block = kThreads / lanes;
  return (n + per_block - 1) / per_block;
}

}  // namespace

// The launch's shape for (P, n, m): plan[0] lanes per candidate, plan[1]
// candidates per block, plan[2] blocks, plan[3] threads per block.  The
// lanes double (up to 32, and no more than the components) while the grid
// holds fewer than two blocks per SM, or while doubling them adds no
// block.  Returns the error of the SM-count query, and then leaves plan
// as it was.
extern "C" int q_mass_diff_plan(int P, int n, int m, int* plan) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long target = 2LL * sms;
  int lanes = 1;
  while (lanes * 2 <= kMaxLanes && lanes * 2 <= m) {
    const long long now = (long long)P * tiles(n, lanes);
    if (now >= target && tiles(n, lanes * 2) > tiles(n, lanes)) break;
    lanes *= 2;
  }
  plan[0] = lanes;
  plan[1] = kThreads / lanes;
  plan[2] = (int)((long long)P * tiles(n, lanes));
  plan[3] = kThreads;
  return 0;
}

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
// islog is [P] bytes (a torch bool tensor), read when has_log.
extern "C" int q_mass_diff_f32(const float* x, const float* wb, const float* mb,
                               const float* sb, const float* wa, const float* ma,
                               const float* sa, const float* q, const float* lo,
                               const float* hi, const unsigned char* islog, float* out,
                               int P, int n, int m, int bounded, int has_log,
                               void* stream) {
  if (P <= 0 || n <= 0) return 0;
  int plan[4];
  const int plan_err = q_mass_diff_plan(P, n, m, plan);
  if (plan_err != 0) return plan_err;
  const dim3 grid((unsigned)tiles(n, plan[0]), (unsigned)P);
  q_mass_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, wb, mb, sb, wa, ma, sa, q, lo, hi, islog, out, n, m, plan[0], bounded, has_log);
  return static_cast<int>(cudaGetLastError());
}
