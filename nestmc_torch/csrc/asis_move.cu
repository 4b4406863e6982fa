// The joint (mu, log tau) interweaving move of the hierarchical logistic
// model in its two gradient modes (Laplace with the carried or refreshed
// Hessian; Langevin with the data-constant bound metric), in three kernels
// around the obs pass:
//
//   asis_stats    one block a chain: the chain's sums over the rank's
//                 groups of g, g d, H, H_kl d_k, H_kl d_k d_l (d = beta -
//                 mu, or (beta - mu) e^{lt' - lt} at the proposal) and of
//                 the per-group loglik differences, one row of K floats;
//   asis_propose  the metric and gradient from the old row, the Cholesky
//                 factor, the proposal th' = (mu', lt') and, in the same
//                 launch, beta' = mu' + (beta - mu) e^{lt' - lt};
//   asis_accept   one thread a chain: the reverse metric and mean from the
//                 new row, the correction, the prior deltas, log alpha,
//                 the decision against the given log u, and alpha.
//
// Replaces no Pallas kernel: the reference (nestmc/models/hier_logistic.py,
// _asis_joint_grad, _asis_joint_metric and the smallchol calls of the
// move) leaves this to XLA, which fuses the sums over groups into the obs
// pass's consumers. In plain PyTorch the same move is about a thousand tiny
// launches a move at q = 8 and builds (C, G, p, p) temporaries; here the
// metric never exists per group: the per-chain row holds its sums.
//
// Sums: each thread walks the groups g = t, t + B, ... in order, then the
// block sums the threads' partials in a fixed tree (warp shuffles, then
// the warps in order). No atomics, so two launches give the same bits. The
// loglik enters as the per-group difference v_new - v_old, never as the
// difference of two large sums.
//
// Bound on the H100: the statistics pass reads beta, g, h (and v twice in
// the second call) once: at the judged shape (C=1024, G=1000, P=4) about
// 78 MB, 0.023 ms at 3.35 TB/s; on a mala-100k rank (C=256, G=50,000, P=3,
// the bound metric shared by every chain, so it stays in L2) about 360 MB,
// 0.107 ms. The proposal pass reads beta and writes beta' (33 MB, 0.010
// ms; 307 MB, 0.092 ms). The per-chain algebra (two 2P x 2P Cholesky
// factors, four triangular solves) is a few microseconds of one thread's
// latency, hidden behind the other blocks' streaming.

#include "smallchol.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

namespace nestmc {

constexpr int AP = NESTMC_P;
constexpr int AT = packed_dim(AP);
constexpr int AQ = 2 * AP;
constexpr int AQT = packed_dim(AQ);
// the statistics row: sum g | sum g d | sum H (packed) | sum H_kl d_k (k
// major) | sum H_kl d_k d_l (packed) | sum (v_new - v_old)
constexpr int kOffG = 0;
constexpr int kOffGD = AP;
constexpr int kOffH = 2 * AP;
constexpr int kOffHD = 2 * AP + AT;
constexpr int kOffHDD = 2 * AP + AT + AP * AP;
constexpr int kOffV = 2 * AP + 2 * AT + AP * AP;
constexpr int kRow = kOffV + 1;

constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kLog2 = 0.6931471805599453f;

// The population prior: mu_k ~ N(0, 1 / inv_s0_2); tau_k^2 ~ IG(a, b)
// (conj) or tau_k ~ HalfNormal(tau_scale), on log tau with the Jacobian.
struct AsisPrior {
  float inv_s0_2, a, b, lp_const, tau_scale, log_tau_scale, inv_S2;
  int conj;

  __device__ float lp(float lt) const {
    if (conj)
      return lp_const - 2.0f * (a + 1.0f) * lt - b * expf(-2.0f * lt) +
             kLog2 + 2.0f * lt;
    const float z = expf(lt) / tau_scale;
    return -0.5f * (z * z + kLog2Pi) + kLog2 - log_tau_scale + lt;
  }
  __device__ float grad(float lt) const {
    if (conj) return -2.0f * a + 2.0f * b * expf(-2.0f * lt);
    return 1.0f - expf(2.0f * lt) * inv_S2;
  }
  __device__ float metric(float lt) const {
    if (conj) return 4.0f * b * expf(-2.0f * lt);
    return 2.0f * expf(2.0f * lt) * inv_S2;
  }
};

// The packed 2P x 2P Gauss-Newton metric of the z-fixed target at (mu, lt)
// from a chain's row: [[sum H + I / s0^2, .], [sum H_kl d_k, sum H_kl d_k
// d_l + diag(tau metric)]], and the target's gradient.
__device__ __forceinline__ void joint_metric_grad(const float* __restrict__ row,
                                                  const float (&mu)[AP],
                                                  const float (&lt)[AP],
                                                  const AsisPrior& pr,
                                                  float (&M)[AQT],
                                                  float (&f)[AQ]) {
#pragma unroll
  for (int i = 0; i < AP; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j)
      M[pidx(i, j)] = row[kOffH + pidx(i, j)] + (i == j ? pr.inv_s0_2 : 0.0f);
  }
#pragma unroll
  for (int k = 0; k < AP; ++k) {
#pragma unroll
    for (int l = 0; l < AP; ++l) M[pidx(AP + k, l)] = row[kOffHD + k * AP + l];
#pragma unroll
    for (int l = 0; l <= k; ++l)
      M[pidx(AP + k, AP + l)] =
          row[kOffHDD + pidx(k, l)] + (k == l ? pr.metric(lt[k]) : 0.0f);
    f[k] = row[kOffG + k] - mu[k] * pr.inv_s0_2;
    f[AP + k] = row[kOffGD + k] + pr.grad(lt[k]);
  }
}

__device__ __forceinline__ float half_logdet(const float (&L)[AQT]) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < AQ; ++i) s += logf(L[pidx(i, i)]);
  return s;
}

// One block a chain. d = beta - mu, times the proposal's ratios aux[c, :P]
// when aux is given; h's chain stride is 0 for the shared bound; v_new and
// v_old (C, G) together or neither (then the row's last entry is 0).
template <int B>
__global__ void __launch_bounds__(B)
    asis_stats_kernel(const float* __restrict__ beta,
                      const float* __restrict__ mu,
                      const float* __restrict__ aux,
                      const float* __restrict__ g,
                      const float* __restrict__ h, long long h_stride,
                      const float* __restrict__ v_new,
                      const float* __restrict__ v_old,
                      float* __restrict__ out, int G) {
  constexpr int kWarps = B / 32;
  __shared__ float red[kWarps][kRow];
  const int c = blockIdx.x;
  float m[AP], r[AP];
#pragma unroll
  for (int k = 0; k < AP; ++k) {
    m[k] = mu[(size_t)c * AP + k];
    r[k] = aux != nullptr ? aux[(size_t)c * (AP + 1) + k] : 1.0f;
  }
  float acc[kRow];
#pragma unroll
  for (int k = 0; k < kRow; ++k) acc[k] = 0.0f;
  const float* bc = beta + (size_t)c * G * AP;
  const float* gc = g + (size_t)c * G * AP;
  const float* hc = h + (size_t)c * h_stride;
  for (int u = threadIdx.x; u < G; u += B) {
    float d[AP], gg[AP], hh[AT];
#pragma unroll
    for (int k = 0; k < AP; ++k) {
      d[k] = __fsub_rn(bc[(size_t)u * AP + k], m[k]);
      if (aux != nullptr) d[k] = __fmul_rn(d[k], r[k]);
      gg[k] = gc[(size_t)u * AP + k];
    }
#pragma unroll
    for (int t = 0; t < AT; ++t) hh[t] = hc[(size_t)u * AT + t];
#pragma unroll
    for (int k = 0; k < AP; ++k) {
      acc[kOffG + k] += gg[k];
      acc[kOffGD + k] += gg[k] * d[k];
#pragma unroll
      for (int l = 0; l < AP; ++l)
        acc[kOffHD + k * AP + l] += hh[pidx(k, l)] * d[k];
#pragma unroll
      for (int l = 0; l <= k; ++l)
        acc[kOffHDD + pidx(k, l)] += hh[pidx(k, l)] * d[k] * d[l];
    }
#pragma unroll
    for (int t = 0; t < AT; ++t) acc[kOffH + t] += hh[t];
    if (v_new != nullptr)
      acc[kOffV] += v_new[(size_t)c * G + u] - v_old[(size_t)c * G + u];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kRow; ++k) {
    float x = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp][k] = x;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kRow; k += B) {
    float s = red[0][k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][k];
    out[(size_t)c * kRow + k] = s;
  }
}

// Blocks (c, y): every block of chain c computes the chain's proposal (the
// same bits in each), block y == 0 writes th_new and aux, and each block
// writes its part of beta_new's row. scale null: the Laplace move (s = 1,
// drift 1), else the Langevin move at s = scale[c] (drift s^2 / 2).
template <int B>
__global__ void __launch_bounds__(B)
    asis_propose_kernel(const float* __restrict__ row,
                        const float* __restrict__ mu,
                        const float* __restrict__ lt,
                        const float* __restrict__ eps,
                        const float* __restrict__ scale,
                        const float* __restrict__ beta,
                        float* __restrict__ th_new, float* __restrict__ aux,
                        float* __restrict__ beta_new, int G, int chunk,
                        AsisPrior pr) {
  __shared__ float sm[3 * AP];  // mu, mu', e^{lt' - lt}
  const int c = blockIdx.x;
  if (threadIdx.x == 0) {
    float m[AP], l[AP], M[AQT], L[AQT], f[AQ], e[AQ], x[AQ], z[AQ];
#pragma unroll
    for (int k = 0; k < AP; ++k) {
      m[k] = mu[(size_t)c * AP + k];
      l[k] = lt[(size_t)c * AP + k];
    }
    const float* rc = row + (size_t)c * kRow;
    joint_metric_grad(rc, m, l, pr, M, f);
    chol<AQ>(M, L);
    spd_solve<AQ>(L, f, x);
#pragma unroll
    for (int i = 0; i < AQ; ++i) e[i] = eps[(size_t)c * AQ + i];
    solve_upper_t<AQ>(L, e, z);
    const float s = scale != nullptr ? scale[c] : 1.0f;
    const float drift = scale != nullptr ? 0.5f * s * s : 1.0f;
    float th[AQ], ee = 0.0f;
#pragma unroll
    for (int i = 0; i < AQ; ++i) {
      const float old = i < AP ? m[i] : l[i - AP];
      th[i] = (old + drift * x[i]) + s * z[i];
      ee += e[i] * e[i];
    }
#pragma unroll
    for (int k = 0; k < AP; ++k) {
      sm[k] = m[k];
      sm[AP + k] = th[k];
      sm[2 * AP + k] = expf(th[AP + k] - l[k]);
    }
    if (blockIdx.y == 0) {
#pragma unroll
      for (int i = 0; i < AQ; ++i) th_new[(size_t)c * AQ + i] = th[i];
#pragma unroll
      for (int k = 0; k < AP; ++k)
        aux[(size_t)c * (AP + 1) + k] = sm[2 * AP + k];
      aux[(size_t)c * (AP + 1) + AP] = 0.5f * ee - half_logdet(L);
    }
  }
  __syncthreads();
  const int n = G * AP;
  const int i0 = blockIdx.y * chunk;
  const int i1 = min(n, i0 + chunk);
  const float* bc = beta + (size_t)c * n;
  float* oc = beta_new + (size_t)c * n;
  for (int i = i0 + threadIdx.x; i < i1; i += B) {
    const int k = i % AP;
    const float d = __fmul_rn(__fsub_rn(bc[i], sm[k]), sm[2 * AP + k]);
    oc[i] = __fadd_rn(sm[AP + k], d);
  }
}

// One thread a chain: the reverse half of the move from the proposal's row.
// NaN anywhere (a metric that is not positive definite) rejects, alpha 0.
__global__ void asis_accept_kernel(const float* __restrict__ row,
                                   const float* __restrict__ th_new,
                                   const float* __restrict__ mu,
                                   const float* __restrict__ lt,
                                   const float* __restrict__ aux,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ logu,
                                   float* __restrict__ log_alpha,
                                   bool* __restrict__ accept,
                                   float* __restrict__ alpha, int C,
                                   AsisPrior pr) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float m[AP], l[AP], mn[AP], ln[AP], th[AQ], M[AQT], L[AQT], f[AQ], x[AQ];
#pragma unroll
  for (int k = 0; k < AP; ++k) {
    m[k] = mu[(size_t)c * AP + k];
    l[k] = lt[(size_t)c * AP + k];
  }
#pragma unroll
  for (int i = 0; i < AQ; ++i) th[i] = th_new[(size_t)c * AQ + i];
#pragma unroll
  for (int k = 0; k < AP; ++k) {
    mn[k] = th[k];
    ln[k] = th[AP + k];
  }
  const float* rc = row + (size_t)c * kRow;
  joint_metric_grad(rc, mn, ln, pr, M, f);
  chol<AQ>(M, L);
  spd_solve<AQ>(L, f, x);
  const float s = scale != nullptr ? scale[c] : 1.0f;
  const float drift = scale != nullptr ? 0.5f * s * s : 1.0f;
  const float inv_2s2 = scale != nullptr ? 0.5f / (s * s) : 0.5f;
  float r[AQ];
#pragma unroll
  for (int i = 0; i < AQ; ++i) {
    const float old = i < AP ? m[i] : l[i - AP];
    r[i] = old - (th[i] + drift * x[i]);
  }
  const float q_corr = -inv_2s2 * lt_vec_sq<AQ>(L, r) + half_logdet(L) +
                       aux[(size_t)c * (AP + 1) + AP];
  float tau_delta = 0.0f, mu_delta = 0.0f;
#pragma unroll
  for (int k = 0; k < AP; ++k) {
    // log_scale_guard: -inf outside |log tau| < 12
    const float guard = fabsf(ln[k]) < 12.0f ? 0.0f : __int_as_float(0xff800000);
    tau_delta += pr.lp(ln[k]) + guard - pr.lp(l[k]);
    mu_delta += -0.5f * (mn[k] * mn[k] - m[k] * m[k]) * pr.inv_s0_2;
  }
  const float la = rc[kOffV] + (tau_delta + mu_delta) + q_corr;
  log_alpha[c] = la;
  accept[c] = logu[c] < la;
  alpha[c] = isnan(la) ? 0.0f : expf(fminf(la, 0.0f));
}

}  // namespace nestmc

// Entry points; each returns the cudaError_t of its launch (0 = success).

// The width of a statistics row (K).
extern "C" int nestmc_asis_row() { return nestmc::kRow; }

// beta, g (C, G, P); mu (C, P); aux (C, P + 1) or null; h: row c at h + c *
// h_stride, (G, T) each (h_stride 0: one (G, T) shared by every chain);
// v_new, v_old (C, G) or both null; out (C, K).
extern "C" int nestmc_asis_stats(const float* beta, const float* mu,
                                 const float* aux, const float* g,
                                 const float* h, long long h_stride,
                                 const float* v_new, const float* v_old,
                                 float* out, int C, int G, void* stream) {
  if (C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // long rows: wider blocks keep enough loads in flight. The width follows
  // G alone, so a chain's sums (and bits) do not depend on how many chains
  // a launch holds: a chain-sharded run sums as the unsharded one does
  if (G >= 8192)
    nestmc::asis_stats_kernel<512><<<C, 512, 0, s>>>(
        beta, mu, aux, g, h, h_stride, v_new, v_old, out, G);
  else
    nestmc::asis_stats_kernel<256><<<C, 256, 0, s>>>(
        beta, mu, aux, g, h, h_stride, v_new, v_old, out, G);
  return (int)cudaGetLastError();
}

// row (C, K); mu, lt (C, P); eps (C, 2P); scale (C,) or null; beta,
// beta_new (C, G, P); th_new (C, 2P); aux (C, P + 1): e^{lt' - lt}, then
// 0.5 |eps|^2 - log det L_old.
extern "C" int nestmc_asis_propose(const float* row, const float* mu,
                                   const float* lt, const float* eps,
                                   const float* scale, const float* beta,
                                   float* th_new, float* aux, float* beta_new,
                                   int C, int G, float inv_s0_2, float a,
                                   float b, float lp_const, float tau_scale,
                                   float log_tau_scale, float inv_S2, int conj,
                                   void* stream) {
  if (C <= 0) return 0;
  constexpr int B = 256;
  // about a thousand blocks over the card: a chain's row of beta is cut
  // into `parts` chunks when there are few chains
  const long long n = (long long)G * nestmc::AP;
  int parts = (1024 + C - 1) / C;
  const long long most = (n + 4 * B - 1) / (4 * B);  // >= 4 items a thread
  if (parts > most) parts = (int)(most > 0 ? most : 1);
  if (parts > 65535) parts = 65535;
  const int chunk = (int)((n + parts - 1) / parts);
  nestmc::AsisPrior pr{inv_s0_2, a, b, lp_const, tau_scale, log_tau_scale,
                       inv_S2, conj};
  nestmc::asis_propose_kernel<B>
      <<<dim3(C, parts), B, 0, static_cast<cudaStream_t>(stream)>>>(
          row, mu, lt, eps, scale, beta, th_new, aux, beta_new, G, chunk, pr);
  return (int)cudaGetLastError();
}

// row (C, K) at the proposal; th_new (C, 2P); mu, lt (C, P) the current
// point; aux from asis_propose; scale (C,) or null; logu (C,); out:
// log_alpha, accept (bool), alpha, each (C,).
extern "C" int nestmc_asis_accept(const float* row, const float* th_new,
                                  const float* mu, const float* lt,
                                  const float* aux, const float* scale,
                                  const float* logu, float* log_alpha,
                                  bool* accept, float* alpha, int C,
                                  float inv_s0_2, float a, float b,
                                  float lp_const, float tau_scale,
                                  float log_tau_scale, float inv_S2, int conj,
                                  void* stream) {
  if (C <= 0) return 0;
  constexpr int B = 128;
  nestmc::AsisPrior pr{inv_s0_2, a, b, lp_const, tau_scale, log_tau_scale,
                       inv_S2, conj};
  nestmc::asis_accept_kernel<<<(C + B - 1) / B, B, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      row, th_new, mu, lt, aux, scale, logu, log_alpha, accept, alpha, C, pr);
  return (int)cudaGetLastError();
}
