// One Newton-MH update of every (chain, group) block of the hierarchical
// logistic model, with the optional streaming split-R-hat Welford fold.
//
// Replaces nestmc/ops/pallas/newton_accept.py::fused_newton_logistic_step
// (kernel _make_fused_newton_kernel) and, inside it, the core-PRNG helpers
// of nestmc/ops/pallas/mh_accept.py (here csrc/philox.cuh).
//
// Per cell, in registers:
//   1. the conditional's gradient and packed -Hessian at beta from the
//      carried likelihood cache (v, g, h) plus the Gaussian group prior
//      N(mu, diag tau^2);
//   2. the packed Cholesky factor, the Newton mean beta + H^-1 g and the
//      proposal mean + c^1/2 L^-T eps (eps from Philox or given);
//   3. one obs pass at the proposal (csrc/logistic_terms.cuh): loglik,
//      gradient and, unless FROZEN, the packed -Hessian;
//   4. the reverse mean, the asymmetric-proposal correction and, unless
//      FROZEN, the log-determinant ratio (one log of the ratio of the
//      diagonal products);
//   5. accept (log u < log alpha; NaN rejects) and the selects.
// FOLD folds the INPUT beta (the previous retained draw) into the
// (2, G, P, C) Welford accumulators with the per-half (count, active)
// scalars of nestmc_torch.diagnostics.fold_rhat_scalars.
//
// Layout and launch: as loglik_logistic.cu, one thread per cell, one group
// per block, 128 chains per block; the group's data sits in shared memory.
// The fold accumulators are chains-minor, so a block's 128 threads read and
// write them in contiguous runs.
//
// Bound on the H100: at the judged shape a sampling (FROZEN + FOLD) call
// moves about 240 MB (beta, g and their outputs 4 x 16.4 MB, h 41 MB, the
// fold accumulators 131 MB read and written, v/log_scale/alpha 12 MB), 72 us
// at 3.35 TB/s, and runs the obs pass of loglik_logistic.cu plus two
// unrolled P x P Cholesky solves per cell. Measured on an H100 80GB HBM3 at
// 700 W (PERF.md): 0.30-0.43 ms frozen with the fold, 0.44-0.58 ms refresh,
// so the obs-pass arithmetic bounds it, as it bounds the eval kernels. The
// fold rides the beta read the step needs anyway; the Cholesky algebra costs
// no memory traffic. Vectorised loads and cheaper arithmetic are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "logistic_terms.cuh"
#include "philox.cuh"
#include "smallchol.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

namespace nestmc {

constexpr int kNewtonThreads = 128;

struct NewtonArgs {
  const float* x;      // (G, n, P)
  const float* y;      // (G, n)
  const float* mask;   // (G, n)
  const float* beta;   // (C, G, P)
  const float* v;      // (C, G) carried loglik
  const float* g;      // (C, G, P) carried loglik gradient
  const float* h;      // (C, G, T) carried packed -Hessian of the loglik
  const float* ls;     // (C, G) log sqrt(c)
  const float* mu;     // (C, P)
  const float* lt;     // (C, P) log tau
  const float* eps;    // (C, G, P) external noise, or null
  const float* logu;   // (C, G) external noise, or null
  const float* fmean;  // (2, G, P, C) or null
  const float* fm2;    // (2, G, P, C) or null
  float* out_beta;
  float* out_v;
  float* out_g;
  float* out_h;        // null when FROZEN
  float* out_alpha;
  float* out_fmean;
  float* out_fm2;
  float cnt[2];        // fold: count after this draw (>= 1), per half
  float act[2];        // fold: 1 if the draw belongs to the half, else 0
  int C, G, n;
  uint32_t k0, k1;     // Philox key
};

template <int P, bool FROZEN, bool FOLD, bool EXT>
__global__ void __launch_bounds__(kNewtonThreads)
    newton_step_kernel(const NewtonArgs a) {
  constexpr int T = packed_dim(P);
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + a.n * P;
  float* ms = ys + a.n;
  const int gi = blockIdx.x;
  stage_group<P>(a.x, a.y, a.mask, gi, a.n, xs, ys, ms);
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const size_t cell = (size_t)c * a.G + gi;

  float beta[P], itau2[P], db[P], gold[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    beta[k] = a.beta[cell * P + k];
    itau2[k] = expf(-2.0f * a.lt[c * P + k]);
    db[k] = beta[k] - a.mu[c * P + k];
    gold[k] = a.g[cell * P + k] - db[k] * itau2[k];
  }

  if (FOLD) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const size_t idx = (((size_t)hf * a.G + gi) * P + k) * a.C + c;
        const float m = a.fmean[idx];
        const float delta = beta[k] - m;
        const float nm = m + a.act[hf] * delta / a.cnt[hf];
        a.out_fmean[idx] = nm;
        a.out_fm2[idx] = a.fm2[idx] + a.act[hf] * delta * (beta[k] - nm);
      }
    }
  }

  float hold[T], Lold[T];
#pragma unroll
  for (int t = 0; t < T; ++t) hold[t] = a.h[cell * T + t];
#pragma unroll
  for (int k = 0; k < P; ++k) hold[pidx(k, k)] += itau2[k];
  chol<P>(hold, Lold);
  float step[P], mean_old[P];
  spd_solve<P>(Lold, gold, step);
#pragma unroll
  for (int k = 0; k < P; ++k) mean_old[k] = beta[k] + step[k];

  float eps[P], logu;
  if (EXT) {
#pragma unroll
    for (int k = 0; k < P; ++k) eps[k] = a.eps[cell * P + k];
    logu = a.logu[cell];
  } else {
    float u[2 * P + 1];
    philox_uniforms<2 * P + 1>(a.k0, a.k1, (uint32_t)cell, u);
#pragma unroll
    for (int k = 0; k < P; ++k) eps[k] = box_muller(u[2 * k], u[2 * k + 1]);
    logu = logf(u[2 * P]);
  }
  const float lsv = a.ls[cell];
  const float sc = expf(lsv);
  const float inv_c = expf(-2.0f * lsv);
  float shaped[P], prop[P];
  solve_upper_t<P>(Lold, eps, shaped);
#pragma unroll
  for (int k = 0; k < P; ++k) prop[k] = mean_old[k] + sc * shaped[k];

  float llp, gll[P], hll[T];
  obs_pass<P, !FROZEN>(xs, ys, ms, a.n, prop, llp, gll, hll);

  float dp[P], gnew[P];
  float quad = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    dp[k] = prop[k] - a.mu[c * P + k];
    gnew[k] = gll[k] - dp[k] * itau2[k];
    quad += -0.5f * (dp[k] * dp[k] - db[k] * db[k]) * itau2[k];
  }
  float Lnew[T];
  if (FROZEN) {
#pragma unroll
    for (int t = 0; t < T; ++t) Lnew[t] = Lold[t];
  } else {
    float hnew[T];
#pragma unroll
    for (int t = 0; t < T; ++t) hnew[t] = hll[t];
#pragma unroll
    for (int k = 0; k < P; ++k) hnew[pidx(k, k)] += itau2[k];
    chol<P>(hnew, Lnew);
  }
  float step_new[P], rev[P];
  spd_solve<P>(Lnew, gnew, step_new);
  float eps_sq = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    rev[k] = beta[k] - (prop[k] + step_new[k]);
    eps_sq += eps[k] * eps[k];
  }
  const float vold = a.v[cell];
  // forward whitened residual is exactly sqrt(c) eps by construction
  float log_alpha = (llp - vold + quad) +
                    0.5f * (eps_sq - inv_c * lt_vec_sq<P>(Lnew, rev));
  if (!FROZEN) {
    float det_ratio = Lnew[pidx(0, 0)] / Lold[pidx(0, 0)];
#pragma unroll
    for (int k = 1; k < P; ++k)
      det_ratio *= Lnew[pidx(k, k)] / Lold[pidx(k, k)];
    log_alpha += logf(det_ratio);
  }

  const bool accept = logu < log_alpha;  // NaN compares false: reject
  a.out_v[cell] = accept ? llp : vold;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    a.out_beta[cell * P + k] = accept ? prop[k] : beta[k];
    a.out_g[cell * P + k] = accept ? gll[k] : a.g[cell * P + k];
  }
  if (!FROZEN) {
#pragma unroll
    for (int t = 0; t < T; ++t)
      a.out_h[cell * T + t] = accept ? hll[t] : a.h[cell * T + t];
  }
  a.out_alpha[cell] =
      isnan(log_alpha) ? 0.0f : expf(fminf(log_alpha, 0.0f));
}

template <bool FROZEN, bool FOLD, bool EXT>
cudaError_t launch_newton(const NewtonArgs& a, cudaStream_t s) {
  constexpr int P = NESTMC_P;
  const dim3 grid(a.G, (a.C + kNewtonThreads - 1) / kNewtonThreads);
  const size_t smem = sizeof(float) * (size_t)a.n * (P + 2);
  newton_step_kernel<P, FROZEN, FOLD, EXT>
      <<<grid, kNewtonThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool FROZEN, bool FOLD>
cudaError_t launch_newton_noise(const NewtonArgs& a, cudaStream_t s) {
  return a.eps != nullptr ? launch_newton<FROZEN, FOLD, true>(a, s)
                          : launch_newton<FROZEN, FOLD, false>(a, s);
}

__global__ void philox_probe_kernel(float* normal, float* uniform, int count,
                                    uint32_t k0, uint32_t k1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float u[3];
  philox_uniforms<3>(k0, k1, (uint32_t)i, u);
  normal[i] = box_muller(u[0], u[1]);
  uniform[i] = u[2];
}

}  // namespace nestmc

// frozen: no Hessian in the obs pass and out_h unused; fmean != null turns
// on the fold; eps != null takes external noise (eps, logu) instead of
// Philox(k0, k1). Returns the cudaError_t of the launch (0 = success).
extern "C" int nestmc_newton_step(
    const float* x, const float* y, const float* mask, const float* beta,
    const float* v, const float* g, const float* h, const float* ls,
    const float* mu, const float* lt, const float* eps, const float* logu,
    const float* fmean, const float* fm2, float* out_beta, float* out_v,
    float* out_g, float* out_h, float* out_alpha, float* out_fmean,
    float* out_fm2, float cnt0, float act0, float cnt1, float act1, int C,
    int G, int n, unsigned int k0, unsigned int k1, int frozen,
    void* stream) {
  using namespace nestmc;
  NewtonArgs a{x,        y,       mask,       beta,   v,     g,      h,
               ls,       mu,      lt,         eps,    logu,  fmean,  fm2,
               out_beta, out_v,   out_g,      out_h,  out_alpha,
               out_fmean, out_fm2, {cnt0, cnt1}, {act0, act1},
               C,        G,       n,          k0,     k1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fold = fmean != nullptr;
  cudaError_t err;
  if (frozen) {
    err = fold ? launch_newton_noise<true, true>(a, s)
               : launch_newton_noise<true, false>(a, s);
  } else {
    err = fold ? launch_newton_noise<false, true>(a, s)
               : launch_newton_noise<false, false>(a, s);
  }
  return (int)err;
}

// Fills normal[i] (Box-Muller) and uniform[i] from cell i's Philox stream:
// the statistics probe of the in-kernel generator.
extern "C" int nestmc_philox_probe(float* normal, float* uniform, int count,
                                   unsigned int k0, unsigned int k1,
                                   void* stream) {
  const int threads = 256;
  nestmc::philox_probe_kernel<<<(count + threads - 1) / threads, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      normal, uniform, count, k0, k1);
  return (int)cudaGetLastError();
}
