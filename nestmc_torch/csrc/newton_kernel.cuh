// The fused Newton-MH step of one likelihood family (obs_pass.cuh), with
// the optional streaming split-R-hat Welford fold: newton_accept.cu
// launches it for the hierarchical logistic groups (Logit), poisson_accept.cu
// for the nested Poisson subjects (Poisson, no fold).
//
// Per (chain, unit) cell, in registers:
//   1. the conditional's gradient and packed -Hessian at beta from the
//      carried likelihood cache (v, g, h) plus the Gaussian prior
//      N(mean, diag tau^2), the mean per chain or per unit (prior_mean);
//   2. the packed Cholesky factor, the Newton mean beta + H^-1 g and the
//      proposal mean + c^1/2 L^-T eps (eps from Philox or given);
//   3. one obs pass at the proposal: loglik (minus the unit's constant when
//      Fam::kConst), gradient and, unless FROZEN, the packed -Hessian;
//   4. the reverse mean, the asymmetric-proposal correction and, unless
//      FROZEN, the log-determinant ratio (one log of the ratio of the
//      diagonal products);
//   5. accept (log u < log alpha; NaN rejects) and the selects.
// FOLD folds the INPUT beta (the previous retained draw) into the
// (2, G, P, C) Welford accumulators with the per-half (count, active)
// scalars of nestmc_torch.diagnostics.fold_rhat_scalars.
//
// Layout and launch: one thread per cell, one unit per block, 128 chains
// per block; the unit's data sit in shared memory. The fold accumulators
// are chains-minor, so a block's 128 threads read and write them in
// contiguous runs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_pass.cuh"
#include "philox.cuh"
#include "smallchol.cuh"

namespace nestmc {

constexpr int kNewtonThreads = 128;

struct NewtonArgs {
  const float* x;      // (G, n, P)
  const float* y;      // (G, n)
  const float* mask;   // (G, n)
  const float* cst;    // (G,) loglik constant (Fam::kConst), or null
  const float* beta;   // (C, G, P)
  const float* v;      // (C, G) carried loglik
  const float* g;      // (C, G, P) carried loglik gradient
  const float* h;      // (C, G, T) carried packed -Hessian of the loglik
  const float* ls;     // (C, G) log sqrt(c)
  const float* mean;   // prior mean: (C, P), or (C, G, P) when kUnitMean
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

template <class Fam, int P, bool FROZEN, bool FOLD, bool EXT>
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
    db[k] = beta[k] - prior_mean<Fam, P>(a.mean, c, cell, k);
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
  obs_pass<Fam, P, !FROZEN>(xs, ys, ms, a.n, prop, llp, gll, hll);
  if (Fam::kConst) llp -= a.cst[gi];

  float dp[P], gnew[P];
  float quad = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    dp[k] = prop[k] - prior_mean<Fam, P>(a.mean, c, cell, k);
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

template <class Fam, int P, bool FROZEN, bool FOLD>
cudaError_t launch_newton(const NewtonArgs& a, cudaStream_t s) {
  const dim3 grid(a.G, (a.C + kNewtonThreads - 1) / kNewtonThreads);
  const size_t smem = sizeof(float) * (size_t)a.n * (P + 2);
  if (a.eps != nullptr) {
    newton_step_kernel<Fam, P, FROZEN, FOLD, true>
        <<<grid, kNewtonThreads, smem, s>>>(a);
  } else {
    newton_step_kernel<Fam, P, FROZEN, FOLD, false>
        <<<grid, kNewtonThreads, smem, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace nestmc
