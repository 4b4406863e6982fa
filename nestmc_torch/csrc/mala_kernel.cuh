// The fused MALA step of one likelihood family (obs_pass.cuh), with the
// optional streaming split-R-hat Welford fold: mala_accept.cu launches it
// for the hierarchical logistic groups (Logit, with or without the fold),
// poisson_accept.cu for the nested Poisson subjects (Poisson, no fold).
//
// Per (chain, unit) cell, in registers:
//   1. the full-conditional gradient at beta: the carried likelihood
//      gradient g plus the Gaussian prior's, g - (beta - mean)/tau^2, the
//      mean per chain or per unit (prior_mean);
//   2. the Langevin proposal beta + (s^2/2) g + s eps, s = e^log_scale (eps
//      from Philox or given);
//   3. one obs pass at the proposal: loglik (minus the unit's constant when
//      Fam::kConst) and gradient;
//   4. the conditional delta (loglik delta plus the prior quadratics; the
//      log tau terms cancel) and the asymmetric-proposal correction
//      (|s eps|^2 - |beta - prop - (s^2/2) g'|^2) / (2 s^2);
//   5. accept (log u < log alpha; NaN rejects) and the selects.
// FOLD folds the INPUT beta (the previous retained draw) into the
// (2, G, P, C) Welford accumulators with the per-half (count, active)
// scalars of nestmc_torch.diagnostics.fold_rhat_scalars.
//
// Layout and launch: one thread per cell, one unit per block, 128 chains
// per block; the unit's data sit in shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_pass.cuh"
#include "philox.cuh"

namespace nestmc {

constexpr int kMalaThreads = 128;

struct MalaArgs {
  const float* x;      // (G, n, P)
  const float* y;      // (G, n)
  const float* mask;   // (G, n)
  const float* cst;    // (G,) loglik constant (Fam::kConst), or null
  const float* beta;   // (C, G, P)
  const float* v;      // (C, G) carried loglik
  const float* g;      // (C, G, P) carried loglik gradient
  const float* ls;     // (C, G) log proposal scale
  const float* mean;   // prior mean: (C, P), or (C, G, P) when kUnitMean
  const float* lt;     // (C, P) log tau
  const float* eps;    // (C, G, P) external noise, or null
  const float* logu;   // (C, G) external noise, or null
  const float* fmean;  // (2, G, P, C) or null
  const float* fm2;    // (2, G, P, C) or null
  float* out_beta;
  float* out_v;
  float* out_g;
  float* out_alpha;
  float* out_fmean;
  float* out_fm2;
  float cnt[2];        // fold: count after this draw (>= 1), per half
  float act[2];        // fold: 1 if the draw belongs to the half, else 0
  int C, G, n;
  uint32_t k0, k1;     // Philox key
};

template <class Fam, int P, bool FOLD, bool EXT>
__global__ void __launch_bounds__(kMalaThreads)
    mala_step_kernel(const MalaArgs a) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + a.n * P;
  float* ms = ys + a.n;
  const int gi = blockIdx.x;
  stage_group<P>(a.x, a.y, a.mask, gi, a.n, xs, ys, ms);
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const size_t cell = (size_t)c * a.G + gi;

  float beta[P], mu[P], itau2[P], gcar[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    beta[k] = a.beta[cell * P + k];
    gcar[k] = a.g[cell * P + k];
    mu[k] = prior_mean<Fam, P>(a.mean, c, cell, k);
    itau2[k] = expf(-2.0f * a.lt[c * P + k]);
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
  const float s = expf(lsv);
  const float s2 = s * s;

  float db[P], prop[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    db[k] = beta[k] - mu[k];
    const float gold = gcar[k] - db[k] * itau2[k];
    prop[k] = beta[k] + 0.5f * s2 * gold + s * eps[k];
  }

  float llp, gll[P], unused[packed_dim(P)];
  obs_pass<Fam, P, false>(xs, ys, ms, a.n, prop, llp, gll, unused);
  if (Fam::kConst) llp -= a.cst[gi];

  float quad = 0.0f, fwd_sq = 0.0f, rev_sq = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float dp = prop[k] - mu[k];
    quad += -0.5f * (dp * dp - db[k] * db[k]) * itau2[k];
    const float gnew = gll[k] - dp * itau2[k];
    const float rev = beta[k] - prop[k] - 0.5f * s2 * gnew;
    const float fwd = s * eps[k];
    fwd_sq += fwd * fwd;
    rev_sq += rev * rev;
  }
  const float vold = a.v[cell];
  const float log_alpha =
      (llp - vold + quad) + (fwd_sq - rev_sq) / (2.0f * expf(2.0f * lsv));

  const bool accept = logu < log_alpha;  // NaN compares false: reject
  a.out_v[cell] = accept ? llp : vold;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    a.out_beta[cell * P + k] = accept ? prop[k] : beta[k];
    a.out_g[cell * P + k] = accept ? gll[k] : gcar[k];
  }
  a.out_alpha[cell] =
      isnan(log_alpha) ? 0.0f : expf(fminf(log_alpha, 0.0f));
}

template <class Fam, int P, bool FOLD, bool EXT>
cudaError_t launch_mala(const MalaArgs& a, cudaStream_t s) {
  const dim3 grid(a.G, (a.C + kMalaThreads - 1) / kMalaThreads);
  const size_t smem = sizeof(float) * (size_t)a.n * (P + 2);
  mala_step_kernel<Fam, P, FOLD, EXT><<<grid, kMalaThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace nestmc
