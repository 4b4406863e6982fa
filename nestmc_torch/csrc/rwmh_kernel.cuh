// The fused random-walk MH step of one likelihood family (obs_pass.cuh):
// mh_accept.cu launches it for the hierarchical logistic groups (Logit),
// poisson_accept.cu for the nested Poisson subjects (Poisson).
//
// Per (chain, unit) cell, in registers: the proposal beta + e^log_scale
// eps (eps from csrc/philox.cuh or given); one value-only obs pass at the
// proposal, minus the unit's constant when Fam::kConst; log alpha =
// loglik' - carried loglik + the Gaussian prior's quadratic delta around
// the prior mean (per chain or per unit: prior_mean; the log tau terms
// cancel); accept (log u < log alpha; NaN rejects) and the selects of beta
// and the carried loglik.
//
// Layout and launch: one thread per cell, one unit per block, 128 chains
// per block, the unit's data in shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_pass.cuh"
#include "philox.cuh"

namespace nestmc {

constexpr int kRwThreads = 128;

struct RwArgs {
  const float* x;      // (G, n, P)
  const float* y;      // (G, n)
  const float* mask;   // (G, n)
  const float* cst;    // (G,) loglik constant (Fam::kConst), or null
  const float* beta;   // (C, G, P)
  const float* lik;    // (C, G) carried loglik
  const float* ls;     // (C, G) log proposal scale
  const float* mean;   // prior mean: (C, P), or (C, G, P) when kUnitMean
  const float* lt;     // (C, P) log tau
  const float* eps;    // (C, G, P) external noise, or null
  const float* logu;   // (C, G) external noise, or null
  float* out_beta;
  float* out_lik;
  float* out_alpha;
  int C, G, n;
  uint32_t k0, k1;     // Philox key
};

template <class Fam, int P, bool EXT>
__global__ void __launch_bounds__(kRwThreads) rwmh_step_kernel(const RwArgs a) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + a.n * P;
  float* ms = ys + a.n;
  const int gi = blockIdx.x;
  stage_group<P>(a.x, a.y, a.mask, gi, a.n, xs, ys, ms);
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const size_t cell = (size_t)c * a.G + gi;

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
  const float s = expf(a.ls[cell]);
  float beta[P], prop[P];
  float quad = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    beta[k] = a.beta[cell * P + k];
    prop[k] = beta[k] + s * eps[k];
    const float mu = prior_mean<Fam, P>(a.mean, c, cell, k);
    const float itau2 = expf(-2.0f * a.lt[c * P + k]);
    const float dp = prop[k] - mu;
    const float db = beta[k] - mu;
    quad += -0.5f * (dp * dp - db * db) * itau2;
  }
  float llp = obs_loglik<Fam, P>(xs, ys, ms, a.n, prop);
  if (Fam::kConst) llp -= a.cst[gi];
  const float lold = a.lik[cell];
  const float log_alpha = llp - lold + quad;

  const bool accept = logu < log_alpha;  // NaN compares false: reject
  a.out_lik[cell] = accept ? llp : lold;
#pragma unroll
  for (int k = 0; k < P; ++k)
    a.out_beta[cell * P + k] = accept ? prop[k] : beta[k];
  a.out_alpha[cell] =
      isnan(log_alpha) ? 0.0f : expf(fminf(log_alpha, 0.0f));
}

// eps != null takes external noise (eps, logu) instead of Philox(k0, k1).
template <class Fam, int P>
cudaError_t launch_rwmh(const RwArgs& a, cudaStream_t s) {
  const dim3 grid(a.G, (a.C + kRwThreads - 1) / kRwThreads);
  const size_t smem = sizeof(float) * (size_t)a.n * (P + 2);
  if (a.eps != nullptr) {
    rwmh_step_kernel<Fam, P, true><<<grid, kRwThreads, smem, s>>>(a);
  } else {
    rwmh_step_kernel<Fam, P, false><<<grid, kRwThreads, smem, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace nestmc
