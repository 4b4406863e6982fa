// Per-observation Bernoulli-logit terms, shared by every kernel that makes
// an obs pass (loglik_logistic.cu, newton_accept.cu, mala_accept.cu,
// mh_accept.cu), so the eval kernels and the fused steps compute the same
// numbers.
//
// Port of nestmc/ops/pallas/loglik_logistic.py::_lik_terms_w: one exp and
// one log1p per observation. With e = exp(-|eta|):
//   softplus(eta) = max(eta, 0) + log1p(e)
//   sigmoid(eta)  = 1/(1+e) for eta >= 0, e/(1+e) otherwise
//   w = sigmoid (1 - sigmoid) = e/(1+e)^2
// Built without --use_fast_math: expf/log1pf keep full accuracy and a NaN
// eta stays NaN, so a NaN proposal is rejected by the accept rule.
#pragma once

#include "smallchol.cuh"

namespace nestmc {

__device__ __forceinline__ void logit_terms(float eta, float y, float m,
                                            float& ll, float& resid,
                                            float& w) {
  const float e = expf(-fabsf(eta));
  const float sp = fmaxf(eta, 0.0f) + log1pf(e);
  const float inv = 1.0f / (1.0f + e);
  const float sig = eta >= 0.0f ? inv : e * inv;
  ll = (y * eta - sp) * m;
  resid = (y - sig) * m;
  w = e * inv * inv * m;
}

// The value-only term (one exp, one log1p; no division): the loglik of the
// RW-MH step and of the value-only eval kernel.
__device__ __forceinline__ float logit_ll(float eta, float y, float m) {
  const float sp = fmaxf(eta, 0.0f) + log1pf(expf(-fabsf(eta)));
  return (y * eta - sp) * m;
}

// Value-only pass over a group's n observations (staged as for obs_pass).
template <int P>
__device__ __forceinline__ float obs_loglik(const float* xs, const float* ys,
                                            const float* ms, int n,
                                            const float (&b)[P]) {
  float ll = 0.0f;
  for (int i = 0; i < n; ++i) {
    float eta = 0.0f;
#pragma unroll
    for (int k = 0; k < P; ++k) eta = fmaf(xs[i * P + k], b[k], eta);
    ll += logit_ll(eta, ys[i], ms[i]);
  }
  return ll;
}

// One pass over a group's n observations, staged in shared memory as
// xs (n, P) row-major, ys (n), ms (n). Accumulates the loglik, the P
// gradient sums and, when HESS, the T packed -Hessian sums in registers.
template <int P, bool HESS>
__device__ __forceinline__ void obs_pass(const float* xs, const float* ys,
                                         const float* ms, int n,
                                         const float (&b)[P], float& ll,
                                         float (&g)[P],
                                         float (&h)[packed_dim(P)]) {
  ll = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) g[k] = 0.0f;
#pragma unroll
  for (int t = 0; t < packed_dim(P); ++t) h[t] = 0.0f;
  for (int i = 0; i < n; ++i) {
    float xi[P];
    float eta = 0.0f;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      xi[k] = xs[i * P + k];
      eta = fmaf(xi[k], b[k], eta);
    }
    float l, r, w;
    logit_terms(eta, ys[i], ms[i], l, r, w);
    ll += l;
#pragma unroll
    for (int k = 0; k < P; ++k) g[k] = fmaf(xi[k], r, g[k]);
    if (HESS) {
#pragma unroll
      for (int a = 0; a < P; ++a) {
#pragma unroll
        for (int c = 0; c <= a; ++c) {
          h[pidx(a, c)] = fmaf(xi[a] * xi[c], w, h[pidx(a, c)]);
        }
      }
    }
  }
}

// Stage group g's x (n*P), y and mask (n) in dynamic shared memory. Every
// thread of the block must call it (it ends in __syncthreads).
template <int P>
__device__ __forceinline__ void stage_group(const float* __restrict__ x,
                                            const float* __restrict__ y,
                                            const float* __restrict__ mask,
                                            int g, int n, float* xs,
                                            float* ys, float* ms) {
  const size_t xoff = (size_t)g * n * P;
  for (int i = threadIdx.x; i < n * P; i += blockDim.x) xs[i] = x[xoff + i];
  const size_t yoff = (size_t)g * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    ys[i] = y[yoff + i];
    ms[i] = mask[yoff + i];
  }
  __syncthreads();
}

}  // namespace nestmc
