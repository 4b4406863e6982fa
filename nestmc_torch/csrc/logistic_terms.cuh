// Per-observation Bernoulli-logit terms: the Logit family of obs_pass.cuh,
// shared by the hierarchical logistic kernels (loglik_logistic.cu,
// newton_accept.cu, mala_accept.cu, mh_accept.cu), so the eval kernels and
// the fused steps compute the same numbers.
//
// Port of nestmc/ops/pallas/loglik_logistic.py::_lik_terms_w: one exp and
// one log1p per observation. With e = exp(-|eta|):
//   softplus(eta) = max(eta, 0) + log1p(e)
//   sigmoid(eta)  = 1/(1+e) for eta >= 0, e/(1+e) otherwise
//   w = sigmoid (1 - sigmoid) = e/(1+e)^2
// Built without --use_fast_math: expf/log1pf keep full accuracy and a NaN
// eta stays NaN, so a NaN proposal is rejected by the accept rule.
#pragma once

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

// Hierarchical logistic groups: per-chain prior mean mu (C, P), no
// parameter-free loglik constant.
struct Logit {
  static constexpr bool kUnitMean = false;
  static constexpr bool kConst = false;
  static __device__ __forceinline__ void terms(float eta, float y, float m,
                                               float& ll, float& resid,
                                               float& w) {
    logit_terms(eta, y, m, ll, resid, w);
  }
  static __device__ __forceinline__ float value(float eta, float y, float m) {
    return logit_ll(eta, y, m);
  }
};

}  // namespace nestmc
