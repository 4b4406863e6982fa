// Per-observation Poisson-log terms: the Poisson family of obs_pass.cuh,
// shared by the nested Poisson kernels (loglik_poisson.cu,
// poisson_accept.cu).
//
// Port of nestmc/ops/pallas/poisson_accept.py::_pois_terms: ONE exp per
// observation gives all three terms, rate = exp(eta):
//   ll = y eta - rate,  resid = y - rate,  w = rate (the Newton curvature).
// The parameter-free -lgamma(y + 1) part of the loglik is summed per
// subject once (const_s, (S,)) and subtracted from the returned loglik in
// the kernel. Built without --use_fast_math: expf keeps full accuracy
// (y eta - e^eta is a difference of large terms at large |eta|), a NaN eta
// stays NaN and an overflowing rate gives ll = -inf, so either proposal is
// rejected by the accept rule.
#pragma once

namespace nestmc {

// Nested Poisson subjects: per-unit prior mean bg_s (C, S, P) and the
// per-subject constant const_s.
struct Poisson {
  static constexpr bool kUnitMean = true;
  static constexpr bool kConst = true;
  static __device__ __forceinline__ void terms(float eta, float y, float m,
                                               float& ll, float& resid,
                                               float& w) {
    const float rate = expf(eta);
    ll = (y * eta - rate) * m;
    resid = (y - rate) * m;
    w = rate * m;
  }
  static __device__ __forceinline__ float value(float eta, float y, float m) {
    return (y * eta - expf(eta)) * m;
  }
};

}  // namespace nestmc
