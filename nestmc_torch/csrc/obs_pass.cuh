// The obs pass every kernel makes over one unit's n observations, for a
// likelihood family given as a tag type (logistic_terms.cuh: Logit,
// poisson_terms.cuh: Poisson) with two device functions:
//   Fam::terms(eta, y, m, ll, resid, w)  masked loglik term, gradient weight
//                                        (y - mean) and Newton curvature w;
//   Fam::value(eta, y, m)                the masked loglik term alone.
// The unit's x (n, P) row-major, y and mask (n) are staged in shared memory
// (by cell_tile.cuh's stage_units in the tiled kernels, by stage_group in
// the one-thread-a-cell ones) and read by every thread of a warp as
// broadcasts; eta, the loglik, the P gradient sums and the T packed
// -Hessian sums stay in registers, so the (C, units, n) lattice never
// reaches device memory.
#pragma once

#include "smallchol.cuh"

namespace nestmc {

// Value-only pass (the RW-MH step and the value-only eval kernel).
template <class Fam, int P>
__device__ __forceinline__ float obs_loglik(const float* xs, const float* ys,
                                            const float* ms, int n,
                                            const float (&b)[P]) {
  float ll = 0.0f;
  for (int i = 0; i < n; ++i) {
    float eta = 0.0f;
#pragma unroll
    for (int k = 0; k < P; ++k) eta = fmaf(xs[i * P + k], b[k], eta);
    ll += Fam::value(eta, ys[i], ms[i]);
  }
  return ll;
}

// Loglik, the P gradient sums and, when HESS, the T packed -Hessian sums.
template <class Fam, int P, bool HESS>
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
    Fam::terms(eta, ys[i], ms[i], l, r, w);
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

// Stage unit g's x (n*P), y and mask (n) in dynamic shared memory. Every
// thread of the block must call it (it ends in __syncthreads). Only the
// kernels still one thread a cell, one unit a block use it: loglik_kernel
// (loglik_kernels.cuh) and rwmh_step_kernel (rwmh_kernel.cuh).
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

// The unit's Gaussian prior mean of coordinate k: per chain, mean (C, P),
// for the hierarchical logistic groups (beta_g ~ N(mu, tau^2)); per unit,
// mean (C, units, P), for the nested Poisson subjects (beta_s ~
// N(beta_g[group of s], tau_s^2)). Fam::kUnitMean picks the layout.
template <class Fam, int P>
__device__ __forceinline__ float prior_mean(const float* mean, int c,
                                            size_t cell, int k) {
  return Fam::kUnitMean ? mean[cell * P + k] : mean[c * P + k];
}

}  // namespace nestmc
