// The eval kernels of one likelihood family (obs_pass.cuh): loglik +
// gradient (+ packed -Hessian) and the value-only loglik, for every
// (chain, unit) cell. loglik_logistic.cu launches them for Logit,
// loglik_poisson.cu for Poisson.
//
// One thread per cell; a block covers one unit (blockIdx.x) across 128
// chains (blockIdx.y tiles the chains). The unit's data are staged once in
// shared memory. Units need no padding; the chain edge is masked. With
// Fam::kConst the per-unit constant cst[g] is subtracted from the loglik.
#pragma once

#include <cuda_runtime.h>

#include "obs_pass.cuh"

namespace nestmc {

constexpr int kThreads = 128;

template <class Fam, int P, bool HESS>
__global__ void __launch_bounds__(kThreads)
    logp_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ mask,
                     const float* __restrict__ cst,
                     const float* __restrict__ beta, float* __restrict__ out_v,
                     float* __restrict__ out_g, float* __restrict__ out_h,
                     int C, int G, int n) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + n * P;
  float* ms = ys + n;
  const int g = blockIdx.x;
  stage_group<P>(x, y, mask, g, n, xs, ys, ms);
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t cell = (size_t)c * G + g;

  float b[P];
#pragma unroll
  for (int k = 0; k < P; ++k) b[k] = beta[cell * P + k];
  float ll, gs[P], hs[packed_dim(P)];
  obs_pass<Fam, P, HESS>(xs, ys, ms, n, b, ll, gs, hs);
  if (Fam::kConst) ll -= cst[g];
  out_v[cell] = ll;
#pragma unroll
  for (int k = 0; k < P; ++k) out_g[cell * P + k] = gs[k];
  if (HESS) {
#pragma unroll
    for (int t = 0; t < packed_dim(P); ++t)
      out_h[cell * packed_dim(P) + t] = hs[t];
  }
}

template <class Fam, int P>
__global__ void __launch_bounds__(kThreads)
    loglik_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ mask,
                  const float* __restrict__ cst,
                  const float* __restrict__ beta, float* __restrict__ out_v,
                  int C, int G, int n) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + n * P;
  float* ms = ys + n;
  const int g = blockIdx.x;
  stage_group<P>(x, y, mask, g, n, xs, ys, ms);
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t cell = (size_t)c * G + g;
  float b[P];
#pragma unroll
  for (int k = 0; k < P; ++k) b[k] = beta[cell * P + k];
  float ll = obs_loglik<Fam, P>(xs, ys, ms, n, b);
  if (Fam::kConst) ll -= cst[g];
  out_v[cell] = ll;
}

template <class Fam, int P>
cudaError_t launch_loglik(const float* x, const float* y, const float* mask,
                          const float* cst, const float* beta, float* out_v,
                          int C, int G, int n, cudaStream_t s) {
  const dim3 grid(G, (C + kThreads - 1) / kThreads);
  const size_t smem = sizeof(float) * (size_t)n * (P + 2);
  loglik_kernel<Fam, P><<<grid, kThreads, smem, s>>>(x, y, mask, cst, beta,
                                                     out_v, C, G, n);
  return cudaGetLastError();
}

// out_h == nullptr selects logp_grad, otherwise logp_grad_hess.
template <class Fam, int P>
cudaError_t launch_logp_grad(const float* x, const float* y,
                             const float* mask, const float* cst,
                             const float* beta, float* out_v, float* out_g,
                             float* out_h, int C, int G, int n,
                             cudaStream_t s) {
  const dim3 grid(G, (C + kThreads - 1) / kThreads);
  const size_t smem = sizeof(float) * (size_t)n * (P + 2);
  if (out_h == nullptr) {
    logp_grad_kernel<Fam, P, false><<<grid, kThreads, smem, s>>>(
        x, y, mask, cst, beta, out_v, out_g, out_h, C, G, n);
  } else {
    logp_grad_kernel<Fam, P, true><<<grid, kThreads, smem, s>>>(
        x, y, mask, cst, beta, out_v, out_g, out_h, C, G, n);
  }
  return cudaGetLastError();
}

}  // namespace nestmc
