// One random-walk MH update of every (chain, group) block of the
// hierarchical logistic model.
//
// Replaces nestmc/ops/pallas/mh_accept.py::fused_rwmh_logistic_step
// (kernel _make_fused_kernel); the noise comes from csrc/philox.cuh, or,
// unlike the TPU kernel, from given (eps, log u) operands, so the kernel is
// checked cell by cell against its plain version.
//
// Per cell, in registers: the proposal beta + e^log_scale eps; one
// value-only obs pass at the proposal (csrc/logistic_terms.cuh); log alpha
// = loglik' - carried loglik + the Gaussian group prior's quadratic delta
// (the log tau terms cancel); accept (log u < log alpha; NaN rejects) and
// the selects of beta and the carried loglik.
//
// Layout and launch: as loglik_logistic.cu, one thread per cell, one group
// per block, 128 chains per block, the group's data in shared memory.
//
// Bound on the H100: a call reads beta (C G P floats), the carried loglik
// and log_scale (C G each) and writes beta, loglik and alpha. At the RW
// preset's shape (C=64, G=100, n=50, P=4) that is 260 KB, well under a
// microsecond of HBM time, so launch latency bounds it there; at C=512,
// G=100,000, n=20, P=3 it moves 2.46 GB (0.73 ms at 3.35 TB/s) against
// 1.02 G obs-cells of one exp and one log1p each. Measured on an H100
// 80GB HBM3 at 700 W (PERF.md), with external noise: 0.044 ms at the RW
// preset's shape; 6.75 ms at the larger one, 7.8x its bound and 3.6x the
// value-only loglik there, because the per-cell (C, G, ...) loads are
// uncoalesced (the chain is on the thread index). Coalesced loads are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "logistic_terms.cuh"
#include "philox.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

namespace nestmc {

constexpr int kRwThreads = 128;

struct RwArgs {
  const float* x;      // (G, n, P)
  const float* y;      // (G, n)
  const float* mask;   // (G, n)
  const float* beta;   // (C, G, P)
  const float* lik;    // (C, G) carried loglik
  const float* ls;     // (C, G) log proposal scale
  const float* mu;     // (C, P)
  const float* lt;     // (C, P) log tau
  const float* eps;    // (C, G, P) external noise, or null
  const float* logu;   // (C, G) external noise, or null
  float* out_beta;
  float* out_lik;
  float* out_alpha;
  int C, G, n;
  uint32_t k0, k1;     // Philox key
};

template <int P, bool EXT>
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
    const float mu = a.mu[c * P + k];
    const float itau2 = expf(-2.0f * a.lt[c * P + k]);
    const float dp = prop[k] - mu;
    const float db = beta[k] - mu;
    quad += -0.5f * (dp * dp - db * db) * itau2;
  }
  const float llp = obs_loglik<P>(xs, ys, ms, a.n, prop);
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

template <bool EXT>
cudaError_t launch_rwmh(const RwArgs& a, cudaStream_t s) {
  constexpr int P = NESTMC_P;
  const dim3 grid(a.G, (a.C + kRwThreads - 1) / kRwThreads);
  const size_t smem = sizeof(float) * (size_t)a.n * (P + 2);
  rwmh_step_kernel<P, EXT><<<grid, kRwThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace nestmc

// eps != null takes external noise (eps, logu) instead of Philox(k0, k1).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int nestmc_rwmh_step(const float* x, const float* y,
                                const float* mask, const float* beta,
                                const float* lik, const float* ls,
                                const float* mu, const float* lt,
                                const float* eps, const float* logu,
                                float* out_beta, float* out_lik,
                                float* out_alpha, int C, int G, int n,
                                unsigned int k0, unsigned int k1,
                                void* stream) {
  using namespace nestmc;
  RwArgs a{x,    y,        mask,    beta,      lik, ls, mu, lt, eps,
           logu, out_beta, out_lik, out_alpha, C,   G,  n,  k0, k1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(eps != nullptr ? launch_rwmh<true>(a, s)
                              : launch_rwmh<false>(a, s));
}
