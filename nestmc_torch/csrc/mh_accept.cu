// One random-walk MH update of every (chain, group) block of the
// hierarchical logistic model: the Logit instantiation of rwmh_kernel.cuh.
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

#include "logistic_terms.cuh"
#include "rwmh_kernel.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

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
  RwArgs a{x,   y,    mask,     nullptr, beta,    lik,       ls, mu, lt,
           eps, logu, out_beta, out_lik, out_alpha, C,       G,  n,  k0,
           k1};
  return (int)launch_rwmh<Logit, NESTMC_P>(a,
                                           static_cast<cudaStream_t>(stream));
}
