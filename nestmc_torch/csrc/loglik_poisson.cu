// Masked Poisson-log obs passes of the nested Poisson subject block:
// loglik + gradient (logp_grad), loglik + gradient + packed -Hessian
// (logp_grad_hess) and the value-only loglik (loglik): the Poisson
// instantiations of loglik_kernels.cuh, one exp per observation
// (poisson_terms.cuh).
//
// Replaces nestmc/ops/pallas/loglik_poisson.py::poisson_loglik_padded_pallas,
// ::poisson_logp_grad_pallas and ::poisson_logp_grad_hess_pallas. The
// reference subtracts the per-subject constant const_s = sum_i m
// lgamma(y + 1) outside its kernel; here the kernel reads const_s (S,)
// and subtracts it from each cell's loglik, so the returned loglik is the
// full one, as the model's cache convention wants, with no extra (C, S)
// passes.
//
// Design: as loglik_logistic.cu: all three on the tile of cell_tile.cuh
// (32 consecutive subjects x 32 chains a block at config 3's shape).
//
// Bound on the H100 at config 3's shape (C=512, S=4000, n=10, P=3; 20.5 M
// obs-cells): the loglik reads beta (24.6 MB) and writes (C, S) (8.2 MB),
// about 10 us at 3.35 TB/s, against about 11 float32 operations an
// obs-cell (3.4 us at 67 TFLOP/s); logp_grad adds the (C, S, P) gradient
// (17 us of bytes) and logp_grad_hess the (C, S, 6) Hessian (32 us), so
// bytes bound all three. The design reads each operand once and writes
// each output once. Measured on an H100 80GB HBM3 at 700.00 W (PERF.md,
// PR 5): logp_grad 0.057-0.058 ms, logp_grad_hess 0.075 (0.163 and 0.405
// one thread a cell); the value-only loglik 0.045-0.046 (0.063, PR 7;
// kernel_ab).

#include "loglik_kernels.cuh"
#include "poisson_terms.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

// Value-only loglik (C, S) minus cst (S,). Returns the cudaError_t of the
// launch.
extern "C" int nestmc_pois_loglik(const float* x, const float* y,
                                  const float* mask, const float* cst,
                                  const float* beta, float* out_v, int C,
                                  int S, int n, void* stream) {
  using namespace nestmc;
  return (int)launch_loglik<Poisson, NESTMC_P>(
      x, y, mask, cst, beta, out_v, C, S, n,
      static_cast<cudaStream_t>(stream));
}

// out_h == nullptr selects logp_grad, otherwise logp_grad_hess. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int nestmc_pois_logp_grad(const float* x, const float* y,
                                     const float* mask, const float* cst,
                                     const float* beta, float* out_v,
                                     float* out_g, float* out_h, int C, int S,
                                     int n, void* stream) {
  using namespace nestmc;
  return (int)launch_logp_grad<Poisson, NESTMC_P>(
      x, y, mask, cst, beta, out_v, out_g, out_h, C, S, n,
      static_cast<cudaStream_t>(stream));
}
