// Masked Bernoulli-logit obs passes: loglik + gradient (logp_grad),
// loglik + gradient + packed -Hessian (logp_grad_hess) and the value-only
// loglik (loglik): the Logit instantiations of loglik_kernels.cuh.
//
// Replaces nestmc/ops/pallas/loglik_logistic.py::logistic_logp_grad_pallas,
// ::logistic_logp_grad_hess_pallas and ::logistic_loglik_padded_pallas.
//
// Design: one thread per (chain, group) cell; a block covers one group
// (blockIdx.x) across 128 chains (blockIdx.y tiles the chains). The group's
// x (n*P floats, 800 B at n=50, P=4), y and mask are staged once in shared
// memory and read by every thread as broadcasts. eta, the loglik, the P
// gradient sums and the T Hessian sums live in registers, so the (C, G, n)
// lattice never reaches device memory. Groups need no padding; the chain
// edge is masked.
//
// Bound on the H100: at the judged shape (C=1024, G=1000, n=50, P=4) a call
// reads beta (16.4 MB) and writes 20-61 MB, 11-23 us of HBM time at
// 3.35 TB/s, but evaluates 2 transcendentals, an IEEE division and P (+T)
// FMAs on each of 51.2 M obs-cells. Measured on an H100 80GB HBM3 at 700 W
// (PERF.md): 0.14-0.19 ms for logp_grad, 0.29-0.38 ms with the Hessian, so
// arithmetic, not memory, bounds it. The design keeps memory traffic at its
// minimum (every per-obs value stays in registers, each group's data is
// read once per block); cheaper arithmetic and vectorised or chains-minor
// loads of beta/g/h are later work.
//
// The value-only loglik reads beta and writes (C, G): at the RW preset's
// shape (C=64, G=100, n=50, P=4) 128 KB, far below a microsecond of HBM
// time, so launch latency bounds it there; at C=512, G=100,000, n=20, P=3
// it moves 820 MB (245 us at 3.35 TB/s) against 1.02 G obs-cells of one
// exp and one log1p each. Same layout as the other passes. Measured on an
// H100 80GB HBM3 at 700 W (PERF.md): 0.023-0.026 ms at the RW shape, 1.87
// ms at the larger one (7.3x its bound; logp_grad there 4.18 ms, 9.4x):
// at G=100,000 the uncoalesced per-cell loads and stores cost more than
// at the judged G=1000.

#include "logistic_terms.cuh"
#include "loglik_kernels.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

// Value-only loglik (C, G). Returns the cudaError_t of the launch.
extern "C" int nestmc_loglik(const float* x, const float* y,
                             const float* mask, const float* beta,
                             float* out_v, int C, int G, int n,
                             void* stream) {
  using namespace nestmc;
  return (int)launch_loglik<Logit, NESTMC_P>(
      x, y, mask, nullptr, beta, out_v, C, G, n,
      static_cast<cudaStream_t>(stream));
}

// out_h == nullptr selects logp_grad, otherwise logp_grad_hess. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int nestmc_logp_grad(const float* x, const float* y,
                                const float* mask, const float* beta,
                                float* out_v, float* out_g, float* out_h,
                                int C, int G, int n, void* stream) {
  using namespace nestmc;
  return (int)launch_logp_grad<Logit, NESTMC_P>(
      x, y, mask, nullptr, beta, out_v, out_g, out_h, C, G, n,
      static_cast<cudaStream_t>(stream));
}
