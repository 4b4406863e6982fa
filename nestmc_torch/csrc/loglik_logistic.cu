// Masked Bernoulli-logit obs passes: loglik + gradient (logp_grad),
// loglik + gradient + packed -Hessian (logp_grad_hess) and the value-only
// loglik (loglik): the Logit instantiations of loglik_kernels.cuh.
//
// Replaces nestmc/ops/pallas/loglik_logistic.py::logistic_logp_grad_pallas,
// ::logistic_logp_grad_hess_pallas and ::logistic_loglik_padded_pallas.
//
// Design: all three run the tile of cell_tile.cuh (loglik_kernels.cuh): a
// block stages 16-32 consecutive groups' x, y and mask (x: n*P floats a
// group, 240 B at n=20, P=3) in shared memory, a warp steps 32 chains
// through one group at a time with every per-obs value in registers, so the
// (C, G, n) lattice never reaches device memory, and the loglik, gradient
// and Hessian leave through row buffers in contiguous runs a chain row.
//
// Bound on the H100: at the mala-100k shape (C=512, G=100,000, n=20, P=3)
// logp_grad reads beta (614 MB) and writes the loglik and gradient (819
// MB): 0.43 ms at 3.35 TB/s; its float32 operation floor (exp and log1p
// one operation each) is 0.44 ms. Compiled, the obs pass is about 80
// instructions an obs-cell (an accurate expf and log1pf, an IEEE division,
// the eta and gradient FMAs): 2.4 ms of instruction issue for 1.02 G
// obs-cells at 1.98 GHz, which bounds it now that the traffic is coalesced.
// Measured on an H100 80GB HBM3 at 700.00 W (PERF.md, PR 5; python -m
// nestmc_torch.kernel_ab): logp_grad 2.70-2.82 ms (4.18-4.19 before, one
// thread a cell with the chain on the thread index), logp_grad_hess
// 3.52-3.53 (9.82-9.83); at the judged shape (C=1024, G=1000, n=50, P=4),
// where the one-unit kernel's operands sit in L2, logp_grad 0.150 ms
// against its 0.141, logp_grad_hess 0.205 against 0.292; bitwise the same
// outputs.
//
// The value-only loglik reads beta and writes (C, G): at the RW preset's
// shape (C=64, G=100, n=50, P=4) 0.2 MB, far below a microsecond of HBM
// time, so launch latency bounds it there; at C=512, G=100,000, n=20, P=3
// it moves 859 MB (0.26 ms at 3.35 TB/s) against 1.02 G obs-cells of one
// exp and one log1p each, about 52 SASS instructions an obs-cell: 1.6 ms
// of instruction issue, which bounds it. The tile reads two observations'
// x, y and mask as 8-byte pairs (obs_pass.cuh), which took the loop from
// 56 to 52.5 instructions an obs-cell (the one-thread-a-cell kernel's: 54),
// and runs 4-warp blocks, 12 an SM. Measured on an H100 80GB HBM3 at
// 700.00 W (PERF.md, PR 7; kernel_ab): 1.795-1.796 ms at the larger shape
// (1.857-1.859 one thread a cell); at the RW preset's shape 9.7 us of
// device time a sweep against 5.4 (prof): 26 blocks, two groups a warp.

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
