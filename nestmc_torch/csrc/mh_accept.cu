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
// Layout and launch: the (unit x chain) tile of cell_tile.cuh
// (rwmh_kernel.cuh): a block stages up to 32 consecutive groups' x, y and
// mask and, one contiguous run a chain row, beta, the carried loglik and
// log_scale (+ eps and log u with external noise) of 32 chains; a warp
// steps its 32 chains through one group at a time; beta, the loglik and
// alpha leave through the same row buffers.
//
// Bound on the H100: a call reads beta (C G P floats), the carried loglik
// and log_scale (C G each) and writes beta, loglik and alpha. At the RW
// preset's shape (C=64, G=100, n=50, P=4) that is 0.6 MB, well under a
// microsecond of HBM time, so launch latency bounds it there; at C=512,
// G=100,000, n=20, P=3 it moves 2.91 GB with external noise (0.87 ms at
// 3.35 TB/s) against 1.02 G obs-cells of one exp and one log1p each.
// Coalesced, the compiled value-only obs pass (about 52 SASS instructions
// an obs-cell, PERF.md) and, with Philox noise, a cell's ~350 instructions
// of Philox and Box-Muller are what bound it: 1.6 and 0.55 ms of
// instruction issue at 1.98 GHz. Measured on an H100 80GB HBM3 at 700.00 W
// (PERF.md, PR 7; python -m nestmc_torch.kernel_ab, the one-thread-a-cell
// kernel it replaced in brackets): at C=512, G=100,000 2.650-2.658 ms with
// external noise (6.734-6.735), 3.107-3.115 with Philox noise
// (5.813-5.814). At the RW preset's shape the tile has 14 blocks and a warp
// steps through two groups, so the kernel takes 14.4 us of device time a
// sweep against the one-unit kernel's 7.3 (python -m nestmc_torch.prof), a
// latency floor on a path whose sweep the host paces.

#include "logistic_terms.cuh"
#include "rwmh_kernel.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

// eps != null takes external noise (eps, logu) instead of Philox noise
// keyed by the two words at key (device memory). Returns the cudaError_t of the launch (0 = success).
// c0, g0, G_total: the first chain and unit this launch holds in the
// unsharded launch and that launch's unit count (0, 0, G unsharded), so
// the Philox counters are the unsharded run's. They come last: a build
// of an earlier tree, which has no such arguments, ignores them.
extern "C" int nestmc_rwmh_step(const float* x, const float* y,
                                const float* mask, const float* beta,
                                const float* lik, const float* ls,
                                const float* mu, const float* lt,
                                const float* eps, const float* logu,
                                float* out_beta, float* out_lik,
                                float* out_alpha, int C, int G, int n,
                                const unsigned int* key, void* stream,
    int c0, int g0, int G_total) {
  using namespace nestmc;
  RwArgs a{x,   y,    mask,     nullptr, beta,      lik, ls, mu, lt,
           eps, logu, out_beta, out_lik, out_alpha, C,   G,  n,  key};
  a.cell_c0 = c0;
  a.cell_g0 = g0;
  a.cell_G = G_total;
  return (int)launch_rwmh<Logit, NESTMC_P>(a,
                                           static_cast<cudaStream_t>(stream));
}
