// One MALA update of every (chain, group) block of the hierarchical
// logistic model, with the optional streaming split-R-hat Welford fold:
// the Logit instantiations of mala_kernel.cuh.
//
// Replaces nestmc/ops/pallas/mala_accept.py::fused_mala_logistic_step
// (kernel _make_fused_mala_kernel); the noise comes from csrc/philox.cuh.
//
// Per cell, in registers: the full-conditional gradient from the carried
// likelihood gradient and the group prior N(mu, diag tau^2); the Langevin
// proposal; one obs pass at the proposal (csrc/logistic_terms.cuh); the
// conditional delta and the asymmetric-proposal correction; accept and
// select. The fold (optional) folds the input beta into the (2, G, P, C)
// Welford accumulators, as newton_accept.cu does.
//
// Layout and launch: as loglik_logistic.cu, one thread per cell, one group
// per block, 128 chains per block; the group's data sits in shared memory
// (400 B at n=20, P=3). The public (C, G, ...) layouts are read directly.
//
// Bound on the H100: at the mala-100k shape (C=512, G=100,000, n=20, P=3)
// a call reads beta and g (614 MB each) and v and log_scale (205 MB each)
// and writes beta, g (614 MB each), v and alpha (205 MB each): 3.3 GB,
// 0.98 ms at 3.35 TB/s; the obs pass adds 1.02 G obs-cells of 2
// transcendentals, a division and about 4P FMAs, so memory bounds it. The
// design reads and writes every operand exactly once and keeps the
// (C, G, n) lattice in registers; the fold adds 4 x 1.23 GB (accumulators
// read and written) to the same pass. Measured on an H100 80GB HBM3 at
// 700 W (PERF.md): 10.1 ms with external noise, 8.2x its 1.23 ms bound,
// 9 ms a sweep with Philox noise: with the chain on the thread index a
// warp's loads of the (C, G, ...) operands lie G*P floats apart, so they
// are uncoalesced. A warp over consecutive groups of one chain (several
// groups' data staged per block) is later work.

#include "logistic_terms.cuh"
#include "mala_kernel.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

// fmean != null turns on the fold; eps != null takes external noise
// (eps, logu) instead of Philox(k0, k1). Returns the cudaError_t of the
// launch (0 = success).
extern "C" int nestmc_mala_step(
    const float* x, const float* y, const float* mask, const float* beta,
    const float* v, const float* g, const float* ls, const float* mu,
    const float* lt, const float* eps, const float* logu, const float* fmean,
    const float* fm2, float* out_beta, float* out_v, float* out_g,
    float* out_alpha, float* out_fmean, float* out_fm2, float cnt0,
    float act0, float cnt1, float act1, int C, int G, int n, unsigned int k0,
    unsigned int k1, void* stream) {
  using namespace nestmc;
  constexpr int P = NESTMC_P;
  MalaArgs a{x,         y,         mask,      nullptr,      beta,
             v,         g,         ls,        mu,           lt,
             eps,       logu,      fmean,     fm2,          out_beta,
             out_v,     out_g,     out_alpha, out_fmean,    out_fm2,
             {cnt0, cnt1}, {act0, act1}, C,   G,            n,
             k0,        k1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fold = fmean != nullptr;
  const bool ext = eps != nullptr;
  cudaError_t err;
  if (fold) {
    err = ext ? launch_mala<Logit, P, true, true>(a, s)
              : launch_mala<Logit, P, true, false>(a, s);
  } else {
    err = ext ? launch_mala<Logit, P, false, true>(a, s)
              : launch_mala<Logit, P, false, false>(a, s);
  }
  return (int)err;
}
