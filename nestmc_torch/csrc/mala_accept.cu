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
// Layout and launch: the tile of cell_tile.cuh (mala_kernel.cuh): 32
// consecutive groups x 32 consecutive chains a block at mala-100k's shape,
// every (C, G, ...) operand read and written in contiguous runs of a chain
// row through shared memory, a warp on 32 chains of one group, the fold's
// chains-minor accumulators read and written coalesced from device memory.
//
// Bound on the H100: at the mala-100k shape (C=512, G=100,000, n=20, P=3)
// with the main path's Philox noise a call reads beta and g (614 MB each)
// and v and log_scale (205 MB each) and writes beta, g, v and alpha: 3.3 GB,
// 0.98 ms at 3.35 TB/s; the obs pass evaluates 1.02 G obs-cells of an exp,
// a log1p, an IEEE division and about 4P FMAs, which the float32 bound
// counts as 2P + 17 operations each. Compiled (sm_90a, 64 registers), the
// obs pass is about 80 instructions an obs-cell and the per-cell algebra
// and Philox about 600 a cell: 3.5 ms of instruction issue at 1.98 GHz, so
// with the traffic coalesced the instruction stream, not memory, bounds it.
// Measured on an H100 80GB HBM3 at 700.00 W (PERF.md, PR 5; python -m
// nestmc_torch.kernel_ab): 4.22-4.23 ms with Philox noise (9.28 ms before,
// one thread a cell with the chain on the thread index), 4.77 ms with
// external noise, 6.69 ms with the fold; bitwise the outputs of the
// one-unit kernel.

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
