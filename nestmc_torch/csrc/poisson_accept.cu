// The fused RW-MH, MALA and Newton-MH updates of the nested Poisson GLMM's
// subject block beta_s: the Poisson instantiations of rwmh_kernel.cuh,
// mala_kernel.cuh and newton_kernel.cuh (no R-hat fold).
//
// Replaces nestmc/ops/pallas/poisson_accept.py::fused_rwmh_poisson_step,
// ::fused_mala_poisson_step and ::fused_newton_poisson_step (kernels
// _make_rwmh_kernel, _make_mala_kernel, _make_newton_kernel). They differ
// from the logistic steps in three places only:
//   1. the per-observation terms: one exp gives ll, resid and w
//      (poisson_terms.cuh);
//   2. the prior mean is per unit: bg_s = beta_g[subject_group] (C, S, P),
//      read at the cell's own offset instead of the per-chain mu (C, P);
//   3. the per-subject constant const_s (S,) is subtracted from the obs
//      pass's loglik in the kernel, so the carried cache includes it as the
//      reference's convention does (the reference shifts the cache by
//      +-const_s in two (C, S) passes around its kernel instead).
// Noise from csrc/philox.cuh, or, for the parity checks, given
// (eps, log u) operands, which the reference takes too.
//
// Layout and launch: all three on the tile of cell_tile.cuh (up to 32
// consecutive subjects x 32 chains a block, the subjects' x (n*P floats,
// 120 B at n=10, P=3), y and mask and the cells' operands and per-unit
// prior mean staged in contiguous runs a chain row, the packed P x P
// Cholesky of the Newton step in registers, smallchol.cuh).
//
// Bound on the H100 at config 3's shape (C=512, S=4000, n=10, P=3: 2.05 M
// cells, 20.5 M obs-cells), Philox noise: the RW step reads beta and bg_s
// (24.6 MB each), the carried loglik and log_scale (8.2 MB each) and writes
// beta, loglik and alpha: 107 MB, 32 us at 3.35 TB/s; MALA adds the gradient
// read and written (156 MB, 47 us); Newton adds the packed Hessian (refresh
// read and written, 255 MB, 76 us; frozen read only, 206 MB, 61 us). The obs
// pass is one exp and about 4P + 8 more float32 operations an obs-cell, and
// the Cholesky algebra a few hundred a cell, under 15 us at 67 TFLOP/s, so
// bytes set the floor of all three. The design reads every operand once and
// writes every output once; with the traffic coalesced, the compiled
// instruction stream is what the tiled steps take (a Newton cell's algebra is
// about 950 SASS instructions, PERF.md). Measured on an H100 80GB HBM3 at
// 700.00 W with Philox noise (PERF.md; python -m nestmc_torch.kernel_ab, the
// one-thread-a-cell kernel each replaced in brackets): the RW step
// 0.1006-0.1008 ms (0.258-0.261; PR 7); the MALA step 0.122 ms (0.387); the
// Newton step refresh 0.179-0.180 ms (0.694-0.698), frozen 0.149-0.150
// (0.444).

#include "mala_kernel.cuh"
#include "newton_kernel.cuh"
#include "poisson_terms.cuh"
#include "rwmh_kernel.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

// eps != null takes external noise (eps, logu) instead of Philox(k0, k1).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int nestmc_pois_rwmh_step(
    const float* x, const float* y, const float* mask, const float* cst,
    const float* beta, const float* lik, const float* ls, const float* bgs,
    const float* lt, const float* eps, const float* logu, float* out_beta,
    float* out_lik, float* out_alpha, int C, int S, int n, unsigned int k0,
    unsigned int k1, void* stream) {
  using namespace nestmc;
  RwArgs a{x,   y,    mask,     cst,     beta,      lik, ls, bgs, lt,
           eps, logu, out_beta, out_lik, out_alpha, C,   S,  n,   k0,
           k1};
  return (int)launch_rwmh<Poisson, NESTMC_P>(
      a, static_cast<cudaStream_t>(stream));
}

extern "C" int nestmc_pois_mala_step(
    const float* x, const float* y, const float* mask, const float* cst,
    const float* beta, const float* v, const float* g, const float* ls,
    const float* bgs, const float* lt, const float* eps, const float* logu,
    float* out_beta, float* out_v, float* out_g, float* out_alpha, int C,
    int S, int n, unsigned int k0, unsigned int k1, void* stream) {
  using namespace nestmc;
  constexpr int P = NESTMC_P;
  MalaArgs a{x,        y,          mask,       cst,     beta,
             v,        g,          ls,         bgs,     lt,
             eps,      logu,       nullptr,    nullptr, out_beta,
             out_v,    out_g,      out_alpha,  nullptr, nullptr,
             {1.0f, 1.0f}, {0.0f, 0.0f}, C,    S,       n,
             k0,       k1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(eps != nullptr ? launch_mala<Poisson, P, false, true>(a, s)
                              : launch_mala<Poisson, P, false, false>(a, s));
}

// frozen: no Hessian in the obs pass and out_h unused.
extern "C" int nestmc_pois_newton_step(
    const float* x, const float* y, const float* mask, const float* cst,
    const float* beta, const float* v, const float* g, const float* h,
    const float* ls, const float* bgs, const float* lt, const float* eps,
    const float* logu, float* out_beta, float* out_v, float* out_g,
    float* out_h, float* out_alpha, int C, int S, int n, unsigned int k0,
    unsigned int k1, int frozen, void* stream) {
  using namespace nestmc;
  constexpr int P = NESTMC_P;
  NewtonArgs a{x,        y,        mask,         cst,          beta,
               v,        g,        h,            ls,           bgs,
               lt,       eps,      logu,         nullptr,      nullptr,
               out_beta, out_v,    out_g,        out_h,        out_alpha,
               nullptr,  nullptr,  {1.0f, 1.0f}, {0.0f, 0.0f}, C,
               S,        n,        k0,           k1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(frozen ? launch_newton<Poisson, P, true, false>(a, s)
                      : launch_newton<Poisson, P, false, false>(a, s));
}
