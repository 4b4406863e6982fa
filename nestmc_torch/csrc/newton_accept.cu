// One Newton-MH update of every (chain, group) block of the hierarchical
// logistic model, with the optional streaming split-R-hat Welford fold:
// the Logit instantiations of newton_kernel.cuh; and the statistics probe
// of the in-kernel Philox generator.
//
// Replaces nestmc/ops/pallas/newton_accept.py::fused_newton_logistic_step
// (kernel _make_fused_newton_kernel) and, inside it, the core-PRNG helpers
// of nestmc/ops/pallas/mh_accept.py (here csrc/philox.cuh).
//
// Per cell, in registers: the carried (v, g, h) plus the group prior
// N(mu, diag tau^2); the packed Cholesky factor, the Newton mean and the
// Laplace proposal; one obs pass at the proposal (csrc/logistic_terms.cuh)
// with the Hessian unless frozen; the reverse mean, the asymmetric
// correction and, unless frozen, the log-determinant ratio; accept and
// select. The fold (optional) folds the input beta into the (2, G, P, C)
// Welford accumulators.
//
// Layout and launch: the (unit x chain) tile of cell_tile.cuh
// (newton_kernel.cuh): 16 consecutive groups x 32 consecutive chains a
// block at the judged shape and at ragged-10k's widest size bucket, every
// (C, G, ...) operand (beta, g, the packed h, v, log_scale; eps and log u
// with external noise) read and written in contiguous runs of a chain row
// through shared memory, a warp on 32 chains of one group; the fold's
// chains-minor accumulators are read and written coalesced from device
// memory, a cell's 4P loads issued before any of its stores.
//
// Bound on the H100: at the judged shape a sampling (frozen + fold) call moves
// about 276 MB (beta, g and their outputs 4 x 16.4 MB, h 41 MB, the fold
// accumulators 131 MB read and written, v, log_scale and alpha), 0.082 ms at
// 3.35 TB/s, and a warmup (refresh) call 186 MB, 0.055 ms. Compiled (sm_90a,
// __launch_bounds__ 3 blocks of 256 threads an SM: at most 80 registers), a
// cell's algebra outside the obs pass (two packed Cholesky factors, three
// triangular solves with IEEE divisions, Philox and Box-Muller) is about 950
// SASS instructions and the obs pass about 82 an observation (kernel_ab
// --sass), so with the traffic coalesced the instruction stream at 24 warps an
// SM bounds it, not memory. Measured on an NVIDIA H100 80GB HBM3 at 700.00 W
// with Philox noise (PERF.md; python -m nestmc_torch.kernel_ab, the
// one-thread-a-cell kernel it replaced in brackets): judged refresh
// 0.303-0.304 ms (0.450-0.452), frozen + fold 0.256-0.257 (0.317-0.320); the
// widest ragged-10k bucket refresh 0.998-1.002 (1.759-1.761), frozen
// 0.822-0.825 (1.109-1.113); bitwise the outputs of the kernel it replaced.

#include "logistic_terms.cuh"
#include "newton_kernel.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

namespace nestmc {

__global__ void philox_probe_kernel(float* normal, float* uniform, int count,
                                    uint32_t k0, uint32_t k1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float u[3];
  philox_uniforms<3>(k0, k1, (uint32_t)i, u);
  normal[i] = box_muller(u[0], u[1]);
  uniform[i] = u[2];
}

}  // namespace nestmc

// frozen: no Hessian in the obs pass and out_h unused; fmean != null turns
// on the fold, whose (2, 2) scalars fsc [[cnt_0, act_0], [cnt_1, act_1]]
// the kernel reads from the device; eps != null takes external noise (eps,
// logu) instead of Philox noise keyed by the two words at key (device
// memory, so a captured launch reads each replay's key). Returns the
// cudaError_t of the launch (0 = success).
// c0, g0, G_total: the first chain and unit this launch holds in the
// unsharded launch and that launch's unit count (0, 0, G unsharded), so
// the Philox counters are the unsharded run's. They come last: a build
// of an earlier tree, which has no such arguments, ignores them.
extern "C" int nestmc_newton_step(
    const float* x, const float* y, const float* mask, const float* beta,
    const float* v, const float* g, const float* h, const float* ls,
    const float* mu, const float* lt, const float* eps, const float* logu,
    const float* fmean, const float* fm2, float* out_beta, float* out_v,
    float* out_g, float* out_h, float* out_alpha, float* out_fmean,
    float* out_fm2, const float* fsc, int C, int G, int n,
    const unsigned int* key, int frozen, void* stream, int c0, int g0,
    int G_total) {
  using namespace nestmc;
  constexpr int P = NESTMC_P;
  NewtonArgs a{x,        y,         mask,    nullptr, beta,     v,
               g,        h,         ls,      mu,      lt,       eps,
               logu,     fmean,     fm2,     out_beta, out_v,   out_g,
               out_h,    out_alpha, out_fmean, out_fm2, fsc,    C,
               G,        n,         key};
  a.cell_c0 = c0;
  a.cell_g0 = g0;
  a.cell_G = G_total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fold = fmean != nullptr;
  cudaError_t err;
  if (frozen) {
    err = fold ? launch_newton<Logit, P, true, true>(a, s)
               : launch_newton<Logit, P, true, false>(a, s);
  } else {
    err = fold ? launch_newton<Logit, P, false, true>(a, s)
               : launch_newton<Logit, P, false, false>(a, s);
  }
  return (int)err;
}

// Fills normal[i] (Box-Muller) and uniform[i] from cell i's Philox stream:
// the statistics probe of the in-kernel generator.
extern "C" int nestmc_philox_probe(float* normal, float* uniform, int count,
                                   unsigned int k0, unsigned int k1,
                                   void* stream) {
  const int threads = 256;
  nestmc::philox_probe_kernel<<<(count + threads - 1) / threads, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      normal, uniform, count, k0, k1);
  return (int)cudaGetLastError();
}
