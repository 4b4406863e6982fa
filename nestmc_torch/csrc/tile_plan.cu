// The tile plan of the kernels (cell_tile.cuh) as the launchers compute it,
// so that nestmc_torch/ops/cuda/common.py::tile_plan can be held against it
// on the card.

#include "logistic_terms.cuh"
#include "loglik_kernels.cuh"
#include "mala_kernel.cuh"
#include "newton_kernel.cuh"
#include "poisson_terms.cuh"
#include "rwmh_kernel.cuh"
#include "segment_kernel.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

// kind: the index in common.py's TILE_KINDS (logp_grad, logp_grad_hess,
// mala, mala_noise, pois_mala, pois_mala_noise, newton, newton_noise,
// pois_newton, pois_newton_noise, seg, rwmh, rwmh_noise, pois_rwmh,
// pois_rwmh_noise, loglik; for seg, n stands for the observations a group
// of a chunk, which the launcher takes as kSegObs).
// Writes the units a tile (0: no tile fits) and returns the bytes of
// dynamic shared memory a block takes, or -1 for an unknown kind.
extern "C" int nestmc_tile_plan(int kind, int n, int* tg) {
  using namespace nestmc;
  constexpr int P = NESTMC_P;
  TilePlan t;
  switch (kind) {
    case 0: t = logp_grad_plan<P, false>(n); break;
    case 1: t = logp_grad_plan<P, true>(n); break;
    case 2: t = mala_plan<Logit, P, false>(n); break;
    case 3: t = mala_plan<Logit, P, true>(n); break;
    case 4: t = mala_plan<Poisson, P, false>(n); break;
    case 5: t = mala_plan<Poisson, P, true>(n); break;
    case 6: t = newton_plan<Logit, P, false>(n); break;
    case 7: t = newton_plan<Logit, P, true>(n); break;
    case 8: t = newton_plan<Poisson, P, false>(n); break;
    case 9: t = newton_plan<Poisson, P, true>(n); break;
    case 10: t = seg_plan<P>(n); break;
    case 11: t = rwmh_plan<Logit, P, false>(n); break;
    case 12: t = rwmh_plan<Logit, P, true>(n); break;
    case 13: t = rwmh_plan<Poisson, P, false>(n); break;
    case 14: t = rwmh_plan<Poisson, P, true>(n); break;
    case 15: t = loglik_plan<P>(n); break;
    default: return -1;
  }
  *tg = t.tg;
  return t.smem;
}
