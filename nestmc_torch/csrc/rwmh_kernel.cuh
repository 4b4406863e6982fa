// The fused random-walk MH step of one likelihood family (obs_pass.cuh):
// mh_accept.cu launches it for the hierarchical logistic groups (Logit),
// poisson_accept.cu for the nested Poisson subjects (Poisson).
//
// Per (chain, unit) cell, in registers: the proposal beta + e^log_scale
// eps (eps from csrc/philox.cuh or given); one value-only obs pass at the
// proposal, minus the unit's constant when Fam::kConst; log alpha =
// loglik' - carried loglik + the Gaussian prior's quadratic delta around
// the prior mean (per chain or per unit: Fam::kUnitMean; the log tau terms
// cancel); accept (log u < log alpha; NaN rejects) and the selects of beta
// and the carried loglik.
//
// Layout and launch: the (unit x chain) tile of cell_tile.cuh, as
// mala_kernel.cuh. A block stages tg units' data and, one contiguous run a
// chain row, the tile's beta, carried loglik and log_scale (eps and log u
// with external noise; the per-unit prior mean for Fam::kUnitMean) in
// shared memory; a warp steps 32 chains through one unit at a time; beta,
// the loglik and alpha go back through the same row buffers and are stored
// one run a chain row. The per-chain mu and log tau (C, P) are read once a
// thread. Each cell's arithmetic, and its Philox counter (c*G + g, block),
// are those of the one-thread-a-cell kernel it replaced, so the outputs are
// bitwise the same.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_tile.cuh"
#include "obs_pass.cuh"
#include "philox.cuh"

namespace nestmc {

struct RwArgs {
  const float* x;      // (G, n, P)
  const float* y;      // (G, n)
  const float* mask;   // (G, n)
  const float* cst;    // (G,) loglik constant (Fam::kConst), or null
  const float* beta;   // (C, G, P)
  const float* lik;    // (C, G) carried loglik
  const float* ls;     // (C, G) log proposal scale
  const float* mean;   // prior mean: (C, P), or (C, G, P) when kUnitMean
  const float* lt;     // (C, P) log tau
  const float* eps;    // (C, G, P) external noise, or null
  const float* logu;   // (C, G) external noise, or null
  float* out_beta;
  float* out_lik;
  float* out_alpha;
  int C, G, n;
  uint32_t k0, k1;     // Philox key
};

// Staged operand widths, in carve order: beta (P), the carried loglik and
// log_scale (1), then eps (P) and log u (1) when EXT, then the per-unit
// prior mean (P) when Fam::kUnitMean. Returns the count.
template <class Fam, int P, bool EXT>
inline int rwmh_widths(int (&w)[6]) {
  int k = 0;
  w[k++] = P;
  w[k++] = 1;
  w[k++] = 1;
  if (EXT) {
    w[k++] = P;
    w[k++] = 1;
  }
  if (Fam::kUnitMean) w[k++] = P;
  return k;
}

template <class Fam, int P, bool EXT>
inline TilePlan rwmh_plan(int n) {
  int w[6];
  const int nw = rwmh_widths<Fam, P, EXT>(w);
  return plan_tile(n, P, w, nw, kRwBlocks);
}

template <class Fam, int P, bool EXT>
__global__ void __launch_bounds__(kTileWarps * 32, kRwBlocks)
    rwmh_step_kernel(const RwArgs a, int tg) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = tile_of(tg, a.C, a.G);
  TileSmem sm(smem, tg, a.n, P);
  float* bb = sm.rows(P);   // beta in, new beta out
  float* vb = sm.rows(1);   // carried loglik in, new loglik out
  float* lb = sm.rows(1);   // log_scale in, alpha out
  float* eb = EXT ? sm.rows(P) : nullptr;
  float* ub = EXT ? sm.rows(1) : nullptr;
  float* mb = Fam::kUnitMean ? sm.rows(P) : nullptr;
  stage_units(a.x, a.y, a.mask, t, a.n, P, sm.xs, sm.ys, sm.ms);
  stage_rows(a.beta, bb, t, P, a.G);
  stage_rows(a.lik, vb, t, 1, a.G);
  stage_rows(a.ls, lb, t, 1, a.G);
  if (EXT) {
    stage_rows(a.eps, eb, t, P, a.G);
    stage_rows(a.logu, ub, t, 1, a.G);
  }
  if (Fam::kUnitMean) stage_rows(a.mean, mb, t, P, a.G);
  stage_wait();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c = t.c0 + lane;
  const int sP = row_stride(tg, P), s1 = row_stride(tg, 1);
  if (lane < t.nc) {
    float itau2[P], mu_c[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      itau2[k] = expf(-2.0f * a.lt[c * P + k]);
      mu_c[k] = Fam::kUnitMean ? 0.0f : a.mean[c * P + k];
    }
    for (int u = warp; u < t.ng; u += nwarps) {
      const int gi = t.g0 + u;
      const size_t cell = (size_t)c * a.G + gi;
      const int oP = lane * sP + u * P, o1 = lane * s1 + u;

      float eps[P], logu;
      if (EXT) {
#pragma unroll
        for (int k = 0; k < P; ++k) eps[k] = eb[oP + k];
        logu = ub[o1];
      } else {
        float uni[2 * P + 1];
        philox_uniforms<2 * P + 1>(a.k0, a.k1, (uint32_t)cell, uni);
#pragma unroll
        for (int k = 0; k < P; ++k)
          eps[k] = box_muller(uni[2 * k], uni[2 * k + 1]);
        logu = logf(uni[2 * P]);
      }
      const float s = expf(lb[o1]);
      float beta[P], prop[P];
      float quad = 0.0f;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        beta[k] = bb[oP + k];
        prop[k] = beta[k] + s * eps[k];
        const float mu = Fam::kUnitMean ? mb[oP + k] : mu_c[k];
        const float dp = prop[k] - mu;
        const float db = beta[k] - mu;
        quad += -0.5f * (dp * dp - db * db) * itau2[k];
      }
      float llp = obs_loglik<Fam, P>(sm.xs + (size_t)u * a.n * P,
                                     sm.ys + (size_t)u * a.n,
                                     sm.ms + (size_t)u * a.n, a.n, prop);
      if (Fam::kConst) llp -= a.cst[gi];
      const float lold = vb[o1];
      const float log_alpha = llp - lold + quad;

      const bool accept = logu < log_alpha;  // NaN compares false: reject
      vb[o1] = accept ? llp : lold;
#pragma unroll
      for (int k = 0; k < P; ++k) bb[oP + k] = accept ? prop[k] : beta[k];
      lb[o1] = isnan(log_alpha) ? 0.0f : expf(fminf(log_alpha, 0.0f));
    }
  }
  __syncthreads();
  store_rows(bb, a.out_beta, t, P, a.G);
  store_rows(vb, a.out_lik, t, 1, a.G);
  store_rows(lb, a.out_alpha, t, 1, a.G);
}

template <class Fam, int P, bool EXT>
static cudaError_t launch_rwmh_tiled(const RwArgs& a, cudaStream_t s) {
  static SmemGrant grant;
  const TilePlan plan = rwmh_plan<Fam, P, EXT>(a.n);
  if (plan.tg == 0) return cudaErrorInvalidValue;
  auto kernel = rwmh_step_kernel<Fam, P, EXT>;
  const cudaError_t e = grant.allow(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.G + plan.tg - 1) / plan.tg, (a.C + kTileC - 1) / kTileC);
  kernel<<<grid, tile_threads(plan.tg), plan.smem, s>>>(a, plan.tg);
  return cudaGetLastError();
}

// eps != null takes external noise (eps, logu) instead of Philox(k0, k1).
template <class Fam, int P>
cudaError_t launch_rwmh(const RwArgs& a, cudaStream_t s) {
  return a.eps != nullptr ? launch_rwmh_tiled<Fam, P, true>(a, s)
                          : launch_rwmh_tiled<Fam, P, false>(a, s);
}

}  // namespace nestmc
