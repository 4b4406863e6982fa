// The fused MALA step of one likelihood family (obs_pass.cuh), with the
// optional streaming split-R-hat Welford fold: mala_accept.cu launches it
// for the hierarchical logistic groups (Logit, with or without the fold),
// poisson_accept.cu for the nested Poisson subjects (Poisson, no fold).
//
// Per (chain, unit) cell, in registers:
//   1. the full-conditional gradient at beta: the carried likelihood
//      gradient g plus the Gaussian prior's, g - (beta - mean)/tau^2, the
//      mean per chain or per unit (Fam::kUnitMean);
//   2. the Langevin proposal beta + (s^2/2) g + s eps, s = e^log_scale (eps
//      from Philox or given);
//   3. one obs pass at the proposal: loglik (minus the unit's constant when
//      Fam::kConst) and gradient;
//   4. the conditional delta (loglik delta plus the prior quadratics; the
//      log tau terms cancel) and the asymmetric-proposal correction
//      (|s eps|^2 - |beta - prop - (s^2/2) g'|^2) / (2 s^2);
//   5. accept (log u < log alpha; NaN rejects) and the selects.
// FOLD folds the INPUT beta (the previous retained draw) into the
// (2, G, P, C) Welford accumulators with the per-half (count, active)
// scalars of nestmc_torch.diagnostics.fold_rhat_scalars.
//
// Layout and launch: the (unit x chain) tile of cell_tile.cuh. A block
// stages tg units' data and, one contiguous run a chain row, the tile's
// beta, g, v, log_scale (eps and log u with external noise; the per-unit
// prior mean for Fam::kUnitMean) in shared memory; a warp steps 32 chains
// through one unit at a time; beta, g, v and alpha go back through the same
// row buffers and are stored one run a chain row. The per-chain mu and
// log tau (C, P) are read once a thread. Each cell's arithmetic, and its
// Philox counter (c*G + g, block), are those of the one-unit kernel it
// replaced, so the outputs are bitwise the same.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_tile.cuh"
#include "obs_pass.cuh"
#include "philox.cuh"

namespace nestmc {

struct MalaArgs {
  const float* x;      // (G, n, P)
  const float* y;      // (G, n)
  const float* mask;   // (G, n)
  const float* cst;    // (G,) loglik constant (Fam::kConst), or null
  const float* beta;   // (C, G, P)
  const float* v;      // (C, G) carried loglik
  const float* g;      // (C, G, P) carried loglik gradient
  const float* ls;     // (C, G) log proposal scale
  const float* mean;   // prior mean: (C, P), or (C, G, P) when kUnitMean
  const float* lt;     // (C, P) log tau
  const float* eps;    // (C, G, P) external noise, or null
  const float* logu;   // (C, G) external noise, or null
  const float* fmean;  // (2, G, P, C) or null
  const float* fm2;    // (2, G, P, C) or null
  float* out_beta;
  float* out_v;
  float* out_g;
  float* out_alpha;
  float* out_fmean;
  float* out_fm2;
  float cnt[2];        // fold: count after this draw (>= 1), per half
  float act[2];        // fold: 1 if the draw belongs to the half, else 0
  int C, G, n;
  uint32_t k0, k1;     // Philox key
};

// Staged operand widths, in carve order: beta, g (P), v, log_scale (1),
// then eps (P) and log u (1) when EXT, then the per-unit prior mean (P)
// when Fam::kUnitMean. Returns the count.
template <class Fam, int P, bool EXT>
inline int mala_widths(int (&w)[7]) {
  int k = 0;
  w[k++] = P;
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
inline TilePlan mala_plan(int n) {
  int w[7];
  const int nw = mala_widths<Fam, P, EXT>(w);
  return plan_tile(n, P, w, nw, kMalaBlocks);
}

template <class Fam, int P, bool FOLD, bool EXT>
__global__ void __launch_bounds__(kTileWarps * 32, kMalaBlocks)
    mala_step_kernel(const MalaArgs a, int tg) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = tile_of(tg, a.C, a.G);
  TileSmem sm(smem, tg, a.n, P);
  float* bb = sm.rows(P);   // beta in, new beta out
  float* gb = sm.rows(P);   // g in, new g out
  float* vb = sm.rows(1);   // v in, new v out
  float* lb = sm.rows(1);   // log_scale in, alpha out
  float* eb = EXT ? sm.rows(P) : nullptr;
  float* ub = EXT ? sm.rows(1) : nullptr;
  float* mb = Fam::kUnitMean ? sm.rows(P) : nullptr;
  stage_units(a.x, a.y, a.mask, t, a.n, P, sm.xs, sm.ys, sm.ms);
  stage_rows(a.beta, bb, t, P, a.G);
  stage_rows(a.g, gb, t, P, a.G);
  stage_rows(a.v, vb, t, 1, a.G);
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

      float beta[P], mu[P], gcar[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        beta[k] = bb[oP + k];
        gcar[k] = gb[oP + k];
        mu[k] = Fam::kUnitMean ? mb[oP + k] : mu_c[k];
      }

      if (FOLD) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int k = 0; k < P; ++k) {
            const size_t idx = (((size_t)hf * a.G + gi) * P + k) * a.C + c;
            const float m = a.fmean[idx];
            const float delta = beta[k] - m;
            const float nm = m + a.act[hf] * delta / a.cnt[hf];
            a.out_fmean[idx] = nm;
            a.out_fm2[idx] = a.fm2[idx] + a.act[hf] * delta * (beta[k] - nm);
          }
        }
      }

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
      const float lsv = lb[o1];
      const float s = expf(lsv);
      const float s2 = s * s;

      float db[P], prop[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        db[k] = beta[k] - mu[k];
        const float gold = gcar[k] - db[k] * itau2[k];
        prop[k] = beta[k] + 0.5f * s2 * gold + s * eps[k];
      }

      float llp, gll[P], unused[packed_dim(P)];
      obs_pass<Fam, P, false>(sm.xs + (size_t)u * a.n * P,
                              sm.ys + (size_t)u * a.n,
                              sm.ms + (size_t)u * a.n, a.n, prop, llp, gll,
                              unused);
      if (Fam::kConst) llp -= a.cst[gi];

      float quad = 0.0f, fwd_sq = 0.0f, rev_sq = 0.0f;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float dp = prop[k] - mu[k];
        quad += -0.5f * (dp * dp - db[k] * db[k]) * itau2[k];
        const float gnew = gll[k] - dp * itau2[k];
        const float rev = beta[k] - prop[k] - 0.5f * s2 * gnew;
        const float fwd = s * eps[k];
        fwd_sq += fwd * fwd;
        rev_sq += rev * rev;
      }
      const float vold = vb[o1];
      const float log_alpha =
          (llp - vold + quad) + (fwd_sq - rev_sq) / (2.0f * expf(2.0f * lsv));

      const bool accept = logu < log_alpha;  // NaN compares false: reject
      vb[o1] = accept ? llp : vold;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        bb[oP + k] = accept ? prop[k] : beta[k];
        gb[oP + k] = accept ? gll[k] : gcar[k];
      }
      lb[o1] = isnan(log_alpha) ? 0.0f : expf(fminf(log_alpha, 0.0f));
    }
  }
  __syncthreads();
  store_rows(bb, a.out_beta, t, P, a.G);
  store_rows(gb, a.out_g, t, P, a.G);
  store_rows(vb, a.out_v, t, 1, a.G);
  store_rows(lb, a.out_alpha, t, 1, a.G);
}

template <class Fam, int P, bool FOLD, bool EXT>
static cudaError_t launch_mala(const MalaArgs& a, cudaStream_t s) {
  static SmemGrant grant;
  const TilePlan plan = mala_plan<Fam, P, EXT>(a.n);
  if (plan.tg == 0) return cudaErrorInvalidValue;
  auto kernel = mala_step_kernel<Fam, P, FOLD, EXT>;
  const cudaError_t e = grant.allow(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.G + plan.tg - 1) / plan.tg, (a.C + kTileC - 1) / kTileC);
  kernel<<<grid, tile_threads(plan.tg), plan.smem, s>>>(a, plan.tg);
  return cudaGetLastError();
}

}  // namespace nestmc
