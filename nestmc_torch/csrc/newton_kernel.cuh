// The fused Newton-MH step of one likelihood family (obs_pass.cuh), with
// the optional streaming split-R-hat Welford fold: newton_accept.cu
// launches it for the hierarchical logistic groups (Logit), poisson_accept.cu
// for the nested Poisson subjects (Poisson, no fold).
//
// Per (chain, unit) cell, in registers:
//   1. the conditional's gradient and packed -Hessian at beta from the
//      carried likelihood cache (v, g, h) plus the Gaussian prior
//      N(mean, diag tau^2), the mean per chain or per unit
//      (Fam::kUnitMean);
//   2. the packed Cholesky factor, the Newton mean beta + H^-1 g and the
//      proposal mean + c^1/2 L^-T eps (eps from Philox or given);
//   3. one obs pass at the proposal: loglik (minus the unit's constant when
//      Fam::kConst), gradient and, unless FROZEN, the packed -Hessian;
//   4. the reverse mean, the asymmetric-proposal correction and, unless
//      FROZEN, the log-determinant ratio (one log of the ratio of the
//      diagonal products);
//   5. accept (log u < log alpha; NaN rejects) and the selects.
// FOLD folds the INPUT beta (the previous retained draw) into the
// (2, G, P, C) Welford accumulators with the per-half (count, active)
// scalars of nestmc_torch.diagnostics.fold_rhat_scalars.
//
// Layout and launch: the (unit x chain) tile of cell_tile.cuh. A block
// stages tg units' data and, one contiguous run a chain row, the tile's
// beta, g, packed h, v, log_scale (eps and log u with external noise; the
// per-unit prior mean for Fam::kUnitMean) in shared memory; a warp steps 32
// chains through one unit at a time; beta, g, v, alpha and, unless FROZEN,
// h go back through the same row buffers and are stored one run a chain
// row. The per-chain mu and log tau (C, P) are read once a thread; the
// chains-minor fold accumulators are read and written coalesced straight
// from device memory. Each cell's arithmetic, and its Philox counter
// (c*G + g, block), are those of the one-thread-a-cell kernel it replaced,
// so the outputs are bitwise the same.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_tile.cuh"
#include "obs_pass.cuh"
#include "philox.cuh"
#include "smallchol.cuh"

namespace nestmc {

struct NewtonArgs {
  const float* x;      // (G, n, P)
  const float* y;      // (G, n)
  const float* mask;   // (G, n)
  const float* cst;    // (G,) loglik constant (Fam::kConst), or null
  const float* beta;   // (C, G, P)
  const float* v;      // (C, G) carried loglik
  const float* g;      // (C, G, P) carried loglik gradient
  const float* h;      // (C, G, T) carried packed -Hessian of the loglik
  const float* ls;     // (C, G) log sqrt(c)
  const float* mean;   // prior mean: (C, P), or (C, G, P) when kUnitMean
  const float* lt;     // (C, P) log tau
  const float* eps;    // (C, G, P) external noise, or null
  const float* logu;   // (C, G) external noise, or null
  const float* fmean;  // (2, G, P, C) or null
  const float* fm2;    // (2, G, P, C) or null
  float* out_beta;
  float* out_v;
  float* out_g;
  float* out_h;        // null when FROZEN
  float* out_alpha;
  float* out_fmean;
  float* out_fm2;
  float cnt[2];        // fold: count after this draw (>= 1), per half
  float act[2];        // fold: 1 if the draw belongs to the half, else 0
  int C, G, n;
  uint32_t k0, k1;     // Philox key
};

// Staged operand widths, in carve order: beta, g (P), the packed h (T), v,
// log_scale (1), then eps (P) and log u (1) when EXT, then the per-unit
// prior mean (P) when Fam::kUnitMean. Returns the count. FROZEN and FOLD
// stage the same rows (a frozen step reads h and does not write it).
template <class Fam, int P, bool EXT>
inline int newton_widths(int (&w)[8]) {
  int k = 0;
  w[k++] = P;
  w[k++] = P;
  w[k++] = packed_dim(P);
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
inline TilePlan newton_plan(int n) {
  int w[8];
  const int nw = newton_widths<Fam, P, EXT>(w);
  return plan_tile(n, P, w, nw, kNewtonBlocks);
}

template <class Fam, int P, bool FROZEN, bool FOLD, bool EXT>
__global__ void __launch_bounds__(kTileWarps * 32, kNewtonBlocks)
    newton_step_kernel(const NewtonArgs a, int tg) {
  constexpr int T = packed_dim(P);
  extern __shared__ __align__(16) float smem[];
  const Tile t = tile_of(tg, a.C, a.G);
  TileSmem sm(smem, tg, a.n, P);
  float* bb = sm.rows(P);   // beta in, new beta out
  float* gb = sm.rows(P);   // g in, new g out
  float* hb = sm.rows(T);   // h in, new h out (unless FROZEN)
  float* vb = sm.rows(1);   // v in, new v out
  float* lb = sm.rows(1);   // log_scale in, alpha out
  float* eb = EXT ? sm.rows(P) : nullptr;
  float* ub = EXT ? sm.rows(1) : nullptr;
  float* mb = Fam::kUnitMean ? sm.rows(P) : nullptr;
  stage_units(a.x, a.y, a.mask, t, a.n, P, sm.xs, sm.ys, sm.ms);
  stage_rows(a.beta, bb, t, P, a.G);
  stage_rows(a.g, gb, t, P, a.G);
  stage_rows(a.h, hb, t, T, a.G);
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
  const int sT = row_stride(tg, T);
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
      const int oP = lane * sP + u * P, oT = lane * sT + u * T;
      const int o1 = lane * s1 + u;

      float beta[P], db[P], gold[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        beta[k] = bb[oP + k];
        db[k] = beta[k] - (Fam::kUnitMean ? mb[oP + k] : mu_c[k]);
        gold[k] = gb[oP + k] - db[k] * itau2[k];
      }

      if (FOLD) {
        // every load first, so that the 4P loads are in flight together
        // (a store to out_fmean may alias fmean as far as the compiler
        // knows, which would otherwise serialise them)
        float fm[2][P], f2[2][P];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int k = 0; k < P; ++k) {
            const size_t idx = (((size_t)hf * a.G + gi) * P + k) * a.C + c;
            fm[hf][k] = a.fmean[idx];
            f2[hf][k] = a.fm2[idx];
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int k = 0; k < P; ++k) {
            const size_t idx = (((size_t)hf * a.G + gi) * P + k) * a.C + c;
            const float m = fm[hf][k];
            const float delta = beta[k] - m;
            const float nm = m + a.act[hf] * delta / a.cnt[hf];
            a.out_fmean[idx] = nm;
            a.out_fm2[idx] = f2[hf][k] + a.act[hf] * delta * (beta[k] - nm);
          }
        }
      }

      float hold[T], Lold[T];
#pragma unroll
      for (int q = 0; q < T; ++q) hold[q] = hb[oT + q];
#pragma unroll
      for (int k = 0; k < P; ++k) hold[pidx(k, k)] += itau2[k];
      chol<P>(hold, Lold);
      float step[P], mean_old[P];
      spd_solve<P>(Lold, gold, step);
#pragma unroll
      for (int k = 0; k < P; ++k) mean_old[k] = beta[k] + step[k];

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
      // |eps|^2 now, so that eps is dead across the obs pass
      float eps_sq = 0.0f;
#pragma unroll
      for (int k = 0; k < P; ++k) eps_sq += eps[k] * eps[k];
      const float lsv = lb[o1];
      const float sc = expf(lsv);
      const float inv_c = expf(-2.0f * lsv);
      float shaped[P], prop[P];
      solve_upper_t<P>(Lold, eps, shaped);
#pragma unroll
      for (int k = 0; k < P; ++k) prop[k] = mean_old[k] + sc * shaped[k];

      float llp, gll[P], hll[T];
      obs_pass<Fam, P, !FROZEN>(sm.xs + (size_t)u * a.n * P,
                                sm.ys + (size_t)u * a.n,
                                sm.ms + (size_t)u * a.n, a.n, prop, llp, gll,
                                hll);
      if (Fam::kConst) llp -= a.cst[gi];

      float dp[P], gnew[P];
      float quad = 0.0f;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        dp[k] = prop[k] - (Fam::kUnitMean ? mb[oP + k] : mu_c[k]);
        gnew[k] = gll[k] - dp[k] * itau2[k];
        quad += -0.5f * (dp[k] * dp[k] - db[k] * db[k]) * itau2[k];
      }
      float Lnew[T];
      if (FROZEN) {
#pragma unroll
        for (int q = 0; q < T; ++q) Lnew[q] = Lold[q];
      } else {
        float hnew[T];
#pragma unroll
        for (int q = 0; q < T; ++q) hnew[q] = hll[q];
#pragma unroll
        for (int k = 0; k < P; ++k) hnew[pidx(k, k)] += itau2[k];
        chol<P>(hnew, Lnew);
      }
      float step_new[P], rev[P];
      spd_solve<P>(Lnew, gnew, step_new);
#pragma unroll
      for (int k = 0; k < P; ++k) rev[k] = beta[k] - (prop[k] + step_new[k]);
      const float vold = vb[o1];
      // forward whitened residual is exactly sqrt(c) eps by construction
      float log_alpha = (llp - vold + quad) +
                        0.5f * (eps_sq - inv_c * lt_vec_sq<P>(Lnew, rev));
      if (!FROZEN) {
        float det_ratio = Lnew[pidx(0, 0)] / Lold[pidx(0, 0)];
#pragma unroll
        for (int k = 1; k < P; ++k)
          det_ratio *= Lnew[pidx(k, k)] / Lold[pidx(k, k)];
        log_alpha += logf(det_ratio);
      }

      const bool accept = logu < log_alpha;  // NaN compares false: reject
      vb[o1] = accept ? llp : vold;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        bb[oP + k] = accept ? prop[k] : beta[k];
        gb[oP + k] = accept ? gll[k] : gb[oP + k];
      }
      if (!FROZEN) {
#pragma unroll
        for (int q = 0; q < T; ++q) hb[oT + q] = accept ? hll[q] : hb[oT + q];
      }
      lb[o1] = isnan(log_alpha) ? 0.0f : expf(fminf(log_alpha, 0.0f));
    }
  }
  __syncthreads();
  store_rows(bb, a.out_beta, t, P, a.G);
  store_rows(gb, a.out_g, t, P, a.G);
  store_rows(vb, a.out_v, t, 1, a.G);
  store_rows(lb, a.out_alpha, t, 1, a.G);
  if (!FROZEN) store_rows(hb, a.out_h, t, T, a.G);
}

template <class Fam, int P, bool FROZEN, bool FOLD, bool EXT>
static cudaError_t launch_newton_tiled(const NewtonArgs& a, cudaStream_t s) {
  static SmemGrant grant;
  const TilePlan plan = newton_plan<Fam, P, EXT>(a.n);
  if (plan.tg == 0) return cudaErrorInvalidValue;
  auto kernel = newton_step_kernel<Fam, P, FROZEN, FOLD, EXT>;
  const cudaError_t e = grant.allow(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.G + plan.tg - 1) / plan.tg, (a.C + kTileC - 1) / kTileC);
  kernel<<<grid, tile_threads(plan.tg), plan.smem, s>>>(a, plan.tg);
  return cudaGetLastError();
}

// eps != null takes external noise.
template <class Fam, int P, bool FROZEN, bool FOLD>
static cudaError_t launch_newton(const NewtonArgs& a, cudaStream_t s) {
  return a.eps != nullptr
             ? launch_newton_tiled<Fam, P, FROZEN, FOLD, true>(a, s)
             : launch_newton_tiled<Fam, P, FROZEN, FOLD, false>(a, s);
}

}  // namespace nestmc
