// The eval kernels of one likelihood family (obs_pass.cuh): loglik +
// gradient (+ packed -Hessian) and the value-only loglik, for every
// (chain, unit) cell. loglik_logistic.cu launches them for Logit,
// loglik_poisson.cu for Poisson.
//
// Both work on the (unit x chain) tile of cell_tile.cuh: tg units' x, y
// and mask staged in shared memory, a warp on 32 chains of one unit, the
// outputs stored through row buffers one contiguous run a chain row. They
// read a cell's P betas straight from device memory: with the lane on the
// chain they are one sector a lane, which the next coordinates' loads and
// the neighbouring units' warps reuse from L1 and L2; staging them measured
// no faster at mala-100k and slower at the judged shape (PERF.md, PR 5).
// logp_grad_kernel (HESS: + packed -Hessian) has two or three output rows;
// loglik_kernel, the value-only pass, one, and it runs 4-warp blocks, 12 an
// SM (kLoglikWarps, kLoglikBlocks: 40 registers), the fastest of the block
// shapes measured (PERF.md, PR 7). Units need no padding; the edges are
// masked. With Fam::kConst the per-unit constant cst[g] is subtracted from
// the loglik.
#pragma once

#include <cuda_runtime.h>

#include "cell_tile.cuh"
#include "obs_pass.cuh"

namespace nestmc {

// Row buffers of the outputs: gradient (P), loglik (1) and, when HESS, the
// packed -Hessian (T).
template <int P, bool HESS>
inline TilePlan logp_grad_plan(int n) {
  const int w[3] = {P, 1, packed_dim(P)};
  return plan_tile(n, P, w, HESS ? 3 : 2,
                   HESS ? kHessBlocks : kLogpGradBlocks);
}

template <class Fam, int P, bool HESS>
__global__ void __launch_bounds__(kTileWarps * 32,
                                  HESS ? kHessBlocks : kLogpGradBlocks)
    logp_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ mask,
                     const float* __restrict__ cst,
                     const float* __restrict__ beta, float* __restrict__ out_v,
                     float* __restrict__ out_g, float* __restrict__ out_h,
                     int C, int G, int n, int tg) {
  constexpr int T = packed_dim(P);
  extern __shared__ __align__(16) float smem[];
  const Tile t = tile_of(tg, C, G);
  TileSmem sm(smem, tg, n, P);
  float* gb = sm.rows(P);
  float* vb = sm.rows(1);
  float* hb = HESS ? sm.rows(T) : nullptr;
  stage_units(x, y, mask, t, n, P, sm.xs, sm.ys, sm.ms);
  stage_wait();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sP = row_stride(tg, P), s1 = row_stride(tg, 1);
  const int sT = row_stride(tg, T);
  if (lane < t.nc) {
    for (int u = warp; u < t.ng; u += nwarps) {
      const int oP = lane * sP + u * P;
      const float* bc = beta + ((size_t)(t.c0 + lane) * G + t.g0 + u) * P;
      float b[P];
#pragma unroll
      for (int k = 0; k < P; ++k) b[k] = bc[k];
      float ll, gs[P], hs[T];
      obs_pass<Fam, P, HESS>(sm.xs + (size_t)u * n * P, sm.ys + (size_t)u * n,
                             sm.ms + (size_t)u * n, n, b, ll, gs, hs);
      if (Fam::kConst) ll -= cst[t.g0 + u];
      vb[lane * s1 + u] = ll;
#pragma unroll
      for (int k = 0; k < P; ++k) gb[oP + k] = gs[k];
      if (HESS) {
#pragma unroll
        for (int q = 0; q < T; ++q) hb[lane * sT + u * T + q] = hs[q];
      }
    }
  }
  __syncthreads();
  store_rows(gb, out_g, t, P, G);
  store_rows(vb, out_v, t, 1, G);
  if (HESS) store_rows(hb, out_h, t, T, G);
}

// The value-only loglik's one output row (width 1).
template <int P>
inline TilePlan loglik_plan(int n) {
  const int w[1] = {1};
  return plan_tile(n, P, w, 1, kLoglikBlocks);
}

template <class Fam, int P>
__global__ void __launch_bounds__(kLoglikWarps * 32, kLoglikBlocks)
    loglik_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ mask,
                  const float* __restrict__ cst,
                  const float* __restrict__ beta, float* __restrict__ out_v,
                  int C, int G, int n, int tg) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = tile_of(tg, C, G);
  TileSmem sm(smem, tg, n, P);
  float* vb = sm.rows(1);
  stage_units(x, y, mask, t, n, P, sm.xs, sm.ys, sm.ms);
  stage_wait();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int s1 = row_stride(tg, 1);
  if (lane < t.nc) {
    for (int u = warp; u < t.ng; u += nwarps) {
      const float* bc = beta + ((size_t)(t.c0 + lane) * G + t.g0 + u) * P;
      float b[P];
#pragma unroll
      for (int k = 0; k < P; ++k) b[k] = bc[k];
      float ll = obs_loglik<Fam, P>(sm.xs + (size_t)u * n * P,
                                    sm.ys + (size_t)u * n,
                                    sm.ms + (size_t)u * n, n, b);
      if (Fam::kConst) ll -= cst[t.g0 + u];
      vb[lane * s1 + u] = ll;
    }
  }
  __syncthreads();
  store_rows(vb, out_v, t, 1, G);
}

template <class Fam, int P>
static cudaError_t launch_loglik(const float* x, const float* y,
                                 const float* mask, const float* cst,
                                 const float* beta, float* out_v, int C,
                                 int G, int n, cudaStream_t s) {
  static SmemGrant grant;
  const TilePlan plan = loglik_plan<P>(n);
  if (plan.tg == 0) return cudaErrorInvalidValue;
  auto kernel = loglik_kernel<Fam, P>;
  const cudaError_t e = grant.allow(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  const dim3 grid((G + plan.tg - 1) / plan.tg, (C + kTileC - 1) / kTileC);
  kernel<<<grid, tile_threads(plan.tg, kLoglikWarps), plan.smem, s>>>(
      x, y, mask, cst, beta, out_v, C, G, n, plan.tg);
  return cudaGetLastError();
}

template <class Fam, int P, bool HESS>
static cudaError_t launch_logp_grad_tiled(const float* x, const float* y,
                                   const float* mask, const float* cst,
                                   const float* beta, float* out_v,
                                   float* out_g, float* out_h, int C, int G,
                                   int n, cudaStream_t s) {
  static SmemGrant grant;
  const TilePlan plan = logp_grad_plan<P, HESS>(n);
  if (plan.tg == 0) return cudaErrorInvalidValue;
  auto kernel = logp_grad_kernel<Fam, P, HESS>;
  const cudaError_t e = grant.allow(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  const dim3 grid((G + plan.tg - 1) / plan.tg, (C + kTileC - 1) / kTileC);
  kernel<<<grid, tile_threads(plan.tg), plan.smem, s>>>(
      x, y, mask, cst, beta, out_v, out_g, out_h, C, G, n, plan.tg);
  return cudaGetLastError();
}

// out_h == nullptr selects logp_grad, otherwise logp_grad_hess.
template <class Fam, int P>
cudaError_t launch_logp_grad(const float* x, const float* y,
                             const float* mask, const float* cst,
                             const float* beta, float* out_v, float* out_g,
                             float* out_h, int C, int G, int n,
                             cudaStream_t s) {
  return out_h == nullptr
             ? launch_logp_grad_tiled<Fam, P, false>(
                   x, y, mask, cst, beta, out_v, out_g, out_h, C, G, n, s)
             : launch_logp_grad_tiled<Fam, P, true>(
                   x, y, mask, cst, beta, out_v, out_g, out_h, C, G, n, s);
}

}  // namespace nestmc
