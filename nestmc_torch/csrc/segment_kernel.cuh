// The ragged (segment) Bernoulli-logit obs pass on the (unit x chain) tile
// of cell_tile.cuh: segment_kernel and its launcher, which
// loglik_segment.cu instantiates (the design and its bound are described
// there), and its tile plan, which tile_plan.cu exports.
#pragma once

#include <cuda_runtime.h>

#include "cell_tile.cuh"
#include "logistic_terms.cuh"

namespace nestmc {

// Observations a group of the tile a chunk: the plan's stand-in for n, so
// a chunk stages up to tg * kSegObs observations (ops/cuda/common.py
// SEG_OBS).
constexpr int kSegObs = 32;

// Row buffers: the gradient (P) and the loglik (1) on their way out; the
// unit data are x and y (no mask), n observations a unit of the tile (the
// launcher's n is kSegObs). The value-only launch carves the same.
template <int P>
inline TilePlan seg_plan(int n) {
  const int w[2] = {P, 1};
  return plan_tile(n, P, w, 2, kSegBlocks, 1);
}

template <int P, bool GRAD>
__global__ void __launch_bounds__(kTileWarps * 32, kSegBlocks)
    segment_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const int* __restrict__ offsets,
                   const float* __restrict__ beta, float* __restrict__ out_v,
                   float* __restrict__ out_g, int C, int G, int tg) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = tile_of(tg, C, G);
  TileSmem sm(smem, tg, kSegObs, P);
  sm.next = sm.ms;          // x and y only: the rows start at the mask's
  float* gb = sm.rows(P);   // gradient sums
  float* vb = sm.rows(1);   // loglik sums

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sP = row_stride(tg, P), s1 = row_stride(tg, 1);
  const bool live = lane < t.nc;  // the chain edge stays in the barriers
  if (live) {
    for (int u = warp; u < t.ng; u += nwarps) {
      vb[lane * s1 + u] = 0.0f;
#pragma unroll
      for (int k = 0; k < P; ++k) gb[lane * sP + u * P + k] = 0.0f;
    }
  }

  const int lo = offsets[t.g0];
  const int hi = offsets[t.g0 + t.ng];
  const int cap = tg * kSegObs;
  for (int start = lo; start < hi; start += cap) {
    const int m = min(cap, hi - start);
    __syncthreads();  // the previous chunk has been read by every thread
    copy_run(x + (size_t)start * P, sm.xs, (size_t)m * P);
    copy_run(y + start, sm.ys, (size_t)m);
    stage_wait();
    if (!live) continue;
    for (int u = warp; u < t.ng; u += nwarps) {
      const int a = max(offsets[t.g0 + u], start) - start;
      const int b = min(offsets[t.g0 + u + 1], start + m) - start;
      if (a >= b) continue;
      const int oP = lane * sP + u * P, o1 = lane * s1 + u;
      // beta straight from device memory, as logp_grad_kernel reads it:
      // the block's warps read neighbouring groups of the same 32 chain
      // rows, so the sectors are reused from L1 (staging it through a row
      // buffer measured 7-9% slower, PERF.md)
      const float* bcp = beta + ((size_t)(t.c0 + lane) * G + t.g0 + u) * P;
      float bc[P], gs[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        bc[k] = bcp[k];
        gs[k] = gb[oP + k];
      }
      float ll = vb[o1];
      for (int i = a; i < b; ++i) {
        float xi[P];
        float eta = 0.0f;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          xi[k] = sm.xs[i * P + k];
          eta = fmaf(xi[k], bc[k], eta);
        }
        if (GRAD) {
          float l, r, w;
          Logit::terms(eta, sm.ys[i], 1.0f, l, r, w);
          ll += l;
#pragma unroll
          for (int k = 0; k < P; ++k) gs[k] = fmaf(xi[k], r, gs[k]);
        } else {
          ll += Logit::value(eta, sm.ys[i], 1.0f);
        }
      }
      vb[o1] = ll;
      if (GRAD) {
#pragma unroll
        for (int k = 0; k < P; ++k) gb[oP + k] = gs[k];
      }
    }
  }
  __syncthreads();    // every warp's sums are in the row buffers
  store_rows(vb, out_v, t, 1, G);
  if (GRAD) store_rows(gb, out_g, t, P, G);
}

template <int P, bool GRAD>
static cudaError_t launch_segment(const float* x, const float* y,
                                  const int* offsets, const float* beta,
                                  float* out_v, float* out_g, int C, int G,
                                  cudaStream_t s) {
  static SmemGrant grant;
  const TilePlan plan = seg_plan<P>(kSegObs);
  if (plan.tg == 0) return cudaErrorInvalidValue;
  auto kernel = segment_kernel<P, GRAD>;
  const cudaError_t e = grant.allow(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  const dim3 grid((G + plan.tg - 1) / plan.tg, (C + kTileC - 1) / kTileC);
  kernel<<<grid, tile_threads(plan.tg), plan.smem, s>>>(
      x, y, offsets, beta, out_v, out_g, C, G, plan.tg);
  return cudaGetLastError();
}

}  // namespace nestmc
