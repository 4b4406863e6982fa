// The obs pass every kernel makes over one unit's n observations, for a
// likelihood family given as a tag type (logistic_terms.cuh: Logit,
// poisson_terms.cuh: Poisson) with two device functions:
//   Fam::terms(eta, y, m, ll, resid, w)  masked loglik term, gradient weight
//                                        (y - mean) and Newton curvature w;
//   Fam::value(eta, y, m)                the masked loglik term alone.
// The unit's x (n, P) row-major, y and mask (n) are staged in shared memory
// by cell_tile.cuh's stage_units and read by every thread of a warp as
// broadcasts; eta, the loglik, the P gradient sums and the T packed
// -Hessian sums stay in registers, so the (C, units, n) lattice never
// reaches device memory.
#pragma once

#include "smallchol.cuh"

namespace nestmc {

// Value-only pass (the RW-MH step and the value-only eval kernel). With n
// even it reads two observations' x (2P floats), y and mask as 8-byte
// pairs: the tile stages its units back to back from 16-byte boundaries
// (cell_tile.cuh), so each unit's x, y and mask then start 8-byte aligned,
// and the pairs halve the shared-memory loads of the loop. The sum runs
// over i in order either way.
template <class Fam, int P>
__device__ __forceinline__ float obs_loglik(const float* xs, const float* ys,
                                            const float* ms, int n,
                                            const float (&b)[P]) {
  float ll = 0.0f;
  int i = 0;
  if ((n & 1) == 0) {
    const float2* x2 = reinterpret_cast<const float2*>(xs);
    const float2* y2 = reinterpret_cast<const float2*>(ys);
    const float2* m2 = reinterpret_cast<const float2*>(ms);
    for (; i < n; i += 2) {
      float xv[2 * P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float2 t = x2[(i >> 1) * P + j];
        xv[2 * j] = t.x;
        xv[2 * j + 1] = t.y;
      }
      const float2 yv = y2[i >> 1], mv = m2[i >> 1];
      float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        e0 = fmaf(xv[k], b[k], e0);
        e1 = fmaf(xv[P + k], b[k], e1);
      }
      ll += Fam::value(e0, yv.x, mv.x);
      ll += Fam::value(e1, yv.y, mv.y);
    }
  }
  for (; i < n; ++i) {
    float eta = 0.0f;
#pragma unroll
    for (int k = 0; k < P; ++k) eta = fmaf(xs[i * P + k], b[k], eta);
    ll += Fam::value(eta, ys[i], ms[i]);
  }
  return ll;
}

// Loglik, the P gradient sums and, when HESS, the T packed -Hessian sums.
template <class Fam, int P, bool HESS>
__device__ __forceinline__ void obs_pass(const float* xs, const float* ys,
                                         const float* ms, int n,
                                         const float (&b)[P], float& ll,
                                         float (&g)[P],
                                         float (&h)[packed_dim(P)]) {
  ll = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) g[k] = 0.0f;
#pragma unroll
  for (int t = 0; t < packed_dim(P); ++t) h[t] = 0.0f;
  for (int i = 0; i < n; ++i) {
    float xi[P];
    float eta = 0.0f;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      xi[k] = xs[i * P + k];
      eta = fmaf(xi[k], b[k], eta);
    }
    float l, r, w;
    Fam::terms(eta, ys[i], ms[i], l, r, w);
    ll += l;
#pragma unroll
    for (int k = 0; k < P; ++k) g[k] = fmaf(xi[k], r, g[k]);
    if (HESS) {
#pragma unroll
      for (int a = 0; a < P; ++a) {
#pragma unroll
        for (int c = 0; c <= a; ++c) {
          h[pidx(a, c)] = fmaf(xi[a] * xi[c], w, h[pidx(a, c)]);
        }
      }
    }
  }
}

}  // namespace nestmc
