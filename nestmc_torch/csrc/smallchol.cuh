// Unrolled packed Cholesky algebra for tiny (P <= 8) SPD matrices, kept in
// registers: the device form of nestmc_torch/ops/smallchol.py (and of the
// _chol_slices/_spd_solve_slices/_solve_upper_t_slices/_lt_vec_slices
// helpers of nestmc/ops/pallas/newton_accept.py). Packed layout: row-major
// lower triangle, entry (i, j), i >= j, at i (i + 1) / 2 + j. Every loop
// bound is a compile-time constant, so the arrays stay in registers.
#pragma once

namespace nestmc {

__host__ __device__ constexpr int packed_dim(int p) { return p * (p + 1) / 2; }

__host__ __device__ constexpr int pidx(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// L L^T = a; no pivoting (a non-PD input yields NaN, which rejects).
template <int P>
__device__ __forceinline__ void chol(const float (&a)[packed_dim(P)],
                                     float (&L)[packed_dim(P)]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float s = a[pidx(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[pidx(j, k)] * L[pidx(j, k)];
    L[pidx(j, j)] = sqrtf(s);
    const float inv_d = 1.0f / L[pidx(j, j)];
#pragma unroll
    for (int i = j + 1; i < P; ++i) {
      float t = a[pidx(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[pidx(i, k)] * L[pidx(j, k)];
      L[pidx(i, j)] = t * inv_d;
    }
  }
}

// x with L^T x = b (back substitution).
template <int P>
__device__ __forceinline__ void solve_upper_t(const float (&L)[packed_dim(P)],
                                              const float (&b)[P],
                                              float (&x)[P]) {
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k) s -= L[pidx(k, i)] * x[k];
    x[i] = s / L[pidx(i, i)];
  }
}

// x with (L L^T) x = b: forward then back substitution.
template <int P>
__device__ __forceinline__ void spd_solve(const float (&L)[packed_dim(P)],
                                          const float (&b)[P],
                                          float (&x)[P]) {
  float y[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[pidx(i, k)] * y[k];
    y[i] = s / L[pidx(i, i)];
  }
  solve_upper_t<P>(L, y, x);
}

// sum_i (L^T v)_i^2 = v^T (L L^T) v.
template <int P>
__device__ __forceinline__ float lt_vec_sq(const float (&L)[packed_dim(P)],
                                           const float (&v)[P]) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = L[pidx(i, i)] * v[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k) s += L[pidx(k, i)] * v[k];
    acc += s * s;
  }
  return acc;
}

}  // namespace nestmc
