// One MALA update of every (chain, group) block of the hierarchical
// logistic model, with the optional streaming split-R-hat Welford fold.
//
// Replaces nestmc/ops/pallas/mala_accept.py::fused_mala_logistic_step
// (kernel _make_fused_mala_kernel); the noise comes from csrc/philox.cuh.
//
// Per cell, in registers:
//   1. the full-conditional gradient at beta: the carried likelihood
//      gradient g plus the Gaussian group prior's, g - (beta - mu)/tau^2;
//   2. the Langevin proposal beta + (s^2/2) g + s eps, s = e^log_scale (eps
//      from Philox or given);
//   3. one obs pass at the proposal (csrc/logistic_terms.cuh): loglik and
//      gradient;
//   4. the conditional delta (loglik delta plus the prior quadratics; the
//      log tau terms cancel) and the asymmetric-proposal correction
//      (|s eps|^2 - |beta - prop - (s^2/2) g'|^2) / (2 s^2);
//   5. accept (log u < log alpha; NaN rejects) and the selects.
// FOLD folds the INPUT beta (the previous retained draw) into the
// (2, G, P, C) Welford accumulators with the per-half (count, active)
// scalars of nestmc_torch.diagnostics.fold_rhat_scalars, as
// newton_accept.cu does.
//
// Layout and launch: as loglik_logistic.cu, one thread per cell, one group
// per block, 128 chains per block; the group's data sits in shared memory
// (400 B at n=20, P=3). The public (C, G, ...) layouts are read directly.
//
// Bound on the H100: at the mala-100k shape (C=512, G=100,000, n=20, P=3)
// a call reads beta and g (614 MB each) and v and log_scale (205 MB each)
// and writes beta, g (614 MB each), v and alpha (205 MB each): 3.3 GB,
// 0.98 ms at 3.35 TB/s; the obs pass adds 1.02 G obs-cells of 2
// transcendentals, a division and about 4P FMAs, so memory bounds it. The
// design reads and writes every operand exactly once and keeps the
// (C, G, n) lattice in registers; the fold adds 4 x 1.23 GB (accumulators
// read and written) to the same pass. Measured on an H100 80GB HBM3 at
// 700 W (PERF.md): 10.1 ms with external noise, 8.2x its 1.23 ms bound,
// 9 ms a sweep with Philox noise: with the chain on the thread index a
// warp's loads of the (C, G, ...) operands lie G*P floats apart, so they
// are uncoalesced. A warp over consecutive groups of one chain (several
// groups' data staged per block) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "logistic_terms.cuh"
#include "philox.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

namespace nestmc {

constexpr int kMalaThreads = 128;

struct MalaArgs {
  const float* x;      // (G, n, P)
  const float* y;      // (G, n)
  const float* mask;   // (G, n)
  const float* beta;   // (C, G, P)
  const float* v;      // (C, G) carried loglik
  const float* g;      // (C, G, P) carried loglik gradient
  const float* ls;     // (C, G) log proposal scale
  const float* mu;     // (C, P)
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

template <int P, bool FOLD, bool EXT>
__global__ void __launch_bounds__(kMalaThreads)
    mala_step_kernel(const MalaArgs a) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + a.n * P;
  float* ms = ys + a.n;
  const int gi = blockIdx.x;
  stage_group<P>(a.x, a.y, a.mask, gi, a.n, xs, ys, ms);
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const size_t cell = (size_t)c * a.G + gi;

  float beta[P], mu[P], itau2[P], gcar[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    beta[k] = a.beta[cell * P + k];
    gcar[k] = a.g[cell * P + k];
    mu[k] = a.mu[c * P + k];
    itau2[k] = expf(-2.0f * a.lt[c * P + k]);
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
    for (int k = 0; k < P; ++k) eps[k] = a.eps[cell * P + k];
    logu = a.logu[cell];
  } else {
    float u[2 * P + 1];
    philox_uniforms<2 * P + 1>(a.k0, a.k1, (uint32_t)cell, u);
#pragma unroll
    for (int k = 0; k < P; ++k) eps[k] = box_muller(u[2 * k], u[2 * k + 1]);
    logu = logf(u[2 * P]);
  }
  const float lsv = a.ls[cell];
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
  obs_pass<P, false>(xs, ys, ms, a.n, prop, llp, gll, unused);

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
  const float vold = a.v[cell];
  const float log_alpha =
      (llp - vold + quad) + (fwd_sq - rev_sq) / (2.0f * expf(2.0f * lsv));

  const bool accept = logu < log_alpha;  // NaN compares false: reject
  a.out_v[cell] = accept ? llp : vold;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    a.out_beta[cell * P + k] = accept ? prop[k] : beta[k];
    a.out_g[cell * P + k] = accept ? gll[k] : gcar[k];
  }
  a.out_alpha[cell] =
      isnan(log_alpha) ? 0.0f : expf(fminf(log_alpha, 0.0f));
}

template <bool FOLD, bool EXT>
cudaError_t launch_mala(const MalaArgs& a, cudaStream_t s) {
  constexpr int P = NESTMC_P;
  const dim3 grid(a.G, (a.C + kMalaThreads - 1) / kMalaThreads);
  const size_t smem = sizeof(float) * (size_t)a.n * (P + 2);
  mala_step_kernel<P, FOLD, EXT><<<grid, kMalaThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace nestmc

// fmean != null turns on the fold; eps != null takes external noise
// (eps, logu) instead of Philox(k0, k1). Returns the cudaError_t of the
// launch (0 = success).
extern "C" int nestmc_mala_step(
    const float* x, const float* y, const float* mask, const float* beta,
    const float* v, const float* g, const float* ls, const float* mu,
    const float* lt, const float* eps, const float* logu, const float* fmean,
    const float* fm2, float* out_beta, float* out_v, float* out_g,
    float* out_alpha, float* out_fmean, float* out_fm2, float cnt0,
    float act0, float cnt1, float act1, int C, int G, int n, unsigned int k0,
    unsigned int k1, void* stream) {
  using namespace nestmc;
  MalaArgs a{x,         y,        mask,         beta,        v,
             g,         ls,       mu,           lt,          eps,
             logu,      fmean,    fm2,          out_beta,    out_v,
             out_g,     out_alpha, out_fmean,   out_fm2,     {cnt0, cnt1},
             {act0, act1}, C,     G,            n,           k0,
             k1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fold = fmean != nullptr;
  const bool ext = eps != nullptr;
  cudaError_t err;
  if (fold) {
    err = ext ? launch_mala<true, true>(a, s) : launch_mala<true, false>(a, s);
  } else {
    err = ext ? launch_mala<false, true>(a, s)
              : launch_mala<false, false>(a, s);
  }
  return (int)err;
}
