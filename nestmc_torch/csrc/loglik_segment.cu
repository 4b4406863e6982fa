// Ragged (segment) Bernoulli-logit obs passes over flat observations:
// loglik (C, G) and, with GRAD, the gradient (C, G, P), for beta (C, G, P),
// x (N, P), y (N) and the CSR row pointer offsets (G+1) of the sorted
// segment ids (group g owns rows offsets[g] .. offsets[g+1] - 1).
//
// Replaces nestmc/ops/pallas/loglik_segment.py::_segment_call (kernel
// _make_segment_kernel), via logistic_loglik_segment_pallas and
// logistic_logp_grad_segment_pallas.
//
// Design: a direct segmented reduction, not the reference's tiled CSR. The
// Pallas kernel pads tiles of groups to whole chunks of observations,
// carries each tile's sums across sequential grid steps, and gathers each
// observation's coefficients and reduces observations to groups with
// one-hot (TN, TG) matrix products, which multiply the gather's work by
// TG. Blocks on Hopper run in no order, so here one block owns one group
// (blockIdx.x) for 128 chains (blockIdx.y tiles the chains), one thread a
// (chain, group) cell: the block stages the group's observations in shared
// memory in chunks of kChunk (so a group of any size works), and each
// thread runs eta = x . beta[c, g, :] and the Logit terms of
// logistic_terms.cuh (the same softplus and sigmoid as the padded kernels
// of the bucketed route) and keeps the loglik and the P gradient sums in
// registers. Each cell is written once: no atomics, no second pass, so
// the sums are deterministic, and an empty group writes 0. No padding and
// no tiles: the data are read once per chain tile.
//
// Bound on the H100: at config 4's shape (C=1024, G=10,000, N about
// 175,000, P=3) a value + gradient call moves about 290 MB (beta 123 MB
// in, loglik 41 MB and gradient 123 MB out, x, y and offsets about 3 MB):
// about 0.087 ms at 3.35 TB/s, against about 5.2 GFLOP (0.078 ms at
// 67 TFLOP/s), so bytes bound it; the value-only call moves about 167 MB.
// The design keeps the (C, N) lattice out of device memory. Its known cost
// is the one of every kernel of the port: with the chain on the thread
// index a warp's beta loads and loglik/gradient stores lie G*P floats
// apart, so they are not coalesced (PERF.md, where the time is measured).

#include <cuda_runtime.h>

#include "logistic_terms.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

namespace nestmc {

constexpr int kSegThreads = 128;
constexpr int kChunk = 256;  // observations staged at once: 4 KB at P=3

template <int P, bool GRAD>
__global__ void __launch_bounds__(kSegThreads)
    segment_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const int* __restrict__ offsets,
                   const float* __restrict__ beta, float* __restrict__ out_v,
                   float* __restrict__ out_g, int C, int G) {
  __shared__ float xs[kChunk * P];
  __shared__ float ys[kChunk];
  const int g = blockIdx.x;
  const int lo = offsets[g];
  const int hi = offsets[g + 1];
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = c < C;  // the chain edge stays in the loop's barriers
  const size_t cell = (size_t)c * G + g;

  float b[P];
#pragma unroll
  for (int k = 0; k < P; ++k) b[k] = live ? beta[cell * P + k] : 0.0f;
  float ll = 0.0f;
  float gs[P];
#pragma unroll
  for (int k = 0; k < P; ++k) gs[k] = 0.0f;

  for (int start = lo; start < hi; start += kChunk) {
    const int m = min(kChunk, hi - start);
    __syncthreads();  // the previous chunk has been read by every thread
    for (int i = threadIdx.x; i < m * P; i += blockDim.x)
      xs[i] = x[(size_t)start * P + i];
    for (int i = threadIdx.x; i < m; i += blockDim.x) ys[i] = y[start + i];
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      float xi[P];
      float eta = 0.0f;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        xi[k] = xs[i * P + k];
        eta = fmaf(xi[k], b[k], eta);
      }
      if (GRAD) {
        float l, r, w;
        Logit::terms(eta, ys[i], 1.0f, l, r, w);
        ll += l;
#pragma unroll
        for (int k = 0; k < P; ++k) gs[k] = fmaf(xi[k], r, gs[k]);
      } else {
        ll += Logit::value(eta, ys[i], 1.0f);
      }
    }
  }
  if (!live) return;
  out_v[cell] = ll;
  if (GRAD) {
#pragma unroll
    for (int k = 0; k < P; ++k) out_g[cell * P + k] = gs[k];
  }
}

template <int P, bool GRAD>
cudaError_t launch_segment(const float* x, const float* y,
                           const int* offsets, const float* beta,
                           float* out_v, float* out_g, int C, int G,
                           cudaStream_t s) {
  const dim3 grid(G, (C + kSegThreads - 1) / kSegThreads);
  segment_kernel<P, GRAD><<<grid, kSegThreads, 0, s>>>(
      x, y, offsets, beta, out_v, out_g, C, G);
  return cudaGetLastError();
}

}  // namespace nestmc

// Value-only ragged loglik (C, G). Returns the cudaError_t of the launch.
extern "C" int nestmc_seg_loglik(const float* x, const float* y,
                                 const int* offsets, const float* beta,
                                 float* out_v, int C, int G, void* stream) {
  return (int)nestmc::launch_segment<NESTMC_P, false>(
      x, y, offsets, beta, out_v, nullptr, C, G,
      static_cast<cudaStream_t>(stream));
}

// Ragged loglik (C, G) and gradient (C, G, P). Returns the cudaError_t of
// the launch.
extern "C" int nestmc_seg_logp_grad(const float* x, const float* y,
                                    const int* offsets, const float* beta,
                                    float* out_v, float* out_g, int C, int G,
                                    void* stream) {
  return (int)nestmc::launch_segment<NESTMC_P, true>(
      x, y, offsets, beta, out_v, out_g, C, G,
      static_cast<cudaStream_t>(stream));
}
