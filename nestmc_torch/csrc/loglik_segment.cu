// Ragged (segment) Bernoulli-logit obs passes over flat observations:
// loglik (C, G) and, with GRAD, the gradient (C, G, P), for beta (C, G, P),
// x (N, P), y (N) and the CSR row pointer offsets (G+1) of the sorted
// segment ids (group g owns rows offsets[g] .. offsets[g+1] - 1).
//
// Replaces nestmc/ops/pallas/loglik_segment.py::_segment_call (kernel
// _make_segment_kernel), via logistic_loglik_segment_pallas and
// logistic_logp_grad_segment_pallas.
//
// Design: a direct segmented reduction on the (unit x chain) tile of
// cell_tile.cuh, not the reference's tiled CSR (which pads tiles of groups
// to whole chunks of observations, carries each tile's sums across
// sequential grid steps and gathers and reduces with one-hot (TN, TG)
// matrix products: blocks on Hopper run in no order, so nothing carries
// between them). A block covers tg consecutive groups x 32 consecutive
// chains:
//   1. a lane reads its chain's P betas of a group straight from device
//      memory, as logp_grad_kernel does: the block's warps read
//      neighbouring groups of the same 32 chain rows, so the sectors are
//      reused from L1 (staged through a row buffer, beta measured 7-9%
//      slower);
//   2. the tile's groups own one contiguous run of observations,
//      offsets[g0] .. offsets[g0 + ng]; the block stages it with cp.async
//      (copy_run) in chunks of at most tg * kSegObs observations, so a
//      group or a tile of any size works;
//   3. a warp takes a group (groups u, u + warps, ... of the tile: round
//      robin, no sort by size), a lane a chain: eta = x . beta[c, g, :] and
//      the Logit terms of logistic_terms.cuh (the same softplus and sigmoid
//      as the padded kernels) over the group's observations in their
//      order; the loglik and the P gradient sums carry across chunks in the
//      output row buffers (a float store and reload is exact), so every
//      sum is taken in the order of the one-thread-a-cell kernel this
//      replaced and the outputs are bitwise the same;
//   4. the outputs leave through the row buffers, one contiguous run a
//      chain row (store_rows).
// Each cell is written once: no atomics, no second pass, so the sums are
// deterministic, and an empty group writes 0. Ragged edges (G not a
// multiple of tg, C not of 32) are masked by predicates; every thread
// reaches every barrier. With groups of 5..30 observations (config 4) a
// warp's share of a tile is the sum of its tg/8 groups' sizes, and the
// block's warps wait for the longest at the final store (PERF.md measures
// what that imbalance costs).
//
// Bound on the H100: at config 4's shape (C=1024, G=10,000, N about
// 175,000, P=3) a value + gradient call moves about 290 MB (beta 123 MB
// in, loglik 41 MB and gradient 123 MB out, x, y and offsets about 3 MB):
// about 0.087 ms at 3.35 TB/s, against about 5.2 GFLOP (0.078 ms at
// 67 TFLOP/s); the value-only call moves about 167 MB. With the traffic
// coalesced, the compiled obs loop (about 80 instructions an obs-cell
// with the gradient: the accurate expf and log1pf and the IEEE division)
// over C x N = 179 M obs-cells is what bounds it. Measured on an NVIDIA
// H100 80GB HBM3 at 700.00 W (PERF.md; python -m nestmc_torch.kernel_ab
// --shapes segment, the one-group-a-block kernel it replaced in brackets):
// seg_logp_grad 0.517-0.520 ms (0.825-0.826); seg_loglik 0.368-0.369
// (0.347-0.349: the value-only loop, the same instructions in both, ran
// near the issue rate one group a block at 64 warps an SM); bitwise the
// outputs of the kernel it replaced.

#include "segment_kernel.cuh"

#ifndef NESTMC_P
#error "build with -DNESTMC_P=<covariate count>"
#endif

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
