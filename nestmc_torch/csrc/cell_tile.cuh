// The (unit x chain) tile of every kernel of the port: rwmh_step_kernel
// (rwmh_kernel.cuh), mala_step_kernel (mala_kernel.cuh), newton_step_kernel
// (newton_kernel.cuh), logp_grad_kernel and loglik_kernel
// (loglik_kernels.cuh) and, over ragged groups, segment_kernel
// (segment_kernel.cuh).
//
// A block covers tg consecutive units x kTileC = 32 consecutive chains:
//   1. stage in, with asynchronous copies (cp.async) that a thread issues
//      all at once and the block waits for once: the tg units' x, y and mask
//      are three contiguous runs (16 bytes a copy where both ends are
//      16-byte aligned); each chain row of a (C, units, w) operand is one
//      contiguous run of tg*w floats, copied by a warp with consecutive
//      lanes on consecutive addresses into a shared row buffer of odd
//      stride (tg*w) | 1;
//   2. compute: a warp takes 32 chains of one unit, a lane one chain, so
//      the x reads of obs_pass stay broadcasts and the odd stride puts the
//      32 lanes' reads of a staged row on 32 banks; the chains-minor
//      (2, units, P, C) fold accumulators are read and written coalesced
//      straight from device memory;
//   3. stage out: the results go into row buffers (a lane writes only its
//      own cells), then each chain row is stored as one contiguous run.
// Ragged edges (units not a multiple of tg, chains not of 32, units < tg)
// are masked by predicates: every thread reaches every barrier.
//
// plan_tile picks tg: the largest power of two up to kTileGMax whose shared
// memory still lets as many blocks share an SM as the kernel's register cap
// allows (smem_budget), else tg = 1 up to what one block may take
// (kSmemMax). nestmc_torch/ops/cuda/common.py::tile_plan mirrors it.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace nestmc {

constexpr int kTileC = 32;             // chains a tile: one warp's lanes
constexpr int kTileGMax = 32;          // units a tile at most
constexpr int kTileWarps = 8;          // warps a block at most
constexpr size_t kSmemSM = 233472;     // shared memory of an SM (228 KB)
constexpr size_t kSmemReserved = 1024; // reserved a block
constexpr size_t kSmemMax = 232448;    // the most one block may take
// Blocks an SM the kernels are built for (__launch_bounds__: at most 40
// registers a thread for the value-only loglik, whose blocks have
// kLoglikWarps warps, 48 for logp_grad and the segment kernels, 64 for
// logp_grad_hess, the RW-MH and the MALA step, 80 for the Newton step);
// plan_tile keeps the tile's shared memory within the same count.
constexpr int kLoglikWarps = 4;
constexpr int kLoglikBlocks = 12;
constexpr int kRwBlocks = 4;
constexpr int kLogpGradBlocks = 5;
constexpr int kHessBlocks = 4;
constexpr int kMalaBlocks = 4;
constexpr int kNewtonBlocks = 3;
constexpr int kSegBlocks = 5;

// Shared memory a block may take so that `blocks` blocks share an SM.
__host__ __device__ constexpr size_t smem_budget(int blocks) {
  return kSmemSM / blocks - kSmemReserved;
}

// Row stride, in floats, of a staged operand of w floats a unit: odd.
__host__ __device__ constexpr int row_stride(int tg, int w) {
  return (tg * w) | 1;
}

__host__ __device__ constexpr size_t round4(size_t k) {
  return (k + 3) & ~(size_t)3;
}

// Floats of shared memory a tile of tg units takes: x, y and mask (y alone
// when streams = 1), each from a 16-byte boundary, then one row buffer of
// kTileC rows for each staged operand of widths w[0..nw).
inline size_t tile_floats(int tg, int n, int P, const int* w, int nw,
                          int streams) {
  size_t f = round4((size_t)tg * n * P) + streams * round4((size_t)tg * n);
  for (int i = 0; i < nw; ++i) f += (size_t)kTileC * row_stride(tg, w[i]);
  return f;
}

struct TilePlan {
  int tg;      // units a tile; 0: no tile fits
  int smem;    // bytes of dynamic shared memory
};

inline TilePlan plan_tile(int n, int P, const int* w, int nw, int blocks,
                          int streams = 2) {
  for (int tg = kTileGMax; tg >= 1; tg /= 2) {
    const size_t b = sizeof(float) * tile_floats(tg, n, P, w, nw, streams);
    if (b <= smem_budget(blocks)) return {tg, (int)b};
  }
  const size_t b = sizeof(float) * tile_floats(1, n, P, w, nw, streams);
  return b <= kSmemMax ? TilePlan{1, (int)b} : TilePlan{0, 0};
}

// Threads a block: a warp a unit of the tile, at most `warps`.
inline int tile_threads(int tg, int warps = kTileWarps) {
  return 32 * (tg < warps ? tg : warps);
}

// Lets one kernel take up to kSmemMax bytes of dynamic shared memory, once
// per device: a launcher keeps one static SmemGrant per kernel it launches.
// The launcher is declared static, so that its SmemGrant is the library's
// own: a function-local static of an inline function is one object across
// every library loaded in the process (GNU unique), and two builds of the
// kernels loaded side by side (nestmc_torch.kernel_ab) would share it.
struct SmemGrant {
  uint64_t done = 0;  // one bit a device
  cudaError_t allow(const void* kernel) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 64 && ((done >> dev) & 1)) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemMax);
    if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
    return e;
  }
};

// The block's tile: units [g0, g0 + ng), chains [c0, c0 + nc).
struct Tile {
  int g0, ng, c0, nc, tg;
};

__device__ __forceinline__ Tile tile_of(int tg, int C, int G) {
  Tile t;
  t.tg = tg;
  t.g0 = blockIdx.x * tg;
  t.ng = min(tg, G - t.g0);
  t.c0 = blockIdx.y * kTileC;
  t.nc = min(kTileC, C - t.c0);
  return t;
}

// Asynchronous copies from device to shared memory (cp.async): a thread
// issues all of its copies without waiting on any, and stage_wait waits for
// the block's copies once, so staging costs one memory latency, not one a
// copy. Without __CUDA_ARCH__ (the host pass, never run) a plain copy.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#else
  for (int k = 0; k < 4; ++k) dst[k] = src[k];
#endif
}

// Every thread's copies have landed and the block may read them.
__device__ __forceinline__ void stage_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
  __syncthreads();
}

// Copy len contiguous floats with every thread of the block, 16 bytes a
// copy where both ends are 16-byte aligned.
__device__ __forceinline__ void copy_run(const float* __restrict__ src,
                                         float* __restrict__ dst,
                                         size_t len) {
  size_t i0 = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const size_t n4 = len >> 2;
    for (size_t i = threadIdx.x; i < n4; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
    i0 = n4 << 2;
  }
  for (size_t i = i0 + threadIdx.x; i < len; i += blockDim.x)
    cp_async4(dst + i, src + i);
}

// Stage the tile's units' x (n*P a unit), y and mask (n) in xs, ys, ms;
// the copies land after stage_wait.
__device__ __forceinline__ void stage_units(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ mask, const Tile& t, int n, int P, float* xs,
    float* ys, float* ms) {
  const size_t obs = (size_t)t.g0 * n;
  copy_run(x + obs * P, xs, (size_t)t.ng * n * P);
  copy_run(y + obs, ys, (size_t)t.ng * n);
  copy_run(mask + obs, ms, (size_t)t.ng * n);
}

// The shared-memory carve of a tile: unit data first, then row buffers
// (a tile of x and y alone, streams = 1, sets next = ms).
struct TileSmem {
  float* xs;
  float* ys;
  float* ms;
  float* next;
  int tg;
  __device__ TileSmem(float* smem, int tg_, int n, int P) : tg(tg_) {
    xs = smem;
    ys = xs + round4((size_t)tg * n * P);
    ms = ys + round4((size_t)tg * n);
    next = ms + round4((size_t)tg * n);
  }
  // The next row buffer, for an operand of w floats a unit.
  __device__ float* rows(int w) {
    float* r = next;
    next += (size_t)kTileC * row_stride(tg, w);
    return r;
  }
};

// Stage the tile's cells of a (C, G, w) operand: one warp a chain row.
// The copies land after stage_wait.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           float* buf, const Tile& t, int w,
                                           int G) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, len = t.ng * w;
  const int stride = row_stride(t.tg, w);
  for (int r = warp; r < t.nc; r += nw) {
    const float* row = src + ((size_t)(t.c0 + r) * G + t.g0) * w;
    for (int i = lane; i < len; i += 32)
      cp_async4(buf + r * stride + i, row + i);
  }
}

// Store the tile's cells of a (C, G, w) output from its row buffer.
__device__ __forceinline__ void store_rows(const float* buf,
                                           float* __restrict__ dst,
                                           const Tile& t, int w, int G) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, len = t.ng * w;
  const int stride = row_stride(t.tg, w);
  for (int r = warp; r < t.nc; r += nw) {
    float* row = dst + ((size_t)(t.c0 + r) * G + t.g0) * w;
    for (int i = lane; i < len; i += 32) row[i] = buf[r * stride + i];
  }
}

}  // namespace nestmc
