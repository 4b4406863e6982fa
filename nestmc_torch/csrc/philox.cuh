// Counter-based random numbers inside a kernel: Philox-4x32-10 (Salmon et
// al. 2011) keyed by two 32-bit words that the host wrapper draws per call
// from the run's torch.Generator and passes by value. The counter is
// (cell index, draw block, 0, 0), so every (chain, group) cell of every call
// gets its own stream and no state is kept between calls.
//
// Replaces the TPU core-PRNG helpers of nestmc/ops/pallas/mh_accept.py:
// _uniform_01 (24 bits, offset 0.5/2^24 off zero so log u is finite),
// _normal (Box-Muller, cos branch) and _seed_words (64-bit key -> two
// words). The bits differ from the TPU's; the distributions are the same.
#pragma once

#include <stdint.h>

namespace nestmc {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Top 24 bits -> (0, 1]: (b >> 8) 2^-24 + 0.5 2^-24, as _uniform_01.
__device__ __forceinline__ float bits_to_unit(uint32_t b) {
  return (float)(b >> 8) * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
}

// N uniforms for one cell, ceil(N / 4) Philox calls.
template <int N>
__device__ __forceinline__ void philox_uniforms(uint32_t k0, uint32_t k1,
                                                uint32_t cell, float (&u)[N]) {
  const uint2 key = make_uint2(k0, k1);
#pragma unroll
  for (int blk = 0; blk < (N + 3) / 4; ++blk) {
    const uint4 r = philox4x32_10(make_uint4(cell, (uint32_t)blk, 0u, 0u), key);
    if (4 * blk + 0 < N) u[4 * blk + 0] = bits_to_unit(r.x);
    if (4 * blk + 1 < N) u[4 * blk + 1] = bits_to_unit(r.y);
    if (4 * blk + 2 < N) u[4 * blk + 2] = bits_to_unit(r.z);
    if (4 * blk + 3 < N) u[4 * blk + 3] = bits_to_unit(r.w);
  }
}

// Box-Muller, cos branch: sqrt(-2 log u1) cos(2 pi u2).
__device__ __forceinline__ float box_muller(float u1, float u2) {
  return sqrtf(-2.0f * logf(u1)) * cospif(2.0f * u2);
}

}  // namespace nestmc
