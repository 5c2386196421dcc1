// Threefry-2x32, the hash of jax.random (jax/_src/prng.py), shared by the
// kernels that draw random bits on the card (threefry.cu: T1; floyd.cu: F1).
//
// 20 rounds in 5 groups of 4, key injection after each group, rotations
// (13, 15, 26, 6) and (17, 29, 16, 24) alternating, the third key word
// k0 ^ k1 ^ 0x1BD11BDA.
#pragma once

#include <stdint.h>

namespace tgt_rng {

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3) ^ x0;
}

// Threefry-2x32 of the counter words (x0, x1) under key (k0, k1), in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  round4(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  round4(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  round4(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  round4(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  round4(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

}  // namespace tgt_rng
