// Threefry-2x32 (20 rounds, Salmon et al. 2011) and the uniform draw of
// `jax.random` as device functions: element i of `uniform(key, shape)` from
// the key's two 32-bit words and the row-major flat index i, bit for bit
// what repro_torch/random.py computes in tensor ops (`threefry2x32`,
// `_counters`, `_draw`, `uniform`), which is `jax.random` with partitionable
// threefry:
//   (y0, y1) = threefry2x32(k0, k1, i >> 32, i & 0xffffffff),
//   b = y0 ^ y1,  u = bitcast((b >> 9) | 0x3F800000) - 1.
// Shared by every kernel that draws its own uniforms in registers instead
// of reading them from device memory.
#pragma once

#include <stdint.h>

namespace repro_threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds of one rotation schedule: x0 += x1; x1 = rotl(x1, r) ^ x0.
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// threefry2x32 of the counter pair (x0, x1) under key (k0, k1), in place:
// five groups of four rounds, the rotations (13, 15, 26, 6) and (17, 29,
// 16, 24) in turn, a key injection after each group.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
}

// jax.random.uniform's float32 on [0, 1) at flat index i.
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            unsigned long long i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32);
  uint32_t x1 = static_cast<uint32_t>(i);
  threefry2x32(k0, k1, x0, x1);
  const uint32_t b = x0 ^ x1;
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

}  // namespace repro_threefry
