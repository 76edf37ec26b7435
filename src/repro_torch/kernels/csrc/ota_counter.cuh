// The counter PRNG that K1 (ota_fused.cu) and K2 (ota_channel.cu) draw their
// AWGN from: the murmur3 finalizer of the TPU kernels' _mix
// (src/repro/kernels/ota_fused.py:60, src/repro/kernels/ota_channel.py:31),
// keyed on (uint32 seed, uint32 absolute flat index), then Box-Muller.
//
// The uniform bits are bitwise the TPU kernels'.  Box-Muller uses logf / cosf
// and sqrtf; build without --use_fast_math so they stay the accurate libdevice
// versions and the normals agree with the plain version to a few ulp.
// One definition here keeps the two kernels' streams equal by construction.
#pragma once

#include <cstdint>

namespace ota_counter {

__device__ __forceinline__ uint32_t mix(uint32_t x, uint32_t salt) {
  x ^= salt;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ void counter_bits(uint32_t j, uint32_t seed,
                                             uint32_t* b1, uint32_t* b2) {
  const uint32_t base = mix(j, seed * 0x9E3779B9u);
  *b1 = mix(base, 0xA511E9B3u) >> 8;
  *b2 = mix(base, 0x63D83595u) >> 8;
}

__device__ __forceinline__ float counter_normal(uint32_t j, uint32_t seed) {
  uint32_t b1, b2;
  counter_bits(j, seed, &b1, &b2);
  // (bits >> 8) * 2^-24 (+ 2^-25 for f1, so f1 is never 0): exact in f32
  const float f1 = __fadd_rn(__fmul_rn(__uint2float_rn(b1), 5.9604644775390625e-08f),
                             2.98023223876953125e-08f);
  const float f2 = __fmul_rn(__uint2float_rn(b2), 5.9604644775390625e-08f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(f1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.2831855f, f2)));  // float32(2 pi)
}

}  // namespace ota_counter
