// What the fused walk kernel (walk_fused.cu, K1) and the per-phase walk
// kernel (walk_phase.cu, K2) share: the counter RNG of the reference's
// walker (src/repro/kernels/pdgraph_walk/kernel.py, _kernel step_fn; its
// jnp twin ref.py walk_phase_ref), the exact small-integer conversions a
// step uses and the CDF scan unrolled over UMAX >= U units.
//
// Bits: every float op carries an explicit rounding intrinsic and the
// sources are built with -fmad=false, so nothing is contracted into a fused
// multiply-add.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pdgraph_walk {

constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;
// float32 constants exactly as the reference rounds them (np.float32(x))
constexpr float kNever = 0x1.93e594p+99f;       // 1e30  (ARRIVAL_NEVER)
constexpr float kHalfNever = 0x1.93e594p+98f;   // 5e29
constexpr float kU16 = 0x1p-16f;                // 1 / 65536

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 13;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

// The draw of global step `step` of the walker on original lane `lane` of
// an app with `lanes_per_app` walkers: uint32 arithmetic, as the reference.
__device__ __forceinline__ uint32_t step_counter(int step, int lanes_per_app,
                                                 uint32_t lane) {
  return static_cast<uint32_t>(step) * static_cast<uint32_t>(lanes_per_app)
         + lane;
}

// The float value of an integer below 2^23, and the floor of a float in
// [0, 2^23) as an integer, by full-rate float adds on 2^23 instead of
// conversion instructions (exact: the same values __uint2float_rn and
// __float2int_rz(floorf(.)) give there).
__device__ __forceinline__ float small_uint_to_float(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 0x1p23f);
}
__device__ __forceinline__ int floor_small(float v) {
  return __float_as_int(__fadd_rz(v, 0x1p23f)) - 0x4B000000;
}

// The next unit: how many of the U + 1 CDF entries r2 exceeds.
template <int UMAX>
__device__ __forceinline__ int cdf_next(const float* cdf, int U, float r2) {
  int nxt = 0;
#pragma unroll
  for (int k = 0; k <= UMAX; ++k)
    if (k <= U) nxt += r2 > cdf[k] ? 1 : 0;
  return nxt;
}

}  // namespace pdgraph_walk
