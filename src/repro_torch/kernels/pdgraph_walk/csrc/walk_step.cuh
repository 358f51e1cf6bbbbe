// One step of the counter-RNG PDGraph walker, shared by the fused walk
// kernel (walk_fused.cu, K1) and the per-phase walk kernel (walk_phase.cu,
// K2).  It is the step body of the reference's walker
// (src/repro/kernels/pdgraph_walk/kernel.py, _kernel step_fn; its jnp twin
// ref.py walk_phase_ref) with the one-hot matrix products replaced by
// direct reads.
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

// Advances one live walker by one step: samples the current unit's service
// (override row where the app has one), scales it by the posterior demand
// ratio behind the reference's max(., 0) guard, consumes `executed` on
// global step 0, adds it to `total`, and draws the next unit.  Returns the
// next unit; a value >= U means the walker is absorbed.
//
// `Rows` reads the tables for the current unit of this walker:
//   float n_eff(int cur)          sample count (override count if any)
//   float sample(int cur, int si) the si-th service sample
//   bool  posterior               whether scale() applies
//   float scale(int cur)          posterior demand ratio
//   const float* cdf(int cur)     the U+1 transition CDF entries
template <class Rows>
__device__ __forceinline__ int walk_step(const Rows& rows, int U,
                                         uint32_t stream, uint32_t ctr,
                                         bool first_step, float executed,
                                         int cur, float& total) {
  const uint32_t bits = fmix32(stream + ctr * kGolden);
  const float r = __fmul_rn(__uint2float_rn(bits >> 16), kU16);
  const float r2 = __fmul_rn(__uint2float_rn(bits & 0xFFFFu), kU16);
  const int si = __float2int_rz(floorf(__fmul_rn(r, rows.n_eff(cur))));
  float svc = rows.sample(cur, si);
  if (rows.posterior) svc = fmaxf(__fmul_rn(svc, rows.scale(cur)), 0.0f);
  if (first_step) svc = fmaxf(__fsub_rn(svc, executed), 0.0f);
  total = __fadd_rn(total, svc);
  const float* cdf = rows.cdf(cur);
  int nxt = 0;
  for (int k = 0; k <= U; ++k) nxt += r2 > cdf[k] ? 1 : 0;
  return nxt;
}

}  // namespace pdgraph_walk
