// Device helpers shared by the wire kernels of csrc/*.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wire {

constexpr int kThreads = 256;

// The biased 2-bit field (code + 1) of one parameter, exactly the rule of
// _codes_any in the JAX package's kernels/fused_wire.py: Eq. (4) at
// round <= 1 (p1 holds P^0), Eq. (5) after. The sign is taken of the
// product delta * step, so a product that underflows to 0 gives code 0,
// and the tie |delta| == beta * |step| counts as significant.
__device__ __forceinline__ uint32_t wire_field(float q, float p1, float step,
                                               float beta, float alpha1,
                                               bool round1) {
  const float delta = __fsub_rn(q, p1);
  if (round1) {
    return 1u + (delta > alpha1 ? 1u : 0u) - (delta < -alpha1 ? 1u : 0u);
  }
  if (!(fabsf(delta) >= __fmul_rn(beta, fabsf(step)))) return 1u;
  const float prod = __fmul_rn(delta, step);
  return 1u + (prod > 0.f ? 1u : 0u) - (prod < 0.f ? 1u : 0u);
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                     __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}

inline unsigned blocks_for(int64_t m) {
  return static_cast<unsigned>((m + kThreads - 1) / kThreads);
}

}  // namespace wire
