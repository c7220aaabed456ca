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

// One §3.3 wire byte: the fields of the four consecutive parameters of a
// float4, little-endian (parameter j in bits 2j, 2j + 1).
__device__ __forceinline__ uint32_t wire_byte(float4 q, float4 p1, float4 step,
                                              float beta, float alpha1,
                                              bool round1) {
  return wire_field(q.x, p1.x, step.x, beta, alpha1, round1) |
         wire_field(q.y, p1.y, step.y, beta, alpha1, round1) << 2 |
         wire_field(q.z, p1.z, step.z, beta, alpha1, round1) << 4 |
         wire_field(q.w, p1.w, step.w, beta, alpha1, round1) << 6;
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                     __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}

// The lowbias32 finalizer of the JAX package's privacy/masking.py::mix32.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The counter hashes of a counter stream over the four elements
// e0 .. e0 + 3 (e0 a multiple of 4) that one thread owns: mix32(e) per
// element at 32 bits; at 16 bits one hash per element pair, mix32(e >> 1),
// in h[0] and h[1] (h[2], h[3] unused). The flat element index of an
// (R, 512) view is r * 512 + c.
template <int kWordBits>
__device__ __forceinline__ void stream_hashes(uint32_t e0, uint32_t h[4]) {
  if constexpr (kWordBits == 16) {
    h[0] = mix32(e0 >> 1);
    h[1] = mix32((e0 >> 1) + 1u);
    h[2] = h[3] = 0u;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = mix32(e0 + j);
  }
}

// acc[j] += s * stream(key) at the four elements of stream_hashes, mod
// 2^32 (the caller truncates to the wire width). The stream word is
// mix32(h + key); at 16 bits one word feeds two elements, its low half
// the even one and its high half the odd one.
template <int kWordBits>
__device__ __forceinline__ void fold_stream(const uint32_t h[4], uint32_t key,
                                            uint32_t s, uint32_t acc[4]) {
  if constexpr (kWordBits == 16) {
    const uint32_t u0 = mix32(h[0] + key);
    const uint32_t u1 = mix32(h[1] + key);
    acc[0] += s * (u0 & 0xFFFFu);
    acc[1] += s * (u0 >> 16);
    acc[2] += s * (u1 & 0xFFFFu);
    acc[3] += s * (u1 >> 16);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += s * mix32(h[j] + key);
  }
}

// Four wire words at index `at` of a ushort4 (16-bit) or uint4 (32-bit)
// array, widened to uint32, and stored back truncated.
template <int kWordBits>
__device__ __forceinline__ void load_words(const void* words, int64_t at,
                                           uint32_t w[4]) {
  if constexpr (kWordBits == 16) {
    const ushort4 v = reinterpret_cast<const ushort4*>(words)[at];
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint4 v = reinterpret_cast<const uint4*>(words)[at];
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
}

template <int kWordBits>
__device__ __forceinline__ void store_words(void* words, int64_t at,
                                            const uint32_t w[4]) {
  if constexpr (kWordBits == 16) {
    reinterpret_cast<ushort4*>(words)[at] = make_ushort4(
        static_cast<uint16_t>(w[0]), static_cast<uint16_t>(w[1]),
        static_cast<uint16_t>(w[2]), static_cast<uint16_t>(w[3]));
  } else {
    reinterpret_cast<uint4*>(words)[at] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

inline unsigned blocks_for(int64_t m) {
  return static_cast<unsigned>((m + kThreads - 1) / kThreads);
}

// The launch plan of the tuned kernels (repro_torch/kernels/tune.py): a
// CTA of kThreads threads covers block_rows kernel-view rows of
// kRowPositions positions each (a float4 of every float operand, a byte
// of every packed one), its threads looping over them kThreads positions
// apart. block_rows = 2 is one position a thread, the one geometry of
// these kernels before plans. A ragged last CTA is guarded.
constexpr int kRowPositions = 128;

struct Span {
  int64_t begin, end;
};

__device__ __forceinline__ Span cta_span(int block_rows, int64_t m) {
  const int64_t per = static_cast<int64_t>(block_rows) * kRowPositions;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per;
  return {begin, begin + per < m ? begin + per : m};
}

inline unsigned blocks_for_rows(int64_t m, int block_rows) {
  const int64_t per = static_cast<int64_t>(block_rows) * kRowPositions;
  return static_cast<unsigned>((m + per - 1) / per);
}

inline unsigned blocks_of(int n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace wire
