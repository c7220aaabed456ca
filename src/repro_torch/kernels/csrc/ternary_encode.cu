// Hand-written Hopper (sm_90a) kernels of the unfused uplink's first half:
// one worker's Eq. (5) (or Eq. (4)) ternary codes as int8, one code per
// parameter, before any packing.
//
// They work on (R, 128) views of flat float32 operands and write an int8
// (R, 128) view: thread i owns the four consecutive elements 4i .. 4i+3,
// one float4 of each operand in and one char4 of codes out, over
// m = R * 32 such groups. The codes are the biased wire fields of the
// packed uplinks less one, from the same field function
// (wire_common.cuh::wire_field), so the packed bytes of the two-kernel
// composition equal the fused uplink's bit for bit.
//
// Bound: device-memory bytes. A few float operations per 13 (9) bytes
// moved; 16-byte loads and 4-byte stores from neighbouring threads on
// neighbouring addresses, codes in registers only.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/
// ternary_encode.py): pointers and the stream arrive as void*, each function
// makes the tensors' device current, launches on the given stream, never
// synchronises, and returns the first CUDA error it meets, 0 if none.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wire_common.cuh"

namespace {

using wire::blocks_for;
using wire::kThreads;
using wire::sub4;
using wire::wire_field;

__device__ __forceinline__ signed char code(float q, float p1, float step,
                                            float beta, float alpha,
                                            bool round1) {
  return static_cast<signed char>(
      static_cast<int>(wire_field(q, p1, step, beta, alpha, round1)) - 1);
}

// Replaces ternary_encode_2d (kRound1 false: Eq. (5) with beta against
// the history p1, p2) and ternary_encode_round1_2d (kRound1 true: Eq. (4)
// with alpha against P^0 in p1; p2 is not an operand) of the JAX
// package's kernels/ternary_encode.py.
template <bool kRound1>
__global__ void __launch_bounds__(kThreads)
ternary_encode_kernel(const float4* __restrict__ q,
                      const float4* __restrict__ p1,
                      const float4* __restrict__ p2, float beta, float alpha,
                      char4* __restrict__ out, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const float4 x = q[i];
  const float4 a = p1[i];
  const float4 s = kRound1 ? make_float4(0.f, 0.f, 0.f, 0.f) : sub4(a, p2[i]);
  out[i] = make_char4(code(x.x, a.x, s.x, beta, alpha, kRound1),
                      code(x.y, a.y, s.y, beta, alpha, kRound1),
                      code(x.z, a.z, s.z, beta, alpha, kRound1),
                      code(x.w, a.w, s.w, beta, alpha, kRound1));
}

}  // namespace

extern "C" {

// q/p1/p2 (m,) float4 (p2 unread at round1), out (m,) char4.
int te_ternary_encode(int round1, const void* q, const void* p1,
                      const void* p2, float beta, float alpha, void* out,
                      long long m, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  auto kernel = round1 ? ternary_encode_kernel<true>
                       : ternary_encode_kernel<false>;
  kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(p1),
      static_cast<const float4*>(p2), beta, alpha, static_cast<char4*>(out),
      m);
  return static_cast<int>(cudaGetLastError());
}

const char* te_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
