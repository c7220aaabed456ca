// Hand-written Hopper (sm_90a) kernel of the unfused master: Eq. (3) for
// t > 1 over every worker's int8 ternary codes.
//
// Replaces master_update_2d (JAX package, kernels/master_update.py), which
// reduces the (N, R, 128) codes with a tensordot over the worker axis.
// Here thread i owns four consecutive parameters: one float4 of q, p1 and
// p2, and one char4 of codes from each of the N workers, over m = R * 32
// such groups. Four register accumulators fold the workers strictly in
// order k = 0..N-1, acc + T_k * w_k with each product and sum rounded
// once, with no atomics and no split across blocks; the combine
// q - coeff * (p1 - p2) is one fused multiply-add. On the wire's codes
// {-1, 0, 1} every product T_k * w_k is exact, so the result has the bits
// of the fused packed master (fused_wire.cu) on the same codes. A code
// outside {-1, 0, 1} weighs as its integer value: T_k * w_k is rounded
// once, then added.
//
// Bound: device-memory bytes. Per group N * 4 bytes of codes and 64 bytes
// of float operands moved against 2N + 2 float operations.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/
// master_update.py): pointers and the stream arrive as void*, the function
// makes the tensors' device current, launches on the given stream, never
// synchronises, and returns the first CUDA error it meets, 0 if none.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wire_common.cuh"

namespace {

using wire::blocks_for;
using wire::kThreads;
using wire::sub4;

__global__ void __launch_bounds__(kThreads)
master_update_kernel(const float4* __restrict__ q,
                     const char4* __restrict__ tern,
                     const float* __restrict__ w,
                     const float4* __restrict__ p1,
                     const float4* __restrict__ p2, float4* __restrict__ out,
                     int n, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  for (int k = 0; k < n; ++k) {
    const char4 t = tern[static_cast<int64_t>(k) * m + i];
    const float wk = w[k];
    c0 = __fadd_rn(c0, __fmul_rn(static_cast<float>(t.x), wk));
    c1 = __fadd_rn(c1, __fmul_rn(static_cast<float>(t.y), wk));
    c2 = __fadd_rn(c2, __fmul_rn(static_cast<float>(t.z), wk));
    c3 = __fadd_rn(c3, __fmul_rn(static_cast<float>(t.w), wk));
  }
  const float4 step = sub4(p1[i], p2[i]);
  const float4 x = q[i];
  out[i] = make_float4(__fmaf_rn(-c0, step.x, x.x), __fmaf_rn(-c1, step.y, x.y),
                       __fmaf_rn(-c2, step.z, x.z), __fmaf_rn(-c3, step.w, x.w));
}

}  // namespace

extern "C" {

// q/p1/p2/out (m,) float4, tern (n, m) char4, w (n,) float.
int mu_master_update(const void* q, const void* tern, const void* w,
                     const void* p1, const void* p2, void* out, int n,
                     long long m, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  master_update_kernel<<<blocks_for(m), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const char4*>(tern),
      static_cast<const float*>(w), static_cast<const float4*>(p1),
      static_cast<const float4*>(p2), static_cast<float4*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

const char* mu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
