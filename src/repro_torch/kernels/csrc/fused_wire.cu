// Hand-written Hopper (sm_90a) kernels of the plain FedPC round.
//
// Both work on the kernel views of the flat (rows, 128) float32 buffer
// (repro_torch/core/flat.py): the (R, 512) float view, R = rows / 4, puts
// the four consecutive codes of one wire byte side by side, so output byte
// (r, lane) of the (R, 128) packed view reads exactly one float4 at float4
// index r * 128 + lane of every (R, 512) operand. Both index one flat
// range of m = R * 128 such float4s / bytes per worker.
//
// Bound: both kernels do a handful of float operations per 16 bytes they
// move (well under one operation per byte, against the ~20 the card can do
// in float32 per byte of device memory), so device-memory bytes bound them.
// Their designs read every byte they need once and write every output byte
// once, with 16-byte loads that neighbouring threads issue on neighbouring
// addresses, and keep codes and partial sums in registers only.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/fused_wire.py):
// every pointer and the stream arrive as void*, each function makes the
// tensors' device current (this library carries its own CUDA runtime),
// launches on the given stream, never synchronises, and returns the first
// CUDA error it meets, 0 if none.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wire_common.cuh"

namespace {

using wire::blocks_for;
using wire::kThreads;
using wire::sub4;
using wire::wire_field;

// Replaces ternary_pack_stacked_2d (JAX package, kernels/fused_wire.py).
// One thread per output byte (r, lane): it loads the shared history p1, p2
// once as float4s and then loops over the N workers, loading worker k's
// float4 of q and writing byte k of that lane. The history is read once
// per byte rather than once per (worker, byte), which is what the TPU
// kernel's rows-major, worker-minor grid bought. The round index t lives
// in device memory, so the caller never syncs to branch on it; at round
// <= 1 Eq. (4) needs no P^{t-2}, so p2 is not read.
__global__ void __launch_bounds__(kThreads)
ternary_pack_stacked_kernel(const float4* __restrict__ q,
                            const float4* __restrict__ p1,
                            const float4* __restrict__ p2,
                            const float* __restrict__ beta,
                            const int32_t* __restrict__ t, float alpha1,
                            uint8_t* __restrict__ out, int n, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const bool round1 = *t <= 1;
  const float4 a = p1[i];
  const float4 b = round1 ? a : p2[i];
  const float4 step = sub4(a, b);
  for (int k = 0; k < n; ++k) {
    const int64_t j = static_cast<int64_t>(k) * m + i;
    const float4 x = q[j];
    const float bk = beta[k];
    const uint32_t byte =
        wire_field(x.x, a.x, step.x, bk, alpha1, round1) |
        wire_field(x.y, a.y, step.y, bk, alpha1, round1) << 2 |
        wire_field(x.z, a.z, step.z, bk, alpha1, round1) << 4 |
        wire_field(x.w, a.w, step.w, bk, alpha1, round1) << 6;
    out[j] = static_cast<uint8_t>(byte);
  }
}

// w_k * (field - 1) folded into the running sum. field * w_k - w_k is one
// fused multiply-add, as XLA contracts it on the CPU: exact for the wire's
// fields {0, 1, 2}, and the reference's bits for the unused field 3 too.
__device__ __forceinline__ float fold(float acc, uint32_t field, float wk) {
  return __fadd_rn(acc, __fmaf_rn(static_cast<float>(field), wk, -wk));
}

// Replaces packed_master_update_2d (JAX package, kernels/fused_wire.py).
// One thread per packed byte lane: four outputs. A register accumulator
// per output folds the workers strictly in order k = 0..N-1, the order of
// the TPU kernel under every plan, with no atomics and no split across
// blocks, so the sum has the reference's bits. The Eq. (3) combine
// q - coeff * mult is one fused multiply-add, as XLA computes it on the
// CPU. At round <= 1 mult is alpha0 and the history is not read. The
// pilot's model is read in place from the stacked worker buffers at the
// device index k_star, so no copy of it is made; an index outside
// [0, n) yields NaN rather than a read out of bounds.
__global__ void __launch_bounds__(kThreads)
packed_master_update_kernel(const float4* __restrict__ q,
                            const int64_t* __restrict__ k_star,
                            const uint8_t* __restrict__ packed,
                            const float* __restrict__ w,
                            const float4* __restrict__ p1,
                            const float4* __restrict__ p2,
                            const int32_t* __restrict__ t, float alpha0,
                            float4* __restrict__ out, int n, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int64_t pilot = *k_star;
  if (pilot < 0 || pilot >= n) {
    const float nan = __int_as_float(0x7fc00000);
    out[i] = make_float4(nan, nan, nan, nan);
    return;
  }
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  for (int k = 0; k < n; ++k) {
    const uint32_t byte = packed[static_cast<int64_t>(k) * m + i];
    const float wk = w[k];
    c0 = fold(c0, byte & 3u, wk);
    c1 = fold(c1, (byte >> 2) & 3u, wk);
    c2 = fold(c2, (byte >> 4) & 3u, wk);
    c3 = fold(c3, (byte >> 6) & 3u, wk);
  }
  float4 mult = make_float4(alpha0, alpha0, alpha0, alpha0);
  if (*t > 1) {
    const float4 a = p1[i];
    const float4 b = p2[i];
    mult = sub4(a, b);
  }
  const float4 x = q[pilot * m + i];
  out[i] = make_float4(__fmaf_rn(-c0, mult.x, x.x), __fmaf_rn(-c1, mult.y, x.y),
                       __fmaf_rn(-c2, mult.z, x.z), __fmaf_rn(-c3, mult.w, x.w));
}

}  // namespace

extern "C" {

// q (n, m) float4, p1/p2 (m,) float4, beta (n,) float, t int32 scalar,
// out (n, m) uint8.
int fw_ternary_pack_stacked(const void* q, const void* p1, const void* p2,
                            const void* beta, const void* t, float alpha1,
                            void* out, int n, long long m, int device,
                            void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  ternary_pack_stacked_kernel<<<blocks_for(m), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(p1),
      static_cast<const float4*>(p2), static_cast<const float*>(beta),
      static_cast<const int32_t*>(t), alpha1, static_cast<uint8_t*>(out), n,
      m);
  return static_cast<int>(cudaGetLastError());
}

// q (n, m) float4, k_star int64 scalar, p1/p2/out (m,) float4, packed
// (n, m) uint8, w (n,) float, t int32 scalar.
int fw_packed_master_update(const void* q, const void* k_star,
                            const void* packed, const void* w, const void* p1,
                            const void* p2, const void* t, float alpha0,
                            void* out, int n, long long m, int device,
                            void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  packed_master_update_kernel<<<blocks_for(m), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const int64_t*>(k_star),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(w),
      static_cast<const float4*>(p1), static_cast<const float4*>(p2),
      static_cast<const int32_t*>(t), alpha0, static_cast<float4*>(out), n,
      m);
  return static_cast<int>(cudaGetLastError());
}

const char* fw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
