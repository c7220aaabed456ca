// Hand-written Hopper (sm_90a) kernels of the plain FedPC round: the
// batched uplink, the one-worker uplinks and the fused master.
//
// All work on the kernel views of the flat (rows, 128) float32 buffer
// (repro_torch/core/flat.py): the (R, 512) float view, R = rows / 4, puts
// the four consecutive codes of one wire byte side by side, so output byte
// (r, lane) of the (R, 128) packed view reads exactly one float4 at float4
// index r * 128 + lane of every (R, 512) operand. Each indexes one flat
// range of m = R * 128 such float4s / bytes per worker.
//
// Bound: the kernels do a handful of float operations per 16 bytes they
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
using wire::wire_byte;

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
    out[j] = static_cast<uint8_t>(
        wire_byte(q[j], a, step, beta[k], alpha1, round1));
  }
}

// The rule of a one-worker uplink.
enum Rule : int {
  kEq5 = 0,  // ternary_pack_2d: Eq. (5), a static round t >= 2
  kEq4 = 1,  // ternary_pack_round1_2d: Eq. (4), q and P^0 only
  kAny = 2,  // ternary_pack_any_2d: t, beta and alpha1 in device memory
};

// Replaces ternary_pack_2d, ternary_pack_round1_2d and ternary_pack_any_2d
// (JAX package, kernels/fused_wire.py): one worker's uplink, one thread per
// output byte, as the stacked kernel's loop body at N = 1. kEq5 and kEq4
// take their threshold by value; kEq4 has no P^{t-2} operand at all. kAny
// reads the round index, beta and alpha1 from device memory, so one launch
// serves every round of a device-side loop and the caller never syncs to
// branch on t; at t <= 1 it reads no p2 either. Bound, like the stacked
// kernel, by device-memory bytes: three (two) float4 loads per byte out.
template <Rule kRule>
__global__ void __launch_bounds__(kThreads)
ternary_pack_kernel(const float4* __restrict__ q,
                    const float4* __restrict__ p1,
                    const float4* __restrict__ p2,
                    const int32_t* __restrict__ t,
                    const float* __restrict__ beta_at,
                    const float* __restrict__ alpha1_at, float beta,
                    float alpha1, uint8_t* __restrict__ out, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  bool round1 = kRule == kEq4;
  if constexpr (kRule == kAny) {
    round1 = *t <= 1;
    beta = *beta_at;
    alpha1 = *alpha1_at;
  }
  const float4 a = p1[i];
  const float4 b = round1 ? a : p2[i];
  out[i] = static_cast<uint8_t>(
      wire_byte(q[i], a, sub4(a, b), beta, alpha1, round1));
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

// q/p1/p2 (m,) float4 (p2 unread for kEq4), out (m,) uint8; kAny reads
// t (int32), beta and alpha1 (float) from device memory, the other rules
// take beta and alpha1 by value.
int fw_ternary_pack(int rule, const void* q, const void* p1, const void* p2,
                    const void* t, const void* beta_at,
                    const void* alpha1_at, float beta, float alpha1,
                    void* out, long long m, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  void (*kernel)(const float4*, const float4*, const float4*, const int32_t*,
                 const float*, const float*, float, float, uint8_t*, int64_t);
  switch (rule) {
    case kEq5: kernel = ternary_pack_kernel<kEq5>; break;
    case kEq4: kernel = ternary_pack_kernel<kEq4>; break;
    case kAny: kernel = ternary_pack_kernel<kAny>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(p1),
      static_cast<const float4*>(p2), static_cast<const int32_t*>(t),
      static_cast<const float*>(beta_at), static_cast<const float*>(alpha1_at),
      beta, alpha1, static_cast<uint8_t*>(out), m);
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
