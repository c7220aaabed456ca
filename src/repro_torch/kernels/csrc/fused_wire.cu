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
// Launch plans (repro_torch/kernels/tune.py, wire_common.cuh): every
// kernel here takes block_rows, the kernel-view rows a CTA of 256 threads
// covers (2: one position a thread, the default). The batched uplink
// takes block_workers, the workers a CTA handles (grid.y = ceil(n /
// block_workers); each worker block reads p1/p2 again; the default is all
// n); the master takes block_workers as the workers whose bytes a thread
// loads ahead of each step of its fold (1, 2, 4 or 8; the default 1), the
// fold order staying k = 0..n-1. Every plan gives the same bits.
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

using wire::blocks_for_rows;
using wire::blocks_of;
using wire::cta_span;
using wire::kThreads;
using wire::Span;
using wire::sub4;
using wire::wire_byte;

// Replaces ternary_pack_stacked_2d (JAX package, kernels/fused_wire.py).
// A thread per output byte (r, lane) of its span: it loads the shared
// history p1, p2 once as float4s and then loops over the workers of its
// CTA's worker block, loading worker k's float4 of q and writing byte k of
// that lane. Under the default plan (all n workers a CTA) the history is
// read once per byte rather than once per (worker, byte), which is what
// the TPU kernel's rows-major, worker-minor grid bought; smaller worker
// blocks trade those re-reads for more CTAs in flight. The round index t lives
// in device memory, so the caller never syncs to branch on it; at round
// <= 1 Eq. (4) needs no P^{t-2}, so p2 is not read.
__global__ void __launch_bounds__(kThreads)
ternary_pack_stacked_kernel(const float4* __restrict__ q,
                            const float4* __restrict__ p1,
                            const float4* __restrict__ p2,
                            const float* __restrict__ beta,
                            const int32_t* __restrict__ t, float alpha1,
                            uint8_t* __restrict__ out, int n, int64_t m,
                            int block_rows, int block_workers) {
  const Span span = cta_span(block_rows, m);
  const int k0 = static_cast<int>(blockIdx.y) * block_workers;
  const int k1 = min(k0 + block_workers, n);
  const bool round1 = *t <= 1;
  for (int64_t i = span.begin + threadIdx.x; i < span.end; i += kThreads) {
    const float4 a = p1[i];
    const float4 b = round1 ? a : p2[i];
    const float4 step = sub4(a, b);
    for (int k = k0; k < k1; ++k) {
      const int64_t j = static_cast<int64_t>(k) * m + i;
      out[j] = static_cast<uint8_t>(
          wire_byte(q[j], a, step, beta[k], alpha1, round1));
    }
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
                    float alpha1, uint8_t* __restrict__ out, int64_t m,
                    int block_rows) {
  const Span span = cta_span(block_rows, m);
  bool round1 = kRule == kEq4;
  if constexpr (kRule == kAny) {
    round1 = *t <= 1;
    beta = *beta_at;
    alpha1 = *alpha1_at;
  }
  for (int64_t i = span.begin + threadIdx.x; i < span.end; i += kThreads) {
    const float4 a = p1[i];
    const float4 b = round1 ? a : p2[i];
    out[i] = static_cast<uint8_t>(
        wire_byte(q[i], a, sub4(a, b), beta, alpha1, round1));
  }
}

// w_k * (field - 1) folded into the running sum. field * w_k - w_k is one
// fused multiply-add, as XLA contracts it on the CPU: exact for the wire's
// fields {0, 1, 2}, and the reference's bits for the unused field 3 too.
__device__ __forceinline__ float fold(float acc, uint32_t field, float wk) {
  return __fadd_rn(acc, __fmaf_rn(static_cast<float>(field), wk, -wk));
}

// Replaces packed_master_update_2d (JAX package, kernels/fused_wire.py).
// A thread per packed byte lane of its span: four outputs. A register
// accumulator per output folds the workers strictly in order k = 0..N-1,
// the order of the TPU kernel under every plan, with no atomics and no
// split across blocks, so the sum has the reference's bits; kAhead
// workers' bytes are loaded before each step of the fold. The Eq. (3) combine
// q - coeff * mult is one fused multiply-add, as XLA computes it on the
// CPU. At round <= 1 mult is alpha0 and the history is not read. The
// pilot's model is read in place from a stack of nq float buffers at the
// device index k_star, so no copy of it is made: the N workers' own
// stack in one process (nq = n), or the one pilot buffer a mesh rank
// received over the fed axis (nq = 1). An index outside [0, nq) yields
// NaN rather than a read out of bounds.
template <int kAhead>
__global__ void __launch_bounds__(kThreads)
packed_master_update_kernel(const float4* __restrict__ q,
                            const int64_t* __restrict__ k_star,
                            const uint8_t* __restrict__ packed,
                            const float* __restrict__ w,
                            const float4* __restrict__ p1,
                            const float4* __restrict__ p2,
                            const int32_t* __restrict__ t, float alpha0,
                            float4* __restrict__ out, int n, int nq,
                            int64_t m, int block_rows) {
  const Span span = cta_span(block_rows, m);
  const int64_t pilot = *k_star;
  for (int64_t i = span.begin + threadIdx.x; i < span.end; i += kThreads) {
    if (pilot < 0 || pilot >= nq) {
      const float nan = __int_as_float(0x7fc00000);
      out[i] = make_float4(nan, nan, nan, nan);
      continue;
    }
    float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
    for (int k0 = 0; k0 < n; k0 += kAhead) {
      // kAhead workers' bytes requested before the first is folded.
      uint32_t bytes[kAhead];
      float ws[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (kAhead == 1 || k0 + j < n) {
          bytes[j] = packed[static_cast<int64_t>(k0 + j) * m + i];
          ws[j] = w[k0 + j];
        }
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (kAhead == 1 || k0 + j < n) {
          c0 = fold(c0, bytes[j] & 3u, ws[j]);
          c1 = fold(c1, (bytes[j] >> 2) & 3u, ws[j]);
          c2 = fold(c2, (bytes[j] >> 4) & 3u, ws[j]);
          c3 = fold(c3, (bytes[j] >> 6) & 3u, ws[j]);
        }
      }
    }
    float4 mult = make_float4(alpha0, alpha0, alpha0, alpha0);
    if (*t > 1) {
      const float4 a = p1[i];
      const float4 b = p2[i];
      mult = sub4(a, b);
    }
    const float4 x = q[pilot * m + i];
    out[i] = make_float4(__fmaf_rn(-c0, mult.x, x.x),
                         __fmaf_rn(-c1, mult.y, x.y),
                         __fmaf_rn(-c2, mult.z, x.z),
                         __fmaf_rn(-c3, mult.w, x.w));
  }
}

}  // namespace

extern "C" {

// q (n, m) float4, p1/p2 (m,) float4, beta (n,) float, t int32 scalar,
// out (n, m) uint8; block_rows >= 1, 1 <= block_workers <= n.
int fw_ternary_pack_stacked(const void* q, const void* p1, const void* p2,
                            const void* beta, const void* t, float alpha1,
                            void* out, int n, long long m, int block_rows,
                            int block_workers, int device, void* stream) {
  if (block_rows < 1 || block_workers < 1 || block_workers > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(blocks_for_rows(m, block_rows),
                  blocks_of(n, block_workers));
  ternary_pack_stacked_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(p1),
      static_cast<const float4*>(p2), static_cast<const float*>(beta),
      static_cast<const int32_t*>(t), alpha1, static_cast<uint8_t*>(out), n,
      m, block_rows, block_workers);
  return static_cast<int>(cudaGetLastError());
}

// q/p1/p2 (m,) float4 (p2 unread for kEq4), out (m,) uint8; kAny reads
// t (int32), beta and alpha1 (float) from device memory, the other rules
// take beta and alpha1 by value; block_rows >= 1.
int fw_ternary_pack(int rule, const void* q, const void* p1, const void* p2,
                    const void* t, const void* beta_at,
                    const void* alpha1_at, float beta, float alpha1,
                    void* out, long long m, int block_rows, int device,
                    void* stream) {
  if (block_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  void (*kernel)(const float4*, const float4*, const float4*, const int32_t*,
                 const float*, const float*, float, float, uint8_t*, int64_t,
                 int);
  switch (rule) {
    case kEq5: kernel = ternary_pack_kernel<kEq5>; break;
    case kEq4: kernel = ternary_pack_kernel<kEq4>; break;
    case kAny: kernel = ternary_pack_kernel<kAny>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<blocks_for_rows(m, block_rows), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(p1),
      static_cast<const float4*>(p2), static_cast<const int32_t*>(t),
      static_cast<const float*>(beta_at), static_cast<const float*>(alpha1_at),
      beta, alpha1, static_cast<uint8_t*>(out), m, block_rows);
  return static_cast<int>(cudaGetLastError());
}

// q (nq, m) float4, k_star int64 scalar, p1/p2/out (m,) float4, packed
// (n, m) uint8, w (n,) float, t int32 scalar; block_rows >= 1,
// block_workers (the bytes loaded ahead) 1, 2, 4 or 8.
int fw_packed_master_update(const void* q, const void* k_star,
                            const void* packed, const void* w, const void* p1,
                            const void* p2, const void* t, float alpha0,
                            void* out, int n, int nq, long long m,
                            int block_rows, int block_workers, int device,
                            void* stream) {
  void (*kernel)(const float4*, const int64_t*, const uint8_t*, const float*,
                 const float4*, const float4*, const int32_t*, float, float4*,
                 int, int, int64_t, int);
  switch (block_workers) {
    case 1: kernel = packed_master_update_kernel<1>; break;
    case 2: kernel = packed_master_update_kernel<2>; break;
    case 4: kernel = packed_master_update_kernel<4>; break;
    case 8: kernel = packed_master_update_kernel<8>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (block_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<blocks_for_rows(m, block_rows), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const int64_t*>(k_star),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(w),
      static_cast<const float4*>(p1), static_cast<const float4*>(p2),
      static_cast<const int32_t*>(t), alpha0, static_cast<float4*>(out), n,
      nq, m, block_rows);
  return static_cast<int>(cudaGetLastError());
}

const char* fw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
