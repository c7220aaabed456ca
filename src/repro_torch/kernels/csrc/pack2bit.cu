// Hand-written Hopper (sm_90a) kernels of the §3.3 wire format alone: four
// int8 ternary codes to one byte and back.
//
// Pack reads an int8 (R, 512) view and writes a uint8 (R, 128) view; byte
// (r, lane) holds codes 4 * lane .. 4 * lane + 3 of row r, code j biased
// by one in bits 2j, 2j + 1. Unpack is the inverse. Over m = R * 32 groups
// of four bytes and their sixteen codes: a pack thread owns one group (a
// 16-byte load of codes, a 4-byte store of bytes); an unpack thread owns
// four, a block's width apart (four 4-byte loads, all in flight before
// the first of four 16-byte stores), so every load and store of a warp
// is one contiguous run.
//
// Bound: device-memory bytes. Five bytes moved per byte of wire against a
// few integer operations. Unpack writes four of its five bytes, and its
// time sits near that of writing its output alone (chip_smoke.py times a
// PyTorch fill_ of the codes beside it). A first form with one 16-byte
// load and four 16-byte stores a thread, each store spread over 2 KB a
// warp, took 0.0264 ms where one group a thread took 0.0174 (R =
// 41,016 rows, on an H100 80GB HBM3 at 700 W).
//
// Plain C interface, bound with ctypes (repro_torch/kernels/pack2bit.py):
// pointers and the stream arrive as void*, each function makes the
// tensors' device current, launches on the given stream, never
// synchronises, and returns the first CUDA error it meets, 0 if none.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wire_common.cuh"

namespace {

using wire::blocks_for;
using wire::kThreads;

// One byte from the four int8 codes of a little-endian word: the JAX
// kernel's int32 sum of (code + 1) * 4^j truncated to 8 bits, which is
// what XLA's int32 -> uint8 conversion does. Any int8 code is taken; a
// code outside {-1, 0, 1, 2} carries into the higher fields, as there.
__device__ __forceinline__ uint32_t pack_word(uint32_t codes) {
  int32_t sum = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int32_t c = static_cast<int8_t>((codes >> (8 * j)) & 0xFFu);
    sum += (c + 1) * (1 << (2 * j));
  }
  return static_cast<uint32_t>(sum) & 0xFFu;
}

// The four codes of one byte as a little-endian word of int8: field - 1,
// so field 3 becomes code 2. The spread puts field j in bits 8j, 8j + 1
// (the shifted copies overlap only in bits the mask drops); adding 0x7F to
// a byte of 0..3 stays below 0x100, so no carry crosses bytes, and the
// xor with 0x80 leaves field - 1 in two's complement.
__device__ __forceinline__ uint32_t unpack_byte(uint32_t byte) {
  const uint32_t t = (byte | byte << 6 | byte << 12 | byte << 18) &
                     0x03030303u;
  return (t + 0x7F7F7F7Fu) ^ 0x80808080u;
}

// The sixteen codes of four packed bytes.
__device__ __forceinline__ uint4 unpack_word(uint32_t b) {
  return make_uint4(unpack_byte(b & 0xFFu), unpack_byte((b >> 8) & 0xFFu),
                    unpack_byte((b >> 16) & 0xFFu), unpack_byte(b >> 24));
}

// Replaces pack2bit_2d (JAX package, kernels/pack2bit.py).
__global__ void __launch_bounds__(kThreads)
pack2bit_kernel(const uint4* __restrict__ codes, uint32_t* __restrict__ out,
                int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const uint4 c = codes[i];
  out[i] = pack_word(c.x) | pack_word(c.y) << 8 | pack_word(c.z) << 16 |
           pack_word(c.w) << 24;
}

// Replaces unpack2bit_2d (JAX package, kernels/pack2bit.py). Block b owns
// groups 4 * kThreads * b onwards, thread j of it the groups j, j +
// kThreads, j + 2 * kThreads and j + 3 * kThreads from there; any m.
__global__ void __launch_bounds__(kThreads)
unpack2bit_kernel(const uint32_t* __restrict__ packed,
                  uint4* __restrict__ out, int64_t m) {
  constexpr int kGroups = 4;
  const int64_t g0 =
      static_cast<int64_t>(blockIdx.x) * kGroups * kThreads + threadIdx.x;
  uint32_t b[kGroups];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int64_t g = g0 + j * kThreads;
    b[j] = g < m ? packed[g] : 0u;
  }
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int64_t g = g0 + j * kThreads;
    if (g < m) out[g] = unpack_word(b[j]);
  }
}

}  // namespace

extern "C" {

// codes (m,) 16-byte groups of int8, out (m,) 4-byte groups of uint8.
int pk_pack2bit(const void* codes, void* out, long long m, int device,
                void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  pack2bit_kernel<<<blocks_for(m), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(codes), static_cast<uint32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

// packed (m,) 4-byte groups of uint8, out (m,) 16-byte groups of int8.
int pk_unpack2bit(const void* packed, void* out, long long m, int device,
                  void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  unpack2bit_kernel<<<blocks_for((m + 3) / 4), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<uint4*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

const char* pk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
