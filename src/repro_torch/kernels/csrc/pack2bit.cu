// Hand-written Hopper (sm_90a) kernels of the §3.3 wire format alone: four
// int8 ternary codes to one byte and back.
//
// Pack reads an int8 (R, 512) view and writes a uint8 (R, 128) view; byte
// (r, lane) holds codes 4 * lane .. 4 * lane + 3 of row r, code j biased
// by one in bits 2j, 2j + 1. Unpack is the inverse. Thread i owns four
// consecutive bytes and their sixteen codes: a 16-byte load of codes and a
// 4-byte store of bytes, or the reverse, over m = R * 32 such groups.
//
// Bound: device-memory bytes. Five bytes moved per byte of wire against a
// few integer operations; neighbouring threads touch neighbouring
// addresses.
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
// so field 3 becomes code 2.
__device__ __forceinline__ uint32_t unpack_byte(uint32_t byte) {
  uint32_t codes = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    codes |= ((((byte >> (2 * j)) & 3u) - 1u) & 0xFFu) << (8 * j);
  }
  return codes;
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

// Replaces unpack2bit_2d (JAX package, kernels/pack2bit.py).
__global__ void __launch_bounds__(kThreads)
unpack2bit_kernel(const uint32_t* __restrict__ packed,
                  uint4* __restrict__ out, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const uint32_t b = packed[i];
  out[i] = make_uint4(unpack_byte(b & 0xFFu), unpack_byte((b >> 8) & 0xFFu),
                      unpack_byte((b >> 16) & 0xFFu), unpack_byte(b >> 24));
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
  unpack2bit_kernel<<<blocks_for(m), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<uint4*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

const char* pk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
