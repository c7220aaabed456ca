// Hand-written Hopper (sm_90a) kernels of hierarchical (tree) aggregation:
// each internal node of the fan-in tree folds its sibling group of at most
// `fanout` children into one partial of integer wire words, mod 2^WordBits,
// with no de-bias and no descale (the root's masked master does both, once).
//
// Both keep the view of the other wire kernels: thread i owns the flat
// elements e = 4i .. 4i+3 of the (R, 512) view, the same four words of
// every child and of its output node; blockIdx.y is the output node g.
// m = R * 128 four-element groups per child. A ragged last group (the
// child count C not a multiple of fanout) folds only the children that
// exist, which gives the bits of the JAX wrapper's zero padding.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/partial_sum.py):
// pointers and the stream arrive as void*, each function makes the
// tensors' device current, launches on the given stream, never
// synchronises, and returns the first CUDA error it meets, 0 if none.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wire_common.cuh"

namespace {

using wire::blocks_for;
using wire::fold_stream;
using wire::kThreads;
using wire::load_words;
using wire::store_words;
using wire::stream_hashes;

// Replaces partial_sum_2d (JAX package, kernels/partial_sum.py), the leaf
// level of the plain tree. Per output node g and element: the packed
// §3.3 byte of each child c of g (lane i holds elements 4i .. 4i+3 in its
// bit pairs 0-1 .. 6-7) is decoded to the biased fields {0, 1, 2}, each
// weighted by the public fixed-point W_c in uint32 and summed. At 16 bits
// the truncated uint32 product is congruent to the JAX kernel's uint16 one.
//
// Bound: bytes. One byte a child and 8 or 16 bytes out a thread, against
// a dozen integer operations a child; the bytes are read one a thread, as
// the plain master reads them (neighbouring threads, neighbouring bytes).
template <int kWordBits>
__global__ void __launch_bounds__(kThreads)
partial_sum_kernel(const uint8_t* __restrict__ packed,
                   const uint32_t* __restrict__ wq, void* __restrict__ out,
                   int c, int fanout, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int g = blockIdx.y;
  const int c0 = g * fanout;
  const int c1 = min(c0 + fanout, c);
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  for (int k = c0; k < c1; ++k) {
    const uint32_t b = packed[static_cast<int64_t>(k) * m + i];
    const uint32_t w = wq[k];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += w * ((b >> (2 * j)) & 3u);
  }
  store_words<kWordBits>(out, static_cast<int64_t>(g) * m + i, acc);
}

// Replaces masked_partial_sum_2d (JAX package, kernels/partial_sum.py), an
// interior level. Per output node g and element: its children's words
// summed mod 2^WordBits (their sibling-scoped masks cancel in the sum),
// plus, with kMasks, g's own net mask sum_l signs[g, l] * stream(keys[g, l])
// over l in g's sibling group [g / sibling * sibling, + sibling) only:
// the scoped sign matrix is zero across groups, and the JAX kernel skips
// those pairs statically. The stream geometry is the masked uplink's
// (fold_stream), keyed by the level's own keys. The block stages g's row
// of the group's keys and signs in shared memory.
//
// Bound: bytes while few masks are live (one 8- or 16-byte load a child
// and one store a thread), integer operations beyond a few live pairs (an
// add and a mix32 a stream word and pair).
template <int kWordBits, bool kMasks>
__global__ void __launch_bounds__(kThreads)
masked_partial_sum_kernel(const void* __restrict__ words,
                          const uint32_t* __restrict__ keys,
                          const int32_t* __restrict__ signs,
                          void* __restrict__ out, int c, int fanout,
                          int g_total, int sibling, int64_t m) {
  extern __shared__ uint32_t staged[];     // keys, then signs: 2 * sibling
  const int g = blockIdx.y;
  int l0 = 0, nl = 0;
  if constexpr (kMasks) {
    l0 = g / sibling * sibling;
    nl = min(l0 + sibling, g_total) - l0;
    const int64_t row = static_cast<int64_t>(g) * g_total + l0;
    for (int j = threadIdx.x; j < nl; j += kThreads) {
      staged[j] = keys[row + j];
      staged[sibling + j] = static_cast<uint32_t>(signs[row + j]);
    }
    __syncthreads();
  }
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int c0 = g * fanout;
  const int c1 = min(c0 + fanout, c);
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  for (int k = c0; k < c1; ++k) {
    uint32_t w[4];
    load_words<kWordBits>(words, static_cast<int64_t>(k) * m + i, w);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += w[j];
  }
  if constexpr (kMasks) {
    uint32_t h[4];
    stream_hashes<kWordBits>(static_cast<uint32_t>(i) * 4u, h);
    for (int j = 0; j < nl; ++j) {
      const uint32_t s = staged[sibling + j];
      if (s == 0u) continue;
      fold_stream<kWordBits>(h, staged[j], s, acc);
    }
  }
  store_words<kWordBits>(out, static_cast<int64_t>(g) * m + i, acc);
}

template <int kWordBits, bool kMasks>
cudaError_t launch_masked(const void* words, const uint32_t* keys,
                          const int32_t* signs, void* out, int c, int fanout,
                          int g_total, int sibling, int64_t m,
                          cudaStream_t stream) {
  const size_t staged =
      kMasks ? 2 * sizeof(uint32_t) * static_cast<size_t>(sibling) : 0;
  if (staged > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_partial_sum_kernel<kWordBits, kMasks>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(staged));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(blocks_for(m), static_cast<unsigned>(g_total));
  masked_partial_sum_kernel<kWordBits, kMasks>
      <<<grid, kThreads, staged, stream>>>(words, keys, signs, out, c, fanout,
                                          g_total, sibling, m);
  return cudaGetLastError();
}

template <int kWordBits>
cudaError_t launch_masked_bits(const void* words, const uint32_t* keys,
                               const int32_t* signs, void* out, int c,
                               int fanout, int g_total, int sibling,
                               int64_t m, bool masks, cudaStream_t stream) {
  return masks ? launch_masked<kWordBits, true>(words, keys, signs, out, c,
                                                fanout, g_total, sibling, m,
                                                stream)
               : launch_masked<kWordBits, false>(words, keys, signs, out, c,
                                                 fanout, g_total, sibling, m,
                                                 stream);
}

}  // namespace

extern "C" {

// packed (c, m) uint8 (m = R * 128 byte lanes), wq (c,) uint32,
// out (ceil(c / fanout), m) ushort4 (word_bits 16) or uint4 (32).
int ps_partial_sum(const void* packed, const void* wq, int word_bits,
                   void* out, int c, int fanout, long long m, int device,
                   void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* w = static_cast<const uint32_t*>(wq);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(m),
                  static_cast<unsigned>((c + fanout - 1) / fanout));
  if (word_bits == 16) {
    partial_sum_kernel<16><<<grid, kThreads, 0, s>>>(pk, w, out, c, fanout,
                                                     m);
  } else if (word_bits == 32) {
    partial_sum_kernel<32><<<grid, kThreads, 0, s>>>(pk, w, out, c, fanout,
                                                     m);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// words (c, m) ushort4 / uint4, keys (g, g) uint32, signs (g, g) int32
// with g = ceil(c / fanout), out (g, m) in the words' type. use_masks = 0
// (or g < 2) folds the children only.
int ps_masked_partial_sum(const void* words, const void* keys,
                          const void* signs, int word_bits, int use_masks,
                          void* out, int c, int fanout, int sibling,
                          long long m, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int g = (c + fanout - 1) / fanout;
  const bool masks = use_masks != 0 && g >= 2;
  const auto* kk = static_cast<const uint32_t*>(keys);
  const auto* ss = static_cast<const int32_t*>(signs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (word_bits == 16) {
    err = launch_masked_bits<16>(words, kk, ss, out, c, fanout, g, sibling,
                                 m, masks, s);
  } else if (word_bits == 32) {
    err = launch_masked_bits<32>(words, kk, ss, out, c, fanout, g, sibling,
                                 m, masks, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* ps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
