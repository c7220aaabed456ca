// Hand-written Hopper (sm_90a) kernels of hierarchical (tree) aggregation:
// each internal node of the fan-in tree folds its sibling group of at most
// `fanout` children into one partial of integer wire words, mod 2^WordBits,
// with no de-bias and no descale (the root's masked master does both, once).
//
// Both keep the view of the other wire kernels: thread i owns the flat
// elements e = 4i .. 4i+3 of the (R, 512) view, the same four words of
// every child and of its output node. m = R * 128 four-element groups per
// child.
//
// Launch plans (repro_torch/kernels/tune.py, wire_common.cuh): block_rows
// is the kernel-view rows a CTA of 256 threads covers (2: one position a
// thread, the default); block_groups the output nodes a CTA folds, one
// after another (grid.y = ceil(G / block_groups); the default 1, one node
// a CTA). The interior sum honours every such plan; the leaf sum only the
// default. Every plan gives the same bits. A ragged last group (the
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
using wire::blocks_for_rows;
using wire::blocks_of;
using wire::cta_span;
using wire::fold_stream;
using wire::kThreads;
using wire::load_words;
using wire::Span;
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
//
// It honours only the default plan (2 rows, one node a CTA): a loop over a
// longer span or over several nodes was slower at every plan tried (10
// leaves into 5, R = 41,016, on an H100 80GB HBM3 at 700 W), and ops snaps
// any other request to it.
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
//
// The default plan (2 rows, one node a CTA) runs the one-pass form, the
// code of before plans (kLoop false); any other plan the loop form, kept
// for the plan that beats the default (8 rows a CTA: 8.7% less time at
// fanout 2, 16 bits, R = 41,016, on an H100 80GB HBM3 at 700 W). Its
// children's loop is not unrolled: unrolled inside the two plan loops,
// ptxas held it to 32 registers and spilled 8 bytes (sm_90a, 32 bits,
// masks off).
template <bool kMasks>
__device__ __forceinline__ int stage_node(const uint32_t* __restrict__ keys,
                                          const int32_t* __restrict__ signs,
                                          int g, int g_total, int sibling,
                                          uint32_t* staged) {
  if constexpr (!kMasks) {
    return 0;
  } else {
    const int l0 = g / sibling * sibling;
    const int nl = min(l0 + sibling, g_total) - l0;
    const int64_t row = static_cast<int64_t>(g) * g_total + l0;
    for (int j = threadIdx.x; j < nl; j += kThreads) {
      staged[j] = keys[row + j];
      staged[sibling + j] = static_cast<uint32_t>(signs[row + j]);
    }
    __syncthreads();
    return nl;
  }
}

template <int kWordBits, bool kMasks, bool kRolled>
__device__ __forceinline__ void node_partial(const void* __restrict__ words,
                                             void* __restrict__ out,
                                             const uint32_t* staged, int c0,
                                             int c1, int g, int nl,
                                             int sibling, int64_t m,
                                             int64_t i) {
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  if constexpr (kRolled) {
#pragma unroll 1
    for (int k = c0; k < c1; ++k) {
      uint32_t w[4];
      load_words<kWordBits>(words, static_cast<int64_t>(k) * m + i, w);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += w[j];
    }
  } else {
    for (int k = c0; k < c1; ++k) {
      uint32_t w[4];
      load_words<kWordBits>(words, static_cast<int64_t>(k) * m + i, w);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += w[j];
    }
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

template <int kWordBits, bool kMasks, bool kLoop>
__global__ void __launch_bounds__(kThreads)
masked_partial_sum_kernel(const void* __restrict__ words,
                          const uint32_t* __restrict__ keys,
                          const int32_t* __restrict__ signs,
                          void* __restrict__ out, int c, int fanout,
                          int g_total, int sibling, int64_t m, int block_rows,
                          int block_groups) {
  extern __shared__ uint32_t staged[];     // keys, then signs: 2 * sibling
  if constexpr (!kLoop) {
    const int g = blockIdx.y;
    const int nl = stage_node<kMasks>(keys, signs, g, g_total, sibling,
                                      staged);
    const int64_t i =
        static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= m) return;
    const int c0 = g * fanout;
    node_partial<kWordBits, kMasks, false>(words, out, staged, c0,
                                           min(c0 + fanout, c), g, nl,
                                           sibling, m, i);
  } else {
    const Span span = cta_span(block_rows, m);
    const int g0 = static_cast<int>(blockIdx.y) * block_groups;
    const int g1 = min(g0 + block_groups, g_total);
    for (int g = g0; g < g1; ++g) {
      if (kMasks && g > g0) __syncthreads();   // the previous node's keys
      const int nl = stage_node<kMasks>(keys, signs, g, g_total, sibling,
                                        staged);
      const int c0 = g * fanout;
      const int c1 = min(c0 + fanout, c);
      for (int64_t i = span.begin + threadIdx.x; i < span.end;
           i += kThreads) {
        node_partial<kWordBits, kMasks, true>(words, out, staged, c0, c1, g,
                                              nl, sibling, m, i);
      }
    }
  }
}

template <int kWordBits, bool kMasks>
cudaError_t launch_masked(const void* words, const uint32_t* keys,
                          const int32_t* signs, void* out, int c, int fanout,
                          int g_total, int sibling, int64_t m,
                          int block_rows, int block_groups,
                          cudaStream_t stream) {
  const size_t staged =
      kMasks ? 2 * sizeof(uint32_t) * static_cast<size_t>(sibling) : 0;
  const auto kernel =
      block_rows == kThreads / wire::kRowPositions && block_groups == 1
          ? masked_partial_sum_kernel<kWordBits, kMasks, false>
          : masked_partial_sum_kernel<kWordBits, kMasks, true>;
  if (staged > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(staged));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(blocks_for_rows(m, block_rows),
                  blocks_of(g_total, block_groups));
  kernel<<<grid, kThreads, staged, stream>>>(words, keys, signs, out, c,
                                             fanout, g_total, sibling, m,
                                             block_rows, block_groups);
  return cudaGetLastError();
}

template <int kWordBits>
cudaError_t launch_masked_bits(const void* words, const uint32_t* keys,
                               const int32_t* signs, void* out, int c,
                               int fanout, int g_total, int sibling,
                               int64_t m, bool masks, int block_rows,
                               int block_groups, cudaStream_t stream) {
  return masks ? launch_masked<kWordBits, true>(words, keys, signs, out, c,
                                                fanout, g_total, sibling, m,
                                                block_rows, block_groups,
                                                stream)
               : launch_masked<kWordBits, false>(words, keys, signs, out, c,
                                                 fanout, g_total, sibling, m,
                                                 block_rows, block_groups,
                                                 stream);
}

}  // namespace

extern "C" {

// packed (c, m) uint8 (m = R * 128 byte lanes), wq (c,) uint32,
// out (ceil(c / fanout), m) ushort4 (word_bits 16) or uint4 (32);
// block_rows == 2, block_groups == 1 (the one plan it honours).
int ps_partial_sum(const void* packed, const void* wq, int word_bits,
                   void* out, int c, int fanout, long long m, int block_rows,
                   int block_groups, int device, void* stream) {
  const int g = (c + fanout - 1) / fanout;
  if (block_rows != kThreads / wire::kRowPositions || block_groups != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* w = static_cast<const uint32_t*>(wq);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(m), static_cast<unsigned>(g));
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
// (or g < 2) folds the children only; block_rows >= 1,
// 1 <= block_groups <= g.
int ps_masked_partial_sum(const void* words, const void* keys,
                          const void* signs, int word_bits, int use_masks,
                          void* out, int c, int fanout, int sibling,
                          long long m, int block_rows, int block_groups,
                          int device, void* stream) {
  const int g = (c + fanout - 1) / fanout;
  if (block_rows < 1 || block_groups < 1 || block_groups > g) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const bool masks = use_masks != 0 && g >= 2;
  const auto* kk = static_cast<const uint32_t*>(keys);
  const auto* ss = static_cast<const int32_t*>(signs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (word_bits == 16) {
    err = launch_masked_bits<16>(words, kk, ss, out, c, fanout, g, sibling,
                                 m, masks, block_rows, block_groups, s);
  } else if (word_bits == 32) {
    err = launch_masked_bits<32>(words, kk, ss, out, c, fanout, g, sibling,
                                 m, masks, block_rows, block_groups, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* ps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
