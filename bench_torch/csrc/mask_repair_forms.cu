// Two other forms of the dropout repair kernel (#8), kept to be timed
// beside the one the port ships (src/repro_torch/kernels/csrc/
// masked_wire.cu, mask_repair_kernel) by bench_torch/mask_repair.py.
// Neither is called by the port.
//
// - pr15_mask_repair_kernel: the kernel the port shipped before, as it
//   was: one thread per four words (one 8-byte load at 16 bits), a block
//   per 256 of them, each block staging all P pairs before its loads, and
//   every thread walking all P pairs to skip those with coefficient 0.
// - bulk_mask_repair_kernel: the shipped kernel's arithmetic and pair
//   compaction fed by cp.async.bulk copies into a ring of kStages tiles of
//   shared memory, one mbarrier a stage, in a persistent grid: thread 0
//   keeps kStages tiles of 16 KB in flight, the block computes from shared
//   memory and stores straight to device memory.
//
// Same plain C interface as csrc/*.cu: returns the first CUDA error, 0 if
// none. Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -shared -Xcompiler -fPIC -I src/repro_torch/kernels/csrc.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wire_common.cuh"

namespace {

using wire::blocks_for;
using wire::fold_stream;
using wire::kThreads;
using wire::load_words;
using wire::mix32;
using wire::store_words;
using wire::stream_hashes;

// -- the kernel of the port before this form (verbatim) ----------------------

template <int kWordBits>
__global__ void __launch_bounds__(kThreads)
pr15_mask_repair_kernel(const void* __restrict__ y,
                        const uint32_t* __restrict__ keys,
                        const int32_t* __restrict__ coeff,
                        void* __restrict__ out, int n_pairs, int64_t m) {
  extern __shared__ uint32_t staged[];     // keys, then coefficients
  int32_t* s_coeff = reinterpret_cast<int32_t*>(staged + n_pairs);
  for (int j = threadIdx.x; j < n_pairs; j += kThreads) {
    staged[j] = keys[j];
    s_coeff[j] = coeff[j];
  }
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  uint32_t acc[4];
  load_words<kWordBits>(y, i, acc);
  uint32_t h[4];
  stream_hashes<kWordBits>(static_cast<uint32_t>(i) * 4u, h);
  for (int p = 0; p < n_pairs; ++p) {
    const int32_t cp = s_coeff[p];
    if (cp == 0) continue;
    fold_stream<kWordBits>(h, staged[p], static_cast<uint32_t>(cp), acc);
  }
  store_words<kWordBits>(out, i, acc);
}

template <int kWordBits>
cudaError_t launch_pr15(const void* y, const uint32_t* keys,
                        const int32_t* coeff, void* out, int n_pairs,
                        int64_t m, cudaStream_t stream) {
  const size_t staged = 2 * sizeof(uint32_t) * static_cast<size_t>(n_pairs);
  if (staged > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pr15_mask_repair_kernel<kWordBits>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(staged));
    if (err != cudaSuccess) return err;
  }
  pr15_mask_repair_kernel<kWordBits>
      <<<blocks_for(m), kThreads, staged, stream>>>(y, keys, coeff, out,
                                                    n_pairs, m);
  return cudaGetLastError();
}

// -- the bulk-copy form ------------------------------------------------------

constexpr int kChunks = 4;                        // 16-byte chunks a thread
constexpr int kSpan = kThreads * kChunks;         // chunks a tile
constexpr int kStages = 4;
constexpr size_t kTileBytes = static_cast<size_t>(kSpan) * 16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Spin on a stage's barrier; trap (a launch error, not a hang) if the
// copy never lands.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 22)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Thread 0: tile `tile` of y into stage `stage`, completing on its barrier.
__device__ __forceinline__ void issue_tile(const uint4* y, int64_t tile,
                                           int64_t n_chunks, uint4* ring,
                                           uint64_t* bars, int stage) {
  const int64_t first = tile * kSpan;
  const int64_t left = n_chunks - first;
  const uint32_t bytes =
      static_cast<uint32_t>((left < kSpan ? left : kSpan) * 16);
  const uint32_t bar = smem_addr(bars + stage);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(ring + static_cast<size_t>(stage) * kSpan)),
         "l"(y + first), "r"(bytes), "r"(bar)
      : "memory");
}

template <int kWordBits>
__global__ void __launch_bounds__(kThreads)
bulk_mask_repair_kernel(const uint4* __restrict__ y,
                        const uint32_t* __restrict__ keys,
                        const int32_t* __restrict__ coeff,
                        uint4* __restrict__ out, int n_pairs,
                        int64_t n_chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  uint2* live = reinterpret_cast<uint2*>(smem + kStages * kTileBytes);
  __shared__ __align__(8) uint64_t bars[kStages];
  const int64_t n_tiles = (n_chunks + kSpan - 1) / kSpan;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(bars + s)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      const int64_t tile = blockIdx.x + static_cast<int64_t>(s) * gridDim.x;
      if (tile < n_tiles) issue_tile(y, tile, n_chunks, ring, bars, s);
    }
  }
  if (threadIdx.x < 32) {                          // compact the live pairs
    const int lane = threadIdx.x;
    int n_live = 0;
    for (int p0 = 0; p0 < n_pairs; p0 += 32) {
      const int p = p0 + lane;
      const int32_t cp = p < n_pairs ? coeff[p] : 0;
      const unsigned hit = __ballot_sync(0xFFFFFFFFu, cp != 0);
      if (cp != 0) {
        live[n_live + __popc(hit & ((1u << lane) - 1u))] =
            make_uint2(keys[p], static_cast<uint32_t>(cp));
      }
      n_live += __popc(hit);
    }
    if (lane == 0 && n_live < n_pairs) {
      live[n_pairs - 1] = make_uint2(static_cast<uint32_t>(n_live), 0u);
    }
  }
  __syncthreads();
  int n_live = n_pairs;
  if (n_pairs > 0 && live[n_pairs - 1].y == 0u) {
    n_live = static_cast<int>(live[n_pairs - 1].x);
  }
  for (int64_t it = 0;; ++it) {
    const int64_t tile = blockIdx.x + it * gridDim.x;
    if (tile >= n_tiles) break;
    const int stage = static_cast<int>(it % kStages);
    bar_wait(smem_addr(bars + stage),
             static_cast<uint32_t>(it / kStages) & 1u);
    uint32_t acc[kChunks][8];
    uint32_t h[kChunks][4];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int64_t c = tile * kSpan + u * kThreads + threadIdx.x;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < n_chunks) v = ring[stage * kSpan + u * kThreads + threadIdx.x];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[u][j] = mix32(4u * static_cast<uint32_t>(c) + j);
        if constexpr (kWordBits == 16) {
          acc[u][2 * j] = w[j];
          acc[u][2 * j + 1] = w[j] >> 16;
        } else {
          acc[u][j] = w[j];
        }
      }
    }
    __syncthreads();                    // every thread has read the stage
    if (threadIdx.x == 0) {
      const int64_t next = tile + static_cast<int64_t>(kStages) * gridDim.x;
      if (next < n_tiles) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_tile(y, next, n_chunks, ring, bars, stage);
      }
    }
    for (int p = 0; p < n_live; ++p) {
      const uint2 kc = live[p];
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t s = mix32(h[u][j] + kc.x);
          if constexpr (kWordBits == 16) {
            acc[u][2 * j] += kc.y * s;
            acc[u][2 * j + 1] += kc.y * (s >> 16);
          } else {
            acc[u][j] += kc.y * s;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int64_t c = tile * kSpan + u * kThreads + threadIdx.x;
      if (c >= n_chunks) continue;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = kWordBits == 16
                   ? __byte_perm(acc[u][2 * j], acc[u][2 * j + 1], 0x5410)
                   : acc[u][j];
      }
      out[c] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int kWordBits>
cudaError_t launch_bulk(const void* y, const uint32_t* keys,
                        const int32_t* coeff, void* out, int n_pairs,
                        int64_t n_chunks, cudaStream_t stream) {
  const auto kernel = bulk_mask_repair_kernel<kWordBits>;
  const size_t bytes = kStages * kTileBytes + sizeof(uint2) * n_pairs;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n_chunks + kSpan - 1) / kSpan;
  const int64_t fit = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<unsigned>(tiles < fit ? tiles : fit), kThreads, bytes,
           stream>>>(static_cast<const uint4*>(y), keys, coeff,
                     static_cast<uint4*>(out), n_pairs, n_chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y/out (rows, 512) words of word_bits bits, out of place; keys (n_pairs,)
// uint32, coeff (n_pairs,) int32, n_pairs >= 1.
int mrf_pr15(const void* y, const void* keys, const void* coeff,
             int word_bits, void* out, int n_pairs, long long rows,
             void* stream) {
  const auto* kk = static_cast<const uint32_t*>(keys);
  const auto* cc = static_cast<const int32_t*>(coeff);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t m = rows * 128;                   // groups of four words
  if (word_bits == 16) return launch_pr15<16>(y, kk, cc, out, n_pairs, m, s);
  if (word_bits == 32) return launch_pr15<32>(y, kk, cc, out, n_pairs, m, s);
  return cudaErrorInvalidValue;
}

int mrf_bulk(const void* y, const void* keys, const void* coeff,
             int word_bits, void* out, int n_pairs, long long rows,
             void* stream) {
  const auto* kk = static_cast<const uint32_t*>(keys);
  const auto* cc = static_cast<const int32_t*>(coeff);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_chunks = rows * 512 * (word_bits / 8) / 16;
  if (word_bits == 16) {
    return launch_bulk<16>(y, kk, cc, out, n_pairs, n_chunks, s);
  }
  if (word_bits == 32) {
    return launch_bulk<32>(y, kk, cc, out, n_pairs, n_chunks, s);
  }
  return cudaErrorInvalidValue;
}

const char* mrf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
