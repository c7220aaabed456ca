// Hand-written Hopper (sm_90a) kernels of the masked FedPC round: secure
// aggregation by pairwise masks, with optional local-DP randomized response,
// and the dropout repair of a round whose workers died after their uplink.
//
// The uplink and the master keep the view of fused_wire.cu: thread i owns
// float4 i of every (R, 512) operand, the flat elements e = 4i .. 4i+3,
// and the same four wire words of every worker. m = R * 128 float4s per
// worker. The repair walks its one slab in 16-byte chunks instead.
//
// Integer arithmetic is uint32 throughout: modular addition wraps as the
// wire's modulus needs, and signed overflow (undefined in C++) never
// arises. The 16-bit modulus keeps the low 16 bits of each word.
//
// Launch plans (repro_torch/kernels/tune.py, wire_common.cuh): the uplink
// and the master take block_rows, the kernel-view rows a CTA of 256 threads
// covers (2: one position a thread, the default). The row-fold uplink
// takes block_workers, the workers a CTA handles (grid.y = ceil(n /
// block_workers), a CTA staging its workers' key rows only; the default
// is all n). The pair and tile kernels honour only the default,
// block_rows = 2 and block_workers = n: they hold all n workers (the tile
// kernel sets its own geometry by n), and the pair kernel's loop over a
// longer span was slower at every plan tried. The master takes block_workers as
// the word rows a thread loads ahead of each step of its sum (1, 2, 4 or
// 8; the default 1). The repair keeps its persistent grid; its
// block_rows is the rows a pass covers, 4, 8 or 16 at 16 bits (2, 4 or 8
// at 32: 1, 2 or 4 chunks of 16 bytes a thread; the default 4 chunks).
// Every plan gives the same bits.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/masked_wire.py):
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
using wire::kThreads;
using wire::load_words;
using wire::mix32;
using wire::Span;
using wire::store_words;
using wire::sub4;
using wire::wire_field;

// Replaces ternary_pack_masked_2d (JAX package, kernels/masked_wire.py),
// in three kernels; the wrapper picks one by shape alone.
//
// Per worker k and element e: field = code + 1 (wire_field); with RR on,
// rr = mix32(mix32(e) + rr_keys[k]) (a full word per element at either
// modulus) replaces the field by (rr >> 16) % 3 when (rr & 0xFFFF) <
// rr_threshold; the word is wq[k] * field plus the net mask
// sum_l signs[k, l] * stream(keys[k, l]) mod 2^WordBits. The stream is
// mix32(mix32(e) + key) per element at 32 bits; at 16 bits one word
// u = mix32(mix32(e >> 1) + key) feeds element 2j with u & 0xFFFF and
// element 2j + 1 with u >> 16.
//
// Bound: integer operations or bytes, about even. Each mask stream word
// costs an add and a mix32 (2 multiplies, 3 xors, 3 shifts), each RR word
// the same, against 68 bytes moved per element at 16 bits. All three kernels
// compute the counter hashes mix32(e) once per thread and keep them in
// registers; stage the keys and signs in shared memory per block; skip
// pairs with sign 0 (the diagonal, non-participants, pairs a tree scopes
// out), a branch uniform across the block; load p1/p2 once; keep codes,
// fields, RR words and masks in registers only; and store each worker's
// four words in one 8- or 16-byte store.
//
// ternary_pack_masked_pairs_kernel runs when the key matrix is square
// (cohort == n) and n <= kPairMaxWorkers, the TPU kernel's whole-cohort
// branch: one thread holds all n workers' four accumulators in registers
// and expands each unordered pair {i, j} once, folding +s * u into worker
// i and -s * u into worker j: n (n - 1) / 2 expansions per element word.
// It reads only the upper triangle, so it needs symmetric keys and
// antisymmetric signs (pair_stream_keys; pair_signs, tree_pair_signs).
//
// ternary_pack_masked_tiles_kernel runs for a square key matrix of
// kPairMaxWorkers < n <= kTileMaxWorkers: the same branch, each unordered
// pair expanded once, with the sums kept in shared memory (its note).
//
// ternary_pack_masked_kernel runs otherwise (a rectangular key matrix: a
// mesh rank's one row of the cohort), the TPU kernel's grid branch: each
// worker folds its own row of the key matrix, n * cohort expansions.
template <int kWordBits, bool kRR, bool kMasks>
__global__ void __launch_bounds__(kThreads)
ternary_pack_masked_kernel(const float4* __restrict__ q,
                           const float4* __restrict__ p1,
                           const float4* __restrict__ p2,
                           const float* __restrict__ beta,
                           const uint32_t* __restrict__ wq,
                           const uint32_t* __restrict__ keys,
                           const int32_t* __restrict__ signs,
                           const uint32_t* __restrict__ rr_keys,
                           const int32_t* __restrict__ t, float alpha1,
                           uint32_t rr_threshold, void* __restrict__ out,
                           int n, int cohort, int64_t m, int block_rows,
                           int block_workers) {
  // The keys, then the signs, of this CTA's worker block: 2 * nb * cohort.
  extern __shared__ uint32_t staged[];
  const int k0 = static_cast<int>(blockIdx.y) * block_workers;
  const int nb = min(k0 + block_workers, n) - k0;
  uint32_t* s_keys = staged;
  int32_t* s_signs = reinterpret_cast<int32_t*>(staged + nb * cohort);
  if constexpr (kMasks) {
    const int64_t row0 = static_cast<int64_t>(k0) * cohort;
    for (int j = threadIdx.x; j < nb * cohort; j += kThreads) {
      s_keys[j] = keys[row0 + j];
      s_signs[j] = signs[row0 + j];
    }
    __syncthreads();
  }
  const Span span = cta_span(block_rows, m);
  const bool round1 = *t <= 1;
  for (int64_t i = span.begin + threadIdx.x; i < span.end; i += kThreads) {
    const float4 a = p1[i];
    const float4 b = round1 ? a : p2[i];
    const float4 step = sub4(a, b);

    // Flat element index of this thread's first element (the wrapper keeps
    // 4 * m within 32 bits).
    const uint32_t e0 = static_cast<uint32_t>(i) * 4u;
    uint32_t hr[4] = {0u, 0u, 0u, 0u};     // RR counter hashes, per element
    if constexpr (kRR) {
#pragma unroll
      for (int j = 0; j < 4; ++j) hr[j] = mix32(e0 + j);
    }
    // Mask counter hashes: per element pair at 16 bits, per element at 32.
    // The stream arithmetic is wire::stream_hashes/fold_stream's, written
    // out here: at 32 bits without RR the helpers' form made this kernel
    // 1.60 ms where this one takes 1.12 (N = 10, R = 41,016, on an H100
    // 80GB HBM3 at 700 W), both at 32 registers.
    uint32_t hm[4] = {0u, 0u, 0u, 0u};
    if constexpr (kMasks && kWordBits == 16) {
      hm[0] = mix32(e0 >> 1);
      hm[1] = mix32((e0 >> 1) + 1u);
    } else if constexpr (kMasks) {
#pragma unroll
      for (int j = 0; j < 4; ++j) hm[j] = kRR ? hr[j] : mix32(e0 + j);
    }

    for (int kk = 0; kk < nb; ++kk) {
      const int k = k0 + kk;
      const int64_t at = static_cast<int64_t>(k) * m + i;
      const float4 x = q[at];
      const float bk = beta[k];
      uint32_t f[4] = {wire_field(x.x, a.x, step.x, bk, alpha1, round1),
                       wire_field(x.y, a.y, step.y, bk, alpha1, round1),
                       wire_field(x.z, a.z, step.z, bk, alpha1, round1),
                       wire_field(x.w, a.w, step.w, bk, alpha1, round1)};
      if constexpr (kRR) {
        const uint32_t rk = rr_keys[k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t rr = mix32(hr[j] + rk);
          if ((rr & 0xFFFFu) < rr_threshold) f[j] = (rr >> 16) % 3u;
        }
      }
      const uint32_t wk = wq[k];
      uint32_t acc0 = wk * f[0], acc1 = wk * f[1], acc2 = wk * f[2],
               acc3 = wk * f[3];
      if constexpr (kMasks) {
        const uint32_t* row_keys = s_keys + kk * cohort;
        const int32_t* row_signs = s_signs + kk * cohort;
        for (int l = 0; l < cohort; ++l) {
          const int32_t s = row_signs[l];
          if (s == 0) continue;
          const uint32_t us = static_cast<uint32_t>(s);
          const uint32_t key = row_keys[l];
          if constexpr (kWordBits == 16) {
            const uint32_t u0 = mix32(hm[0] + key);
            const uint32_t u1 = mix32(hm[1] + key);
            acc0 += us * (u0 & 0xFFFFu);
            acc1 += us * (u0 >> 16);
            acc2 += us * (u1 & 0xFFFFu);
            acc3 += us * (u1 >> 16);
          } else {
            acc0 += us * mix32(hm[0] + key);
            acc1 += us * mix32(hm[1] + key);
            acc2 += us * mix32(hm[2] + key);
            acc3 += us * mix32(hm[3] + key);
          }
        }
      }
      if constexpr (kWordBits == 16) {
        reinterpret_cast<ushort4*>(out)[at] = make_ushort4(
            static_cast<uint16_t>(acc0), static_cast<uint16_t>(acc1),
            static_cast<uint16_t>(acc2), static_cast<uint16_t>(acc3));
      } else {
        reinterpret_cast<uint4*>(out)[at] =
            make_uint4(acc0, acc1, acc2, acc3);
      }
    }
  }
}

// Most workers the pair kernel holds: 16 x 4 uint32 accumulators in
// registers. The paper's federation has 10 nodes.
constexpr int kPairMaxWorkers = 16;

// The pair kernel for exactly kN workers: see the note above
// ternary_pack_masked_kernel. The worker count is a template argument, so
// every loop over workers and pairs unrolls with constant bounds, each
// index into acc[k][j] is a constant and the array lives in registers, and
// no guard on n is left: one instantiation per kN = 1 .. kPairMaxWorkers.
// (A single kernel for up to 16 workers, its loops guarded by a runtime
// n, took 1.0457 ms at 16 bits and 1.6789 at 32 for N = 10, RR and masks
// on, R = 41,016, where this form takes 0.5339 and 0.6966, on an H100
// 80GB HBM3 at 700 W: the guards kept 121 registers and 137 KB of code
// for 16 workers at any n.) At most 128 registers a thread (two blocks an
// SM) for the accumulators, hashes and the kN float4 loads in flight.
//
// The pair kernel honours the one plan of before plans (block_rows = 2,
// one position a thread; block_workers = n): a loop over a longer span
// took 33-43% longer at every plan tried (N = 10, R = 41,016, on an H100
// 80GB HBM3 at 700 W), and ops snaps any other request to it.
template <int kWordBits, bool kRR, bool kMasks, int kN>
__global__ void __launch_bounds__(kThreads, 2)
ternary_pack_masked_pairs_kernel(const float4* __restrict__ q,
                                 const float4* __restrict__ p1,
                                 const float4* __restrict__ p2,
                                 const float* __restrict__ beta,
                                 const uint32_t* __restrict__ wq,
                                 const uint32_t* __restrict__ keys,
                                 const int32_t* __restrict__ signs,
                                 const uint32_t* __restrict__ rr_keys,
                                 const int32_t* __restrict__ t, float alpha1,
                                 uint32_t rr_threshold,
                                 void* __restrict__ out, int64_t m) {
  // The (kN, kN) keys and signs as (key, sign) pairs, so each read in the
  // unrolled pair loop is one 8-byte load at a constant offset.
  __shared__ uint2 s_pairs[kN * kN];
  if constexpr (kMasks) {
    for (int j = threadIdx.x; j < kN * kN; j += kThreads) {
      s_pairs[j] = make_uint2(keys[j], static_cast<uint32_t>(signs[j]));
    }
    __syncthreads();
  }
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const bool round1 = *t <= 1;
  const float4 a = p1[i];
  const float4 b = round1 ? a : p2[i];
  const float4 step = sub4(a, b);
  // Every worker's float4 is requested before any is used: kN * 16 bytes
  // in flight per thread.
  float4 x[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) x[k] = q[static_cast<int64_t>(k) * m + i];

  const uint32_t e0 = static_cast<uint32_t>(i) * 4u;
  uint32_t hr[4] = {0u, 0u, 0u, 0u};       // RR counter hashes, per element
  if constexpr (kRR) {
#pragma unroll
    for (int j = 0; j < 4; ++j) hr[j] = mix32(e0 + j);
  }
  uint32_t acc[kN][4];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const float bk = beta[k];
    uint32_t f[4] = {wire_field(x[k].x, a.x, step.x, bk, alpha1, round1),
                     wire_field(x[k].y, a.y, step.y, bk, alpha1, round1),
                     wire_field(x[k].z, a.z, step.z, bk, alpha1, round1),
                     wire_field(x[k].w, a.w, step.w, bk, alpha1, round1)};
    if constexpr (kRR) {
      const uint32_t rk = rr_keys[k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t rr = mix32(hr[j] + rk);
        if ((rr & 0xFFFFu) < rr_threshold) f[j] = (rr >> 16) % 3u;
      }
    }
    const uint32_t wk = wq[k];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = wk * f[j];
  }

  if constexpr (kMasks) {
    // Mask counter hashes, computed once: per element pair at 16 bits, per
    // element at 32 (the RR hashes when RR is on).
    uint32_t hm[4];
    if constexpr (kWordBits == 16) {
      hm[0] = mix32(e0 >> 1);
      hm[1] = mix32((e0 >> 1) + 1u);
      hm[2] = hm[3] = 0u;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) hm[j] = kRR ? hr[j] : mix32(e0 + j);
    }
    // The 16-bit words keep the low halves of the accumulators, and the
    // low half of s * u depends only on the low half of u: no & 0xFFFF.
#pragma unroll
    for (int r = 0; r < kN - 1; ++r) {
#pragma unroll
      for (int c = r + 1; c < kN; ++c) {
        const uint2 pair = s_pairs[r * kN + c];
        if (pair.y == 0u) continue;
        const uint32_t key = pair.x;
        const uint32_t up = pair.y;
        const uint32_t down = 0u - up;
        if constexpr (kWordBits == 16) {
          const uint32_t u0 = mix32(hm[0] + key);
          const uint32_t u1 = mix32(hm[1] + key);
          acc[r][0] += up * u0;
          acc[r][1] += up * (u0 >> 16);
          acc[r][2] += up * u1;
          acc[r][3] += up * (u1 >> 16);
          acc[c][0] += down * u0;
          acc[c][1] += down * (u0 >> 16);
          acc[c][2] += down * u1;
          acc[c][3] += down * (u1 >> 16);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t u = mix32(hm[j] + key);
            acc[r][j] += up * u;
            acc[c][j] += down * u;
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kN; ++k) {
    store_words<kWordBits>(out, static_cast<int64_t>(k) * m + i, acc[k]);
  }
}

// a * b + c as one IMAD. With b a runtime 1 the add runs on the FMA pipe
// where `a + c` would take the integer ALU's, which the 16-bit pair loop
// fills first.
__device__ __forceinline__ uint32_t mad_lo(uint32_t a, uint32_t b,
                                           uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  return a * b + c;
#endif
}
// The tile kernel: the whole-cohort branch above kPairMaxWorkers workers,
// where one thread's n x 4 sums no longer fit in registers. Like the TPU
// kernel's branch, it expands each unordered pair once, n (n - 1) / 2
// streams, and folds +s * u into worker i and -s * u into worker j.
//
// What held the row fold back: it hashes every stream twice, n (n - 1)
// expansions, and ran at 40% / 36% of the pairs-once bound at N = 17
// (1.7093 / 2.8965 ms at 16 / 32 bits, RR off, R = 41,016, on an H100
// 80GB HBM3 at 700 W). The design:
// - Workers are cut into groups of kTileWorkers = 8 (the last one padded
//   with sign-0 pairs) and the upper triangle of pairs into tiles, group
//   a against group b >= a: ng (ng + 1) / 2 tiles of 64 pairs (a
//   diagonal tile's 28 above its diagonal), staged once per block in
//   shared memory as (key, sign) pairs with each tile's live count.
// - A warp covers 32 positions (a lane the pair kernel's float4 of four
//   elements) and `split` warps share those positions, taking the tiles
//   of their position group in turn from a shared counter. A thread holds
//   the tile's 8 column workers' sums (rb, 32 words) and one row worker's
//   (ra, 4) in registers: 80 registers, three blocks an SM. Each pair
//   is hashed once and folded into ra and rb; ra goes into the shared
//   sums after its row, rb (negated) after the tile, by red.shared.add:
//   addition mod 2^32 is order free, so the words are the pair kernel's
//   and the row fold's, bit for bit. One atomic a pair a thread (4 a
//   row of 8 pairs, 32 a tile), against its 26 integer ops at 16 bits.
// - Every pair of a dense tile (all live, no ragged group) is expanded
//   with no test; a sparse tile (a ragged last group, participation, a
//   tree's scoped signs) tests each sign and skips a dead tile whole.
// - At 16 bits the pair loop is ALU-bound (shifts, xors and adds: 14 of
//   its 26 ops a pair); one of its two counter-hash adds is an IMAD
//   (mad_lo), which runs on the FMA pipe: -1 to -3% at N = 32 and 64.
// - One launch, three phases a block: the warp's workers' W_k * field
//   (after RR) into the shared sums, four float4 loads in flight a lane;
//   the tiles; each warp's workers' words from the shared sums, in one
//   8- or 16-byte store each. Kept from the pair kernel: the counter
//   hashes computed once per thread for every pair, the staged (key,
//   sign) pairs, sign-0 pairs skipped, each float4 of q read once, and no
//   code, field or mask in device memory.
// - split: the fewest warps a position group (1, 2, 4, 8) with which
//   three blocks fit an SM's shared memory, else two, else one
//   (tile_geometry): N = 17 .. 32 split 2, 33 .. 56 split 4, 57 .. 80
//   split 8 at three blocks an SM, 81 .. 112 two, beyond one. At
//   kTileMaxWorkers = 170 (22 groups, 253 tiles) a block takes 221,704
//   bytes; 170 is also the wrapper's own limit on an (N, N) key matrix
//   (8 N^2 bytes staged, masked_wire.py).
// Forms that lost on the card (bench_torch/masked_cohort.py, N = 17, 32
// and 64): all 64 sums of a tile in registers (128 registers, two blocks
// an SM; 16-bit 2.0053 / 4.7034 / 16.9946 ms against this form's 1.6081
// / 3.8371 / 14.4898); fully unrolled dense tiles (up to 1.7x slower);
// no barrier between the fields and the tiles, both taken from one task
// list (0-7% slower); a persistent grid with a barrier a position group
// (up to 8% slower at N = 32 and 64, 2% faster at N = 17, 16 bits),
// with the next chunk's q copied ahead by cp.async (22-31% slower at its
// best split: fewer blocks an SM); eight float4 loads in flight a lane
// (5-18% slower).
//
// Its inner loops run over constant 8 x 8 tiles with a runtime count of
// tiles, so it has one instantiation per (word bits, RR, masks), none
// per worker count. It honours one plan, the pair kernel's (block_rows =
// 2, block_workers = n); the C entry refuses any other.
constexpr int kTileWorkers = 8;
constexpr int kTileMaxWorkers = 170;
constexpr int kTilePairs = kTileWorkers * kTileWorkers;
constexpr int kDiagPairs = kTileWorkers * (kTileWorkers - 1) / 2;
constexpr int kWarps = kThreads / 32;
// A position group's sums: 4 words a lane, 32 lanes, a worker.
constexpr int kSumWords = 4 * 32;
// Blocks an SM holds at most by registers (__launch_bounds__ below).
constexpr int kTileBlocks = 3;
// An SM's shared memory, of which each block reserves 1 KB.
constexpr size_t kSMSharedBytes = 228 * 1024;

struct TileGeometry {
  int groups;   // worker groups, ng
  int tiles;    // staged tiles (0 without masks)
  int split;    // warps a position group
  size_t smem;  // dynamic shared memory a block
};

// The block's shared memory at `split`: the staged pairs, a (groups, live
// count) word pair a tile, a tile counter a position group, the sums.
inline size_t tile_smem(const TileGeometry& g, int split) {
  return (sizeof(uint2) * kTilePairs + sizeof(int2)) * g.tiles +
         sizeof(int) * kWarps +
         sizeof(uint32_t) * kSumWords * g.groups * kTileWorkers *
             (kWarps / split);
}

inline TileGeometry tile_geometry(int n, bool masks) {
  TileGeometry g;
  g.groups = (n + kTileWorkers - 1) / kTileWorkers;
  g.tiles = masks ? g.groups * (g.groups + 1) / 2 : 0;
  g.split = kWarps;
  for (int blocks = kTileBlocks; blocks >= 1 && g.split == kWarps;
       --blocks) {
    for (int s = 1; s <= kWarps; s *= 2) {
      if ((tile_smem(g, s) + 1024) * blocks <= kSMSharedBytes) {
        g.split = s;
        break;
      }
    }
  }
  g.smem = tile_smem(g, g.split);
  return g;
}

// One pair's stream over this thread's four elements, folded once into
// ra (worker r's sums) and once into rb (worker c's, negated when added
// to the shared sums): s * u. At 16 bits one stream word u feeds two
// elements, its low half (the low half of s * u) and u >> 16, which is
// the shift mix32's last step makes: x ^ (x >> 16) >> 16 == x >> 16.
template <int kWordBits>
__device__ __forceinline__ void fold_pair(const uint32_t (&hm)[4],
                                          uint32_t one,
                                          uint32_t key, uint32_t s,
                                          uint32_t (&ra)[4],
                                          uint32_t (&rb)[4]) {
  if constexpr (kWordBits == 16) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      uint32_t x = w == 0 ? mad_lo(key, one, hm[w]) : hm[w] + key;
      x ^= x >> 16;
      x *= 0x7FEB352Du;
      x ^= x >> 15;
      x *= 0x846CA68Bu;
      const uint32_t hi = x >> 16;
      const uint32_t u = x ^ hi;
      ra[2 * w] += s * u;
      ra[2 * w + 1] += s * hi;
      rb[2 * w] += s * u;
      rb[2 * w + 1] += s * hi;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t u = mix32(hm[j] + key);
      ra[j] += s * u;
      rb[j] += s * u;
    }
  }
}

// sums[(k * 4 + j) * 32 + lane] += v[j] (negated with kNegate): lanes on
// consecutive words, no bank conflict.
template <bool kNegate>
__device__ __forceinline__ void add_sums(uint32_t* sums, int k, int lane,
                                         const uint32_t (&v)[4]) {
  uint32_t* at = sums + k * kSumWords + lane;
#pragma unroll
  for (int j = 0; j < 4; ++j) atomicAdd(at + j * 32, kNegate ? 0u - v[j] : v[j]);
}

// The pairs of one tile, row by row: worker r's sums in ra for the row,
// the tile's columns' sums in rb. kCheck: skip pairs of sign 0 and
// columns past `cols` (a ragged last group, a sparse tile); kDiag: a
// diagonal tile's pairs c > r.
template <int kWordBits, bool kCheck, bool kDiag>
__device__ __forceinline__ void fold_tile(const uint2* pairs, int rows,
                                          int cols, int a, int lane,
                                          uint32_t* sums,
                                          const uint32_t (&hm)[4],
                                          uint32_t one,
                                          uint32_t (&rb)[kTileWorkers][4]) {
  for (int r = 0; r < rows; ++r) {
    uint32_t ra[4] = {0u, 0u, 0u, 0u};
    const uint2* row = pairs + r * kTileWorkers;
#pragma unroll
    for (int c = 0; c < kTileWorkers; ++c) {
      if (kCheck && c >= cols) break;
      if (kDiag && c <= r) continue;
      const uint2 pair = row[c];
      if (kCheck && pair.y == 0u) continue;
      fold_pair<kWordBits>(hm, one, pair.x, pair.y, ra, rb[c]);
    }
    add_sums<false>(sums, a * kTileWorkers + r, lane, ra);
  }
}

template <int kWordBits, bool kRR, bool kMasks>
__global__ void __launch_bounds__(kThreads, kTileBlocks)
ternary_pack_masked_tiles_kernel(const float4* __restrict__ q,
                                 const float4* __restrict__ p1,
                                 const float4* __restrict__ p2,
                                 const float* __restrict__ beta,
                                 const uint32_t* __restrict__ wq,
                                 const uint32_t* __restrict__ keys,
                                 const int32_t* __restrict__ signs,
                                 const uint32_t* __restrict__ rr_keys,
                                 const int32_t* __restrict__ t, float alpha1,
                                 uint32_t rr_threshold,
                                 void* __restrict__ out, int n, int64_t m,
                                 int split) {
  extern __shared__ uint2 s_pairs[];
  const int ng = (n + kTileWorkers - 1) / kTileWorkers;
  const int n_pad = ng * kTileWorkers;
  const int n_tiles = kMasks ? ng * (ng + 1) / 2 : 0;
  int2* s_info = reinterpret_cast<int2*>(s_pairs + n_tiles * kTilePairs);
  int* s_next = reinterpret_cast<int*>(s_info + n_tiles);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pgroup = warp / split;
  const int sub = warp - pgroup * split;
  uint32_t* sums = reinterpret_cast<uint32_t*>(s_next + kWarps) +
                   pgroup * n_pad * kSumWords;
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * (kWarps / split) + pgroup) * 32 +
      lane;
  const bool live = i < m;

  if constexpr (kMasks) {
    // Warp w stages tiles w, w + 8, ...: the upper triangle's (key, sign)
    // pairs (0 below a diagonal tile's diagonal and past n), and the
    // tile's groups and live pairs.
    for (int tile = warp; tile < n_tiles; tile += kWarps) {
      int a = 0, rest = tile;
      while (rest >= ng - a) rest -= ng - a++;
      const int b = a + rest;
      int live_pairs = 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rc = half * 32 + lane;
        const int r = a * kTileWorkers + rc / kTileWorkers;
        const int c = b * kTileWorkers + rc % kTileWorkers;
        uint2 v = make_uint2(0u, 0u);
        if (r < c && c < n) {
          const int64_t at = static_cast<int64_t>(r) * n + c;
          v = make_uint2(keys[at], static_cast<uint32_t>(signs[at]));
        }
        s_pairs[tile * kTilePairs + rc] = v;
        live_pairs += __popc(__ballot_sync(0xFFFFFFFFu, v.y != 0u));
      }
      if (lane == 0) s_info[tile] = make_int2(a | b << 16, live_pairs);
    }
    if (threadIdx.x < kWarps) s_next[threadIdx.x] = 0;
  }

  // Phase 1: W_k * field of this warp's workers.
  const bool round1 = *t <= 1;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), step = a;
  if (live) {
    a = p1[i];
    step = sub4(a, round1 ? a : p2[i]);
  }
  const uint32_t e0 = static_cast<uint32_t>(i) * 4u;
  uint32_t hr[4] = {0u, 0u, 0u, 0u};       // RR counter hashes, per element
  if constexpr (kRR) {
#pragma unroll
    for (int j = 0; j < 4; ++j) hr[j] = mix32(e0 + j);
  }
  for (int k0 = sub; k0 < n_pad; k0 += 4 * split) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * split;
      x[u] = live && k < n ? q[static_cast<int64_t>(k) * m + i]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * split;
      if (k >= n_pad) break;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (k < n) {
        const float bk = beta[k];
        uint32_t f[4] = {wire_field(x[u].x, a.x, step.x, bk, alpha1, round1),
                         wire_field(x[u].y, a.y, step.y, bk, alpha1, round1),
                         wire_field(x[u].z, a.z, step.z, bk, alpha1, round1),
                         wire_field(x[u].w, a.w, step.w, bk, alpha1, round1)};
        if constexpr (kRR) {
          const uint32_t rk = rr_keys[k];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t rr = mix32(hr[j] + rk);
            if ((rr & 0xFFFFu) < rr_threshold) f[j] = (rr >> 16) % 3u;
          }
        }
        const uint32_t wk = wq[k];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = wk * f[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) sums[(k * 4 + j) * 32 + lane] = w[j];
    }
  }
  __syncthreads();

  // Phase 2: the position group's warps take its tiles in turn.
  if constexpr (kMasks) {
    uint32_t hm[4];
    if constexpr (kWordBits == 16) {
      hm[0] = mix32(e0 >> 1);
      hm[1] = mix32((e0 >> 1) + 1u);
      hm[2] = hm[3] = 0u;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) hm[j] = kRR ? hr[j] : mix32(e0 + j);
    }
    for (;;) {
      int tile = 0;
      if (lane == 0) tile = atomicAdd(s_next + pgroup, 1);
      tile = __shfl_sync(0xFFFFFFFFu, tile, 0);
      if (tile >= n_tiles) break;
      const int2 info = s_info[tile];
      if (info.y == 0) continue;
      const int ta = info.x & 0xFFFF;
      const int tb = info.x >> 16;
      const int rows = min(kTileWorkers, n - ta * kTileWorkers);
      const int cols = min(kTileWorkers, n - tb * kTileWorkers);
      const uint2* pairs = s_pairs + tile * kTilePairs;
      const uint32_t one = n > 0;
      uint32_t rb[kTileWorkers][4];
#pragma unroll
      for (int c = 0; c < kTileWorkers; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) rb[c][j] = 0u;
      }
      if (ta != tb) {
        if (info.y == kTilePairs) {
          fold_tile<kWordBits, false, false>(pairs, rows, cols, ta, lane,
                                             sums, hm, one, rb);
        } else {
          fold_tile<kWordBits, true, false>(pairs, rows, cols, ta, lane,
                                            sums, hm, one, rb);
        }
      } else if (info.y == kDiagPairs) {
        fold_tile<kWordBits, false, true>(pairs, rows, cols, ta, lane, sums,
                                          hm, one, rb);
      } else {
        fold_tile<kWordBits, true, true>(pairs, rows, cols, ta, lane, sums,
                                         hm, one, rb);
      }
#pragma unroll
      for (int c = 0; c < kTileWorkers; ++c) {
        if (c < cols) add_sums<true>(sums, tb * kTileWorkers + c, lane, rb[c]);
      }
    }
  }
  __syncthreads();

  // Phase 3: this warp's workers' words.
  if (live) {
    for (int k = sub; k < n; k += split) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = sums[(k * 4 + j) * 32 + lane];
      store_words<kWordBits>(out, static_cast<int64_t>(k) * m + i, w);
    }
  }
}

// The word's signed residue at the wire width, as float.
template <int kWordBits>
__device__ __forceinline__ float residue(uint32_t acc, uint32_t sum_wq) {
  const uint32_t d = acc - sum_wq;
  if constexpr (kWordBits == 16) {
    return __int2float_rn(static_cast<int16_t>(static_cast<uint16_t>(d)));
  } else {
    return __int2float_rn(static_cast<int32_t>(d));
  }
}

// Replaces masked_master_update_2d (JAX package, kernels/masked_wire.py).
// Per element: the N workers' words folded in uint32 registers (modular
// addition is order-free, so the pairwise masks cancel to the bit and any
// order gives the same sum), de-biased by the public sum_k W_k,
// reinterpreted as signed at the wire width, descaled by scale_mult
// (coeff is its own rounded product), and Eq. (3) as one fused
// multiply-add, q - coeff * mult, as XLA:CPU contracts it in the reference.
// At round <= 1 mult is alpha0 and the history is not read. The pilot's
// model is read in place from the n stacked worker buffers at the device
// index k_star; an index outside [0, n) yields NaN. The words are c rows,
// any c >= 1: the n workers' own words on the flat wire, the w_L
// last-level partials at a tree's root.
//
// Bound: bytes. A handful of integer and float operations per element
// against (2 c + 16) bytes at 16 bits; one 8- or 16-byte load per word row
// per thread, and one 16-byte store.
template <int kWordBits, int kAhead>
__global__ void __launch_bounds__(kThreads)
masked_master_update_kernel(const float4* __restrict__ q,
                            const int64_t* __restrict__ k_star,
                            const void* __restrict__ masked,
                            const uint32_t* __restrict__ sum_wq,
                            const float4* __restrict__ p1,
                            const float4* __restrict__ p2,
                            const int32_t* __restrict__ t, float alpha0,
                            float scale_mult, float4* __restrict__ out, int n,
                            int c, int64_t m, int block_rows) {
  const Span span = cta_span(block_rows, m);
  const int64_t pilot = *k_star;
  const uint32_t sw = *sum_wq;
  for (int64_t i = span.begin + threadIdx.x; i < span.end; i += kThreads) {
    if (pilot < 0 || pilot >= n) {
      const float nan = __int_as_float(0x7fc00000);
      out[i] = make_float4(nan, nan, nan, nan);
      continue;
    }
    uint32_t a[4] = {0u, 0u, 0u, 0u};
    for (int k0 = 0; k0 < c; k0 += kAhead) {
      // kAhead rows' words requested before the first is summed.
      uint32_t w[kAhead][4];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (kAhead == 1 || k0 + j < c) {
          load_words<kWordBits>(masked, static_cast<int64_t>(k0 + j) * m + i,
                                w[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (kAhead == 1 || k0 + j < c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] += w[j][e];
        }
      }
    }
    const float c0 = __fmul_rn(residue<kWordBits>(a[0], sw), scale_mult);
    const float c1 = __fmul_rn(residue<kWordBits>(a[1], sw), scale_mult);
    const float c2 = __fmul_rn(residue<kWordBits>(a[2], sw), scale_mult);
    const float c3 = __fmul_rn(residue<kWordBits>(a[3], sw), scale_mult);
    float4 mult = make_float4(alpha0, alpha0, alpha0, alpha0);
    if (*t > 1) mult = sub4(p1[i], p2[i]);
    const float4 x = q[pilot * m + i];
    out[i] = make_float4(__fmaf_rn(-c0, mult.x, x.x),
                         __fmaf_rn(-c1, mult.y, x.y),
                         __fmaf_rn(-c2, mult.z, x.z),
                         __fmaf_rn(-c3, mult.w, x.w));
  }
}

// Replaces mask_repair_2d (JAX package, kernels/masked_wire.py). Per
// element of one (R, 512) word slab: y + sum_p coeff[p] * stream(keys[p])
// mod 2^WordBits, with the uplink's stream geometry (fold_stream), so a
// dead worker's pair streams are regenerated bitwise as its siblings
// folded them in. kReadY = false drops y: the repair term alone into a
// zero row, write-only. out may be y (in place): each thread reads its
// words before it writes them, and no other thread touches them.
//
// Bound: bytes (a 16-bit row's read and write, 84 MB at the main path's
// R) unless many pairs are live. The design answers what held the
// one-word-group-a-thread kernel at 40% of that bound:
// - each thread owns kChunks 16-byte chunks (8 words at 16 bits, 4 at
//   32), a block's width apart, and issues all their loads before any
//   hashing: 64 bytes in flight a thread at the default kChunks = 4 (the
//   plan's block_rows picks 1, 2 or 4);
// - a persistent grid (the SM count times the blocks an SM holds) walks
//   the row, so each block stages its pairs once;
// - warp 0 compacts the pairs with a coefficient into shared memory by
//   ballot, once a block, after the first chunks' loads are issued; the
//   element loop runs over those pairs only. Their count stays on the
//   device: where fewer than P are live, the slot of the last pair holds
//   (count, 0), so no static shared memory is needed beside the P pairs.
// Chunk c's counter hashes are mix32(4c + j), j < 4, at both widths: at
// 16 bits one per element pair (elements 8c + 2j, 8c + 2j + 1), at 32 one
// per element (4c + j).
template <int kWordBits>
__device__ __forceinline__ void fold_chunk(const uint32_t h[4], uint32_t key,
                                           uint32_t s, uint32_t acc[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t u = mix32(h[j] + key);
    if constexpr (kWordBits == 16) {
      acc[2 * j] += s * u;            // only the low 16 bits are kept
      acc[2 * j + 1] += s * (u >> 16);
    } else {
      acc[j] += s * u;
    }
  }
}

// Thread threadIdx.x's chunks of the span at `at`, zero past the end or
// without y.
template <bool kReadY, int kChunks>
__device__ __forceinline__ void load_chunks(const uint4* y, int64_t at,
                                            int64_t n_chunks,
                                            uint4 (&v)[kChunks]) {
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const int64_t c = at + u * kThreads + threadIdx.x;
    v[u] = make_uint4(0u, 0u, 0u, 0u);
    if (kReadY && c < n_chunks) v[u] = y[c];
  }
}

template <int kWordBits, bool kReadY, int kChunks>
__global__ void __launch_bounds__(kThreads)
mask_repair_kernel(const uint4* y, const uint32_t* __restrict__ keys,
                   const int32_t* __restrict__ coeff, uint4* out,
                   int n_pairs, int64_t n_chunks) {
  extern __shared__ uint2 live[];          // (key, coeff) of the live pairs
  constexpr int kSpan = kThreads * kChunks;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSpan;
  int64_t base = static_cast<int64_t>(blockIdx.x) * kSpan;
  uint4 v[kChunks];
  load_chunks<kReadY, kChunks>(y, base, n_chunks, v);
  if (threadIdx.x < 32) {
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
  for (; base < n_chunks; base += stride) {
    uint32_t acc[kChunks][8];
    uint32_t h[kChunks][4];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const uint32_t c = static_cast<uint32_t>(base + u * kThreads +
                                               threadIdx.x);
      const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[u][j] = mix32(4u * c + j);
        if constexpr (kWordBits == 16) {
          acc[u][2 * j] = w[j];
          acc[u][2 * j + 1] = w[j] >> 16;
        } else {
          acc[u][j] = w[j];
        }
      }
    }
    if (base + stride < n_chunks) {
      load_chunks<kReadY, kChunks>(y, base + stride, n_chunks, v);
    }
    for (int p = 0; p < n_live; ++p) {
      const uint2 kc = live[p];
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        fold_chunk<kWordBits>(h[u], kc.x, kc.y, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int64_t c = base + u * kThreads + threadIdx.x;
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

// Blocks of the persistent grid: as many as fit on every SM at once with
// this much shared memory, and no more than the chunks need.
template <int kWordBits, bool kReadY, int kChunks>
cudaError_t launch_repair_kernel(const void* y, const uint32_t* keys,
                                 const int32_t* coeff, void* out,
                                 int n_pairs, int64_t n_chunks,
                                 cudaStream_t stream) {
  const auto kernel = mask_repair_kernel<kWordBits, kReadY, kChunks>;
  const size_t staged = sizeof(uint2) * static_cast<size_t>(n_pairs);
  cudaError_t err;
  if (staged > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(staged));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, staged);
  if (err != cudaSuccess) return err;
  const int64_t span = kThreads * kChunks;
  const int64_t need = (n_chunks + span - 1) / span;
  const int64_t fit = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(need < fit ? need : fit);
  kernel<<<grid, kThreads, staged, stream>>>(
      static_cast<const uint4*>(y), keys, coeff, static_cast<uint4*>(out),
      n_pairs, n_chunks);
  return cudaGetLastError();
}

template <int kWordBits, int kChunks>
cudaError_t launch_repair_chunks(const void* y, const uint32_t* keys,
                                 const int32_t* coeff, void* out,
                                 int n_pairs, int64_t n_chunks,
                                 cudaStream_t stream) {
  if (y == nullptr) {
    return launch_repair_kernel<kWordBits, false, kChunks>(
        y, keys, coeff, out, n_pairs, n_chunks, stream);
  }
  return launch_repair_kernel<kWordBits, true, kChunks>(
      y, keys, coeff, out, n_pairs, n_chunks, stream);
}

// block_rows: the rows a pass of the grid covers, kChunks * kThreads
// chunks of 16 bytes; a row is 512 words.
template <int kWordBits>
cudaError_t launch_repair(const void* y, const uint32_t* keys,
                          const int32_t* coeff, void* out, int n_pairs,
                          int64_t rows, int block_rows, cudaStream_t stream) {
  const int64_t n_chunks = rows * 512 * (kWordBits / 8) / 16;
  constexpr int kRowsPerChunk = 16 * kThreads / (512 * (kWordBits / 8));
  switch (block_rows) {
    case 1 * kRowsPerChunk:
      return launch_repair_chunks<kWordBits, 1>(y, keys, coeff, out, n_pairs,
                                                n_chunks, stream);
    case 2 * kRowsPerChunk:
      return launch_repair_chunks<kWordBits, 2>(y, keys, coeff, out, n_pairs,
                                                n_chunks, stream);
    case 4 * kRowsPerChunk:
      return launch_repair_chunks<kWordBits, 4>(y, keys, coeff, out, n_pairs,
                                                n_chunks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

struct PackArgs {
  const float4* q;
  const float4* p1;
  const float4* p2;
  const float* beta;
  const uint32_t* wq;
  const uint32_t* keys;
  const int32_t* signs;
  const uint32_t* rr_keys;
  const int32_t* t;
  float alpha1;
  uint32_t rr_threshold;
  void* out;
  int n;
  int cohort;
  int64_t m;
  int block_rows;
  int block_workers;
  int kernel;   // 0 the row fold, 1 the pair kernel, 2 the tile kernel
  cudaStream_t stream;
};

// The pair kernel instantiated for a.n workers: kN counts up to it.
template <int kWordBits, bool kRR, bool kMasks, int kN = 1>
cudaError_t launch_pairs(const PackArgs& a) {
  if constexpr (kN > kPairMaxWorkers) {
    return cudaErrorInvalidValue;
  } else {
    if (a.n != kN) return launch_pairs<kWordBits, kRR, kMasks, kN + 1>(a);
    ternary_pack_masked_pairs_kernel<kWordBits, kRR, kMasks, kN>
        <<<blocks_for(a.m), kThreads, 0, a.stream>>>(
        a.q, a.p1, a.p2, a.beta, a.wq, a.keys, a.signs, a.rr_keys, a.t,
        a.alpha1, a.rr_threshold, a.out, a.m);
    return cudaGetLastError();
  }
}

template <int kWordBits, bool kRR, bool kMasks>
cudaError_t launch_tiles(const PackArgs& a) {
  const auto kernel = ternary_pack_masked_tiles_kernel<kWordBits, kRR, kMasks>;
  const TileGeometry g = tile_geometry(a.n, kMasks);
  if (g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t per_block = static_cast<int64_t>(kWarps / g.split) * 32;
  const unsigned grid = static_cast<unsigned>((a.m + per_block - 1) /
                                              per_block);
  kernel<<<grid, kThreads, g.smem, a.stream>>>(
      a.q, a.p1, a.p2, a.beta, a.wq, a.keys, a.signs, a.rr_keys, a.t,
      a.alpha1, a.rr_threshold, a.out, a.n, a.m, g.split);
  return cudaGetLastError();
}

template <int kWordBits, bool kRR, bool kMasks>
cudaError_t launch_pack(const PackArgs& a) {
  if (a.kernel != 0) {
    if (a.cohort != a.n || a.block_workers != a.n ||
        a.block_rows != kThreads / wire::kRowPositions ||
        a.n > (a.kernel == 1 ? kPairMaxWorkers : kTileMaxWorkers)) {
      return cudaErrorInvalidValue;
    }
    return a.kernel == 1 ? launch_pairs<kWordBits, kRR, kMasks>(a)
                         : launch_tiles<kWordBits, kRR, kMasks>(a);
  }
  const size_t staged = kMasks ? 2 * sizeof(uint32_t) *
                                     static_cast<size_t>(a.block_workers) *
                                     a.cohort
                               : 0;
  if (staged > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ternary_pack_masked_kernel<kWordBits, kRR, kMasks>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(staged));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(blocks_for_rows(a.m, a.block_rows),
                  blocks_of(a.n, a.block_workers));
  ternary_pack_masked_kernel<kWordBits, kRR, kMasks>
      <<<grid, kThreads, staged, a.stream>>>(
      a.q, a.p1, a.p2, a.beta, a.wq, a.keys, a.signs, a.rr_keys, a.t,
      a.alpha1, a.rr_threshold, a.out, a.n, a.cohort, a.m, a.block_rows,
      a.block_workers);
  return cudaGetLastError();
}

template <int kWordBits>
cudaError_t launch_pack_bits(const PackArgs& a, bool rr, bool masks) {
  if (rr) {
    return masks ? launch_pack<kWordBits, true, true>(a)
                 : launch_pack<kWordBits, true, false>(a);
  }
  return masks ? launch_pack<kWordBits, false, true>(a)
               : launch_pack<kWordBits, false, false>(a);
}

}  // namespace

extern "C" {

// q (n, m) float4, p1/p2 (m,) float4, beta (n,) float, wq (n,) uint32,
// keys (n, cohort) uint32, signs (n, cohort) int32, rr_keys (n,) uint32,
// t int32 scalar, out (n, m) ushort4 (word_bits 16) or uint4 (32).
// kernel 1 (the pair kernel, n <= kPairMaxWorkers) and 2 (the tile
// kernel, n <= kTileMaxWorkers) expand each unordered pair once: cohort
// == n, keys symmetric, signs antisymmetric; block_rows == 2,
// block_workers == n. kernel 0 takes the row-fold kernel (1 <=
// block_workers <= n; block_rows >= 1).
int mw_ternary_pack_masked(const void* q, const void* p1, const void* p2,
                           const void* beta, const void* wq, const void* keys,
                           const void* signs, const void* rr_keys,
                           const void* t, float alpha1,
                           unsigned rr_threshold, int word_bits,
                           int use_masks, int kernel, void* out, int n,
                           int cohort, long long m, int block_rows,
                           int block_workers, int device, void* stream) {
  if (block_rows < 1 || block_workers < 1 || block_workers > n ||
      kernel < 0 || kernel > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const PackArgs a{static_cast<const float4*>(q),
                   static_cast<const float4*>(p1),
                   static_cast<const float4*>(p2),
                   static_cast<const float*>(beta),
                   static_cast<const uint32_t*>(wq),
                   static_cast<const uint32_t*>(keys),
                   static_cast<const int32_t*>(signs),
                   static_cast<const uint32_t*>(rr_keys),
                   static_cast<const int32_t*>(t),
                   alpha1,
                   rr_threshold,
                   out,
                   n,
                   cohort,
                   m,
                   block_rows,
                   block_workers,
                   kernel,
                   static_cast<cudaStream_t>(stream)};
  const bool rr = rr_threshold > 0;
  const bool masks = use_masks != 0;
  cudaError_t err;
  if (word_bits == 16) {
    err = launch_pack_bits<16>(a, rr, masks);
  } else if (word_bits == 32) {
    err = launch_pack_bits<32>(a, rr, masks);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// q (n, m) float4, k_star int64 scalar, masked (c, m) ushort4 / uint4,
// sum_wq uint32 scalar, p1/p2/out (m,) float4, t int32 scalar;
// block_rows >= 1, block_workers (the word rows loaded ahead) 1, 2, 4 or 8.
int mw_masked_master_update(const void* q, const void* k_star,
                            const void* masked, const void* sum_wq,
                            const void* p1, const void* p2, const void* t,
                            float alpha0, float scale_mult, int word_bits,
                            void* out, int n, int c, long long m,
                            int block_rows, int block_workers, int device,
                            void* stream) {
  using Kernel = void (*)(const float4*, const int64_t*, const void*,
                          const uint32_t*, const float4*, const float4*,
                          const int32_t*, float, float, float4*, int, int,
                          int64_t, int);
  Kernel kernel = nullptr;
  if (word_bits == 16) {
    switch (block_workers) {
      case 1: kernel = masked_master_update_kernel<16, 1>; break;
      case 2: kernel = masked_master_update_kernel<16, 2>; break;
      case 4: kernel = masked_master_update_kernel<16, 4>; break;
      case 8: kernel = masked_master_update_kernel<16, 8>; break;
    }
  } else if (word_bits == 32) {
    switch (block_workers) {
      case 1: kernel = masked_master_update_kernel<32, 1>; break;
      case 2: kernel = masked_master_update_kernel<32, 2>; break;
      case 4: kernel = masked_master_update_kernel<32, 4>; break;
      case 8: kernel = masked_master_update_kernel<32, 8>; break;
    }
  }
  if (kernel == nullptr || block_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<blocks_for_rows(m, block_rows), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const int64_t*>(k_star),
      masked, static_cast<const uint32_t*>(sum_wq),
      static_cast<const float4*>(p1), static_cast<const float4*>(p2),
      static_cast<const int32_t*>(t), alpha0, scale_mult,
      static_cast<float4*>(out), n, c, m, block_rows);
  return static_cast<int>(cudaGetLastError());
}

// y/out (rows, 512) words of word_bits bits, y NULL for the repair term
// alone (write-only); out may be y. keys (n_pairs,) uint32, coeff
// (n_pairs,) int32; block_rows the rows a pass covers (4, 8 or 16 at 16
// bits; 2, 4 or 8 at 32).
int mw_mask_repair(const void* y, const void* keys, const void* coeff,
                   int word_bits, void* out, int n_pairs, long long rows,
                   int block_rows, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const auto* kk = static_cast<const uint32_t*>(keys);
  const auto* cc = static_cast<const int32_t*>(coeff);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (word_bits == 16) {
    err = launch_repair<16>(y, kk, cc, out, n_pairs, rows, block_rows, s);
  } else if (word_bits == 32) {
    err = launch_repair<32>(y, kk, cc, out, n_pairs, rows, block_rows, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* mw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
