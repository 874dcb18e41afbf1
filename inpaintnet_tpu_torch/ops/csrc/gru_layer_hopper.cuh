// The Hopper design of K8's bf16 route (gru_layer.cu), and the pieces that
// K2 and K4 (decode_hopper.cuh) and K7's bf16 route share with it: a GRU
// recurrence whose hidden units are split across the CTAs of a thread-block
// cluster. It
// replaces, in bf16, the TPU kernel inpaintnet_tpu/ops/gru_pallas.py
// gru_layer_pallas_stream (and gru_layer_pallas, gru_layer_pallas_dma,
// which compute the same function).
//
// What bounds such a recurrence on an H100 is each block's own chain per
// step: wait for W_hh's k-slabs, run the products, then the exact f32 gate
// math, and only then may the next step start (PERF.md). The mma.sync
// kernel this replaces made that chain a serial walk of dependent L2 loads
// (8 chunks x 32 k-steps at H 512), and one block owned every unit of its
// rows, so at one row, or at 2,048 rows in 32-row tiles, most SMs sat idle
// while each block walked all of W_hh alone.
//
// Design:
// - A CTA owns a 64-row wgmma tile and U = H / C of the units; the C CTAs
//   of a cluster share the rows and together cover all H units
//   (gru_kernel.launch_plan picks C from the shape, so that about one wave
//   of CTAs fills the card).
// - Each CTA streams only its own W_hh^T gate slabs (96 rows = r, z and n of
//   32 units, 64 of K: 12 KB; encoder_kernel.pack_gate_slabs' grouping,
//   each chunk's k-slabs contiguous, pack_gate_blocks) through one TMA ring
//   per consumer warpgroup into wgmma, two k-slabs a box: the TMA unit
//   takes about the same time a box whatever its size, so a ring of
//   12 KB boxes streamed at most ~56 GB/s an SM. A producer warp per ring
//   keeps it full across steps, since the weights do not depend on h: the
//   next step's slabs are in flight while this step's gates run.
// - Two consumer warpgroups take 32-unit chunks in turn (a 64 x 96 f32
//   accumulator each); the gate epilogue runs on the accumulators, all 16
//   (row, unit) gates of a thread as one branch-free line so that their
//   exact exp, tanh and divisions interleave. Two warpgroups, not four: a
//   10-warp block gets 168 registers a thread where a 20-warp one gets 96
//   (each SM sub-partition holds 16K), and 96 spilled; and two rings of
//   twice the depth keep more slabs ahead of each warpgroup. The step's
//   input projection, mask and b_hh are loaded into registers before the
//   products, so the epilogue reads only the old h from shared memory.
// - Every CTA keeps the whole 64 x H bf16 h tile (the products' A operand)
//   in shared memory, K-major with the 128-byte swizzle: one tile, not two,
//   because at H 1024 one is 128 KB of the 227. So a step's new h is held in
//   registers until every warpgroup of the CTA has finished reading the old
//   one (a named barrier), then written in place.
// - The exchange of the new h: a CTA owns whole 64-unit k-blocks of h (64
//   rows x 128 bytes = 8 KB, contiguous in the swizzled tile). After its
//   products, each CTA arrives on every peer's `done` mbarrier; after its
//   gates it waits on its own `done` (every CTA has finished reading h, so
//   none is overwritten early) and pushes its k-blocks into every peer's
//   tile with cp.async.bulk (async proxy), each completing on that peer's
//   `full` mbarrier, which the next step's products wait on; thread p of
//   the consumers serves peer p, so the C arrivals and pushes run in
//   parallel. The CTA's own blocks are written by its threads and fenced to
//   the async proxy.
// - Numerics as K8: the carry is rounded to bf16 every step (the tile IS
//   the carry), products accumulate in f32, b_hh is added in f32, the gates
//   run in gru_gate's order; a step whose mask is 0 keeps h and emits it;
//   rows past B are held and never stored.
#pragma once

#include "gru_common.cuh"
#include "hopper_common.cuh"

namespace inpaint {
namespace rec90 {

using namespace sm90;

constexpr int kRows = 64;                      // rows of a CTA: one wgmma m64 tile
constexpr int kUnits = 32;                     // hidden units of a chunk
constexpr int kSlabRows = 3 * kUnits;          // its r, z, n rows of W^T: the wgmma N (96)
constexpr int kSlabBytes = kSlabRows * 128;    // one k-slab of a chunk (64 of K): 12 KB
constexpr int kBlockBytes = kRows * 128;       // one 64-unit k-block of an h tile: 8 KB
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32 * kConsumers;  // + a producer warp per ring
constexpr int kMaxStages = 6;                  // ring stages per consumer warpgroup
constexpr int kMaxCluster = 8;                 // portable cluster sizes: 1, 2, 4, 8
constexpr int kBar = 1;                        // named barrier of the consumer warpgroups
// what a block may hold beside its static shared memory (the 227 KB opt-in
// less 1 KB of alignment and 1 KB for the barriers)
constexpr int kSmemBudget = 232448 - 2048;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }
__device__ __forceinline__ float bf_pick(uint32_t v, int e) { return e ? bf_hi(v) : bf_lo(v); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// 0, but not to the compiler: added to the units of a chunk in each step's
// code, it keeps loads of step-invariant values (b_hh) in that code instead
// of hoisted out of the step loop into registers held across every step
__device__ __forceinline__ int opaque_zero() {
  int z;
  asm volatile("mov.u32 %0, 0;" : "=r"(z));
  return z;
}
__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// k-slabs a TMA box (and a ring stage) holds: 2 where the 64-unit blocks
// pair up. A box costs the TMA unit about the same time whatever its size
// (0.17-0.22 us measured on an H100 for 12-48 KB), so two slabs a box
// double a ring's rate (PERF.md). K4's int8 slabs are half the bytes, and
// two of them a box (12 KB, 4 stages) beat four (24 KB, 2 stages; PERF.md):
// the consumer starts on a stage sooner.
__host__ __device__ __forceinline__ int box_slabs(int H) { return (H / 64) % 2 == 0 ? 2 : 1; }

// The producer side of one consumer warpgroup's ring: a stage is a box of
// `ks` consecutive k-slabs of one chunk (contiguous 12 KB blocks in the
// packed weights, gru_kernel.pack_gate_blocks; K7's are 16 KB,
// arnn_hopper.cuh).
template <int kSlab = kSlabBytes>
struct FeedT {
  const CUtensorMap* map;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int stages, ks, stage;
  uint32_t phase;
  // the k-slabs 0..nk-1 of the chunk whose slabs start at block `block0`
  __device__ void slabs(int block0, int nk) {
    for (int k = 0; k < nk; k += ks) {
      mbar_wait_bounded<false>(&empty[stage], phase ^ 1);
      mbar_expect_tx(&full[stage], ks * kSlab);
      tma_load_3d(ring + stage * ks * kSlab, map, &full[stage], 0, 0, block0 + k);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
};

using Feed = FeedT<>;

// The consumer side: `issue(k, slab)` issues the wgmmas of k-slab k on its
// slab in shared memory; each stage is handed back once the next stage's
// products are in flight. Returns with every product done (the caller
// fences its accumulators).
template <int kSlab = kSlabBytes>
struct RingT {
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int stages, ks, stage;
  uint32_t phase;
  template <typename Products>
  __device__ __forceinline__ void consume(int nk, int lane, Products issue) {
    int prev = 0;
    for (int k = 0; k < nk; k += ks) {
      mbar_wait_bounded<false>(&full[stage], phase);
      wgmma_fence();
      for (int j = 0; j < ks; ++j) issue(k + j, ring + (stage * ks + j) * kSlab);
      wgmma_commit();
      if (k > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);
  }
};
using Ring = RingT<>;

// A ring whose stage is half a k-slab (K2 at H 768, K7 above 512 units):
// the producer loads each k-slab of a chunk as two boxes of 32 values of K
// (the 64-byte swizzle; kHalf bytes each), one a stage, and the consumer
// multiplies each half by its two k16 steps (mma_half).
template <int kHalf>
struct HalfFeedT {
  const CUtensorMap* map;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int stages, stage;
  uint32_t phase;
  // the k-slabs 0..nk-1 of the chunk whose slabs start at block `block0`
  __device__ void slabs(int block0, int nk) {
    for (int k = 0; k < nk; ++k)
      for (int h = 0; h < 2; ++h) {
        mbar_wait_bounded<false>(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], kHalf);
        tma_load_3d(ring + stage * kHalf, map, &full[stage], 32 * h, 0, block0 + k);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
  }
};

template <int kHalf>
struct HalfRingT {
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int stages, stage;
  uint32_t phase;
  // `products(k, h, half)` starts the wgmmas of half h of k-slab k on its
  // stage; each stage is handed back once the next one's products are in
  // flight, and the call returns with every product done
  template <typename Products>
  __device__ __forceinline__ void consume(int nk, int lane, Products products) {
    int prev = 0;
    for (int i = 0; i < 2 * nk; ++i) {
      mbar_wait_bounded<false>(&full[stage], phase);
      wgmma_fence();
      products(i >> 1, i & 1, ring + stage * kHalf);
      wgmma_commit();
      if (i > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);
  }
};

// Half h of a k-slab of a bf16 product: the 128-byte-swizzled A's k16
// steps 2h and 2h + 1 by the 64-byte-swizzled half slab's two (N 128, 96,
// 48 and 32).
__device__ __forceinline__ void mma_half(float (&d)[64], uint64_t da, uint64_t db, int h,
                                         bool accumulate) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
    wgmma_bf16_n128(d, da + 4 * h + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}
__device__ __forceinline__ void mma_half(float (&d)[48], uint64_t da, uint64_t db, int h,
                                         bool accumulate) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
    wgmma_bf16_n96(d, da + 4 * h + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}
__device__ __forceinline__ void mma_half(float (&d)[24], uint64_t da, uint64_t db, int h,
                                         bool accumulate) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
    wgmma_bf16_n48(d, da + 4 * h + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}
__device__ __forceinline__ void mma_half(float (&d)[16], uint64_t da, uint64_t db, int h,
                                         bool accumulate) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
    wgmma_bf16_n32(d, da + 4 * h + 2 * s, db + 2 * s, (accumulate || s) ? 1 : 0);
}

// Byte offset of byte `kbyte` of row r in an h tile of T (bf16: 128-byte
// rows, 128-byte swizzle; K4's int8: 64-byte rows, 64-byte swizzle).
__device__ __forceinline__ int tile_offset(const __nv_bfloat16*, int r, int kbyte) {
  return sw128_offset(r, kbyte, kRows);
}
__device__ __forceinline__ int tile_offset(const int8_t*, int r, int kbyte) {
  return sw64_offset(r, kbyte, kRows);
}

// rows [row0, row0 + 64) of a (rows_total, H) bf16 or int8 matrix into a
// swizzled h tile, zeros past rows_total: sixteen 16-byte loads in flight a
// thread before their stores, a whole tile at H 512 (a load-then-store loop
// waits out each load's latency in turn: ~26 us for two 64 KB tiles)
template <typename T>
__device__ __forceinline__ void load_h_tile(unsigned char* tile, const T* src, int row0,
                                            int rows_total, int H, int tid) {
  constexpr int kBatch = 16, kPer = 16 / (int)sizeof(T);  // values a 16-byte piece
  const int per_row = H / kPer;
  const int n = kRows * per_row;
  for (int i0 = tid; i0 < n; i0 += kBatch * kConsumerThreads) {
    uint4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kConsumerThreads, r = i / per_row, c = i % per_row;
      v[b] = make_uint4(0, 0, 0, 0);
      if (i < n && row0 + r < rows_total)
        v[b] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * H + c * kPer));
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kConsumerThreads, r = i / per_row, c = i % per_row;
      if (i < n) *reinterpret_cast<uint4*>(tile + tile_offset(src, r, c * 16)) = v[b];
    }
  }
}

// The h exchange of one h tile across the cluster (see the design note).
struct Exchange {
  int C;
  uint32_t rank;
  int kb0, nkb;     // this CTA's k-blocks of the tile
  uint64_t* full;   // completes when every peer's blocks have landed here
  uint64_t* done;   // completes when every CTA has finished reading the tile
  // thread `tid` of the consumers, after every consumer of this CTA has
  // finished its products: thread p tells CTA p (the C arrivals in
  // parallel, each a release at cluster scope)
  __device__ void products_done(int tid) const {
    if (tid < C) mbar_arrive_cluster(mapa(smem_u32(done), tid));
  }
  // thread `tid`, after this CTA's own blocks are written and fenced:
  // thread p pushes them to peer p once every CTA has read its tile, and
  // thread 0 arms this CTA's `full` for the peers' blocks
  __device__ void push(unsigned char* tile, uint32_t parity, int tid) const {
    if (tid < C && tid != (int)rank) {
      mbar_wait_bounded<true>(done, parity);
      const uint32_t bar = mapa(smem_u32(full), tid);
      for (int b = 0; b < nkb; ++b) {
        unsigned char* blk = tile + (kb0 + b) * kBlockBytes;
        bulk_copy_to_cluster(mapa(smem_u32(blk), tid), blk, kBlockBytes, bar);
      }
    }
    if (tid == 0) mbar_expect_tx(full, (uint32_t)((C - 1) * nkb * kBlockBytes));
  }
};

// After a layer's products and gates: once every warpgroup of this CTA has
// read the old h (a named barrier), tell the cluster, write the new h held
// in registers (hold[ci][2 * n8 + half]: the pair of units j0 + 8 n8 + 2q of
// row 16 warp + g + 8 half of chunk wg + 2 ci) into the tile in place, hand
// it to the async proxy, and push this CTA's k-blocks to the peers.
template <int MAXC>
__device__ __forceinline__ void write_and_push(unsigned char* tile, const Exchange& ex,
                                               const uint32_t (&hold)[MAXC][8], int wg, int nch,
                                               int chunk0, uint32_t parity) {
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
  named_barrier(kBar, kConsumerThreads);
  if (ex.C > 1) ex.products_done(tid);
#pragma unroll
  for (int ci = 0; ci < MAXC; ++ci) {
    const int c = wg + ci * kConsumers;
    if (c < nch) {
      const int j0 = (chunk0 + c) * kUnits;
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<uint32_t*>(
              tile + sw128_offset(16 * warp + g + 8 * half, (j0 + 8 * n8 + 2 * q) * 2, kRows)) =
              hold[ci][2 * n8 + half];
    }
  }
  fence_proxy_async();
  named_barrier(kBar, kConsumerThreads);
  if (ex.C > 1) ex.push(tile, parity, tid);
}

// The bf16 pair of units (jp, jp + 1) of row r of a swizzled h tile.
__device__ __forceinline__ uint32_t old_pair(const unsigned char* tile, int r, int jp) {
  return *reinterpret_cast<const uint32_t*>(tile + sw128_offset(r, jp * 2, kRows));
}

// The gates of a chunk's 64 rows x 32 units on its 64 x 96 accumulator:
// acc[a] is r, acc[16 + a] z and acc[32 + a] n of the same (row, unit), a =
// 4 n8 + 2 half + e for units j0 + 8 n8 + 2q + e of row 16 warp + g + 8 half;
// xv and bv hold those units' x @ W_ih + b_ih and b_hh as bf16 pairs, h the
// old carry. -> nw[half][n8]: the new carry pairs, rounded to bf16. All 16
// (row, unit) gates run as one straight line (no branches), so their exp,
// tanh and divisions interleave.
__device__ __forceinline__ void gate_epilogue(const float (&acc)[48], const uint32_t (&xv)[2][3][4],
                                              const uint32_t (&bv)[3][4], const unsigned char* h,
                                              int j0, uint32_t (&nw)[2][4]) {
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
#pragma unroll
  for (int n8 = 0; n8 < 4; ++n8) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t old = old_pair(h, 16 * warp + g + 8 * half, j0 + 8 * n8 + 2 * q);
      float hv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int a = 4 * n8 + 2 * half + e;
        const auto pick = [e](uint32_t v) { return e ? bf_hi(v) : bf_lo(v); };
        hv[e] = gru_gate(pick(xv[half][0][n8]), __fadd_rn(acc[a], pick(bv[0][n8])),
                         pick(xv[half][1][n8]), __fadd_rn(acc[16 + a], pick(bv[1][n8])),
                         pick(xv[half][2][n8]), __fadd_rn(acc[32 + a], pick(bv[2][n8])),
                         pick(old));
      }
      nw[half][n8] = pack_bf16(hv[0], hv[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------
struct LayerArgs {
  const __nv_bfloat16* xw;   // (B, steps, 3H)
  const __nv_bfloat16* bhh;  // (3H,)
  const __nv_bfloat16* h0;   // (B, H)
  const uint8_t* keep;       // (B, steps): 0 holds h at that step; null: every step runs
  __nv_bfloat16* ys;         // (B, steps, H), or null
  __nv_bfloat16* hn;         // (B, H)
  int B, steps, H, reverse, stages;
};

// MAXC: chunks a consumer warpgroup takes a step, ceil(U / 64)
template <int MAXC>
__global__ void __launch_bounds__(kThreads, 1)
    gru_layer_kernel(const __grid_constant__ CUtensorMap whh_map, const LayerArgs p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kConsumers][kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kConsumers][kMaxStages];
  __shared__ __align__(8) uint64_t h_full, h_done;
  unsigned char* h = align1024(smem_raw);
  const int H = p.H, H3 = 3 * H, KB = H / 64, ks = box_slabs(H), steps = p.steps;
  unsigned char* ring = h + KB * kBlockBytes;
  const int C = (int)cluster_nctarank();
  const uint32_t rank = cluster_ctarank();
  const int U = H / C, nch = U / kUnits, chunk0 = (int)rank * nch;
  const int tile0 = (int)(blockIdx.x / C) * kRows;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int w = 0; w < kConsumers; ++w)
      for (int s = 0; s < p.stages; ++s) {
        mbar_init(&full_bar[w][s], 1);
        mbar_init(&empty_bar[w][s], 4);  // one arrival per consumer warp
      }
    mbar_init(&h_full, 1);
    mbar_init(&h_done, C);
    fence_barrier_init();
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers are set before any peer touches them

  if (wg == kConsumers) {  // the producer warps: warp w keeps warpgroup w's ring full
    const int w = (threadIdx.x >> 5) & 3;
    if ((threadIdx.x & 31) == 0) {
      Feed f{&whh_map, ring + w * p.stages * ks * kSlabBytes, full_bar[w], empty_bar[w],
             p.stages, ks, 0, 0};
      for (int s = 0; s < steps; ++s)
        for (int c = w; c < nch; c += kConsumers) f.slabs((chunk0 + c) * KB, KB);
    }
    cluster_sync();
    return;
  }

  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  Ring rg{ring + wg * p.stages * ks * kSlabBytes, full_bar[wg], empty_bar[wg], p.stages, ks, 0, 0};
  const Exchange ex{C, rank, (int)rank * (U / 64), U / 64, &h_full, &h_done};
  load_h_tile(h, p.h0, tile0, p.B, H, tid);
  fence_proxy_async();
  named_barrier(kBar, kConsumerThreads);

  for (int s = 0; s < steps; ++s) {
    const int t = p.reverse ? steps - 1 - s : s;
    const bool last = s == steps - 1;
    if (s > 0 && C > 1) mbar_wait_bounded<true>(&h_full, (s - 1) & 1);
    uint32_t hold[MAXC][8];  // the new h of each chunk, bf16 pairs, until h is free
#pragma unroll
    for (int ci = 0; ci < MAXC; ++ci) {
      const int c = wg + ci * kConsumers;
      if (c < nch) {
        const int j0 = (chunk0 + c) * kUnits + opaque_zero();
        // the thread's two rows (g and g + 8 of its warp's 16), their masks,
        // input projections and b_hh pairs, loaded before the products
        int row[2];
        uint8_t keep[2];  // read in the epilogue: the loads below must not wait on it
        uint32_t xv[2][3][4], bv[3][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          row[half] = tile0 + 16 * warp + g + 8 * half;
          const bool in = row[half] < p.B;
          keep[half] = in && p.keep != nullptr ? p.keep[(size_t)row[half] * steps + t] : 1;
          const __nv_bfloat16* x = p.xw + ((size_t)row[half] * steps + t) * H3 + j0 + 2 * q;
#pragma unroll
          for (int gate = 0; gate < 3; ++gate)
#pragma unroll
            for (int n8 = 0; n8 < 4; ++n8)
              xv[half][gate][n8] = in ? ldg_u32(x + gate * H + 8 * n8) : 0u;
        }
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
#pragma unroll
          for (int n8 = 0; n8 < 4; ++n8) bv[gate][n8] = ldg_u32(p.bhh + gate * H + j0 + 8 * n8 + 2 * q);
        float acc[48];
        rg.consume(KB, lane, [&](int k, unsigned char* slab) {
          mma_slab(acc, desc_sw128(h + k * kBlockBytes), desc_sw128(slab), k > 0);
        });
        fence_operands(acc);
        uint32_t nw[2][4];
        gate_epilogue(acc, xv, bv, h, j0, nw);
        // a step whose mask is 0, and a row past B, keeps h
        const bool run[2] = {row[0] < p.B && keep[0] != 0, row[1] < p.B && keep[1] != 0};
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            hold[ci][2 * n8 + half] =
                run[half] ? nw[half][n8]
                          : old_pair(h, 16 * warp + g + 8 * half, j0 + 8 * n8 + 2 * q);
      }
    }
    // the exchange first: its proxy fence would wait out global stores
    // issued before it
    if (!last) write_and_push(h, ex, hold, wg, nch, chunk0, s & 1);
    if (p.ys == nullptr && !last) continue;
#pragma unroll
    for (int ci = 0; ci < MAXC; ++ci) {
      const int c = wg + ci * kConsumers;
      if (c < nch) {
        const int j0 = (chunk0 + c) * kUnits;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = tile0 + 16 * warp + g + 8 * half;
          if (row >= p.B) continue;
#pragma unroll
          for (int n8 = 0; n8 < 4; ++n8) {
            const int jp = j0 + 8 * n8 + 2 * q;
            const uint32_t v = hold[ci][2 * n8 + half];
            if (p.ys != nullptr)
              *reinterpret_cast<uint32_t*>(p.ys + ((size_t)row * steps + t) * H + jp) = v;
            if (last) *reinterpret_cast<uint32_t*>(p.hn + (size_t)row * H + jp) = v;
          }
        }
      }
    }
  }
  cluster_sync();
}

// dynamic shared memory of a K8 block: `tiles` bf16 h tiles and the rings
// (K2's and K4's: decode_hopper.cuh decode_smem_bytes)
inline size_t smem_bytes(int H, int tiles, int stages) {
  return (size_t)tiles * (H / 64) * kRows * 128 +
         (size_t)kConsumers * stages * box_slabs(H) * kSlabRows * 128 + 1024;
}

// A 3D tensor map over K8's packed gate slabs: `blocks` contiguous 96 x 64
// bf16 k-slabs (K-major, rows of 128 bytes with the 128-byte swizzle),
// loaded box_slabs consecutive slabs a box (K2's and K4's maps:
// decode_hopper.cuh make_decode_map).
inline cudaError_t make_slab_map(CUtensorMap* map, const void* packed, int blocks, int H) {
  const uint64_t dims[3] = {64, (uint64_t)kSlabRows, (uint64_t)blocks};
  const uint64_t strides[2] = {128, (uint64_t)kSlabRows * 128};
  const uint32_t box[3] = {64, (uint32_t)kSlabRows, (uint32_t)box_slabs(H)};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, packed, dims, strides, box);
}

// Launch `kernel` on `clusters` clusters of C CTAs of `threads` threads
// (cudaLaunchKernelEx with the cluster dimension), after opting it in to
// `smem` bytes.
template <typename Kernel, typename Args>
inline cudaError_t launch_clusters(Kernel kernel, int clusters, int C, size_t smem,
                                   cudaStream_t stream, const CUtensorMap& map,
                                   const Args& args, int threads = kThreads) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, map, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of C CTAs of `kernel` (`threads` threads and `smem`
// bytes of shared memory) the card runs at once (cudaOccupancyMaxActiveClusters): on an H100
// with one such CTA an SM, 30 of 4 and 15 of 8, not 132 / C, since a
// cluster's CTAs share one GPC. -1 on an error.
template <typename Kernel>
inline int max_clusters(Kernel kernel, int C, size_t smem, int threads = kThreads) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

// K8's launch checks: C in {1, 2, 4, 8} owning whole 64-unit k-blocks
// each, at most 8 chunks a consumer warpgroup, a ring of 2..kMaxStages
// stages that fits beside `tiles` h tiles (K2's and K4's: decode_hopper.cuh
// decode_plan_fits).
inline bool plan_fits(int H, int C, int stages, int tiles) {
  if (H % 64 != 0 || H <= 0 || C < 1 || C > kMaxCluster || (C & (C - 1)) != 0) return false;
  if ((H / 64) % C != 0 || H / C > 8 * kConsumers * kUnits) return false;
  if (stages < 2 || stages > kMaxStages) return false;
  return smem_bytes(H, tiles, stages) <= (size_t)kSmemBudget;
}

inline int chunks_per_warpgroup(int H, int C) {
  const int nch = H / C / kUnits;
  return (nch + kConsumers - 1) / kConsumers;
}

// ---------------------------------------------------------------------------
// The heads' argmax over chunks (K2, K4 and K7, both routes): a head over
// any vocabulary runs as chunks of columns. A thread walks its columns in
// ascending order, chunk after chunk, keeping a running (max, index) of each
// of its rows that a later column takes only by a larger logit; the lanes
// of a quad and the two warpgroups then merge, the lower index winning a
// tie: the first index among equal maxima, as the plain versions' argmax.
// The launches' `ties` (kernel_common.head_ties) is the planted fault of a
// check, "a later chunk wins a tie": a thread walks its chunks last to
// first, and the warpgroups' merge prefers the later chunk (head_beats).
// ---------------------------------------------------------------------------

// the running max's chunk walk: chunk j of n in order, or (ties) reversed
__device__ __forceinline__ int chunk_at(int j, int n, int ties) { return ties ? n - 1 - j : j; }

// the best (value, index) of a row across the four lanes of a quad, the
// lower index winning a tie
__device__ __forceinline__ void quad_best(float& best, int& arg) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
}

// Whether warpgroup 1's best (v, i) of a row beats warpgroup 0's (bv, bi):
// the larger value, on equal values the lower index; with `ties` (the
// planted fault) a later chunk of `cw` columns
__device__ __forceinline__ bool head_beats(float v, int i, float bv, int bi, int cw, int ties) {
  if (v != bv) return v > bv;
  if (ties && i / cw != bi / cw) return i / cw > bi / cw;
  return i < bi;
}

// ---------------------------------------------------------------------------
// The split f32 products of K7's and K2's f32 routes (arnn_hopper.cuh
// arnn_f32_kernel, decode_hopper.cuh decode_f32_kernel): a ring of `stages`
// stages, each a 64-wide k-slab of the operand's three bf16 pieces (one TMA
// box from an L2 scratch, 24 KB) and of two chunks' weight pieces (blocks
// of N rows x 64 of K, [piece][chunk]), read by both consumer warpgroups:
// warpgroup wg multiplies chunk wg.
// ---------------------------------------------------------------------------
constexpr int kF32ABytes = 3 * kBlockBytes;  // a k-slab of an operand's pieces: 24 KB

// the consumers' side of the ring (both warpgroups read every stage)
struct F32Ring {
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int stages, stage_bytes, block_bytes;  // a block: one chunk's N rows of one weight piece
  int stage;
  uint32_t phase;
};

// The split product of the next `nk` ring stages into acc: six bf16 passes
// a stage into a partial of its own, added into acc with rounded f32 adds
// (the tensor cores' own f32 sums are not rounded to nearest). NA = 32: a
// 64 x 64 tile (wgmma n64, K7's 16-unit LSTM chunks); NA = 24: a 64 x 48
// tile (n48, K2's 16-unit GRU chunks). acc[i] is row 16 warp + g + 8 ((i /
// 2) % 2), column 8 (i / 4) + 2q + i % 2 of warpgroup wg's tile; a
// warpgroup that is not `active` only hands the stages back.
template <int NA>
__device__ __forceinline__ void f32_product(F32Ring& rg, float (&acc)[NA], int nk, bool active,
                                            int wg, int lane) {
  static_assert(NA == 32 || NA == 24, "n64 or n48 tiles");
  for (int k = 0; k < nk; ++k) {
    unsigned char* st = rg.ring + rg.stage * rg.stage_bytes;
    mbar_wait_bounded<false>(&rg.full[rg.stage], rg.phase);
    if (active) {
      float part[NA];
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 6; ++pass) {
        // (operand piece, weight piece), smallest terms first: lh, hl, mm, mh, hm, hh
        const int ap = (0x001102 >> (4 * pass)) & 0xF;
        const int bp = (0x010120 >> (4 * pass)) & 0xF;
        const uint64_t da = desc_sw128(st + ap * kBlockBytes);
        const uint64_t db = desc_sw128(st + kF32ABytes + (bp * 2 + wg) * rg.block_bytes);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (NA == 32)
            wgmma_bf16_n64(part, da + 2 * kk, db + 2 * kk, (pass > 0 || kk > 0) ? 1 : 0);
          else
            wgmma_bf16_n48(part, da + 2 * kk, db + 2 * kk, (pass > 0 || kk > 0) ? 1 : 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(part);
      if (lane == 0) mbar_arrive(&rg.empty[rg.stage]);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = k == 0 ? part[i] : __fadd_rn(acc[i], part[i]);
    } else if (lane == 0) {
      mbar_arrive(&rg.empty[rg.stage]);
    }
    if (++rg.stage == rg.stages) {
      rg.stage = 0;
      rg.phase ^= 1;
    }
  }
}

// the pieces of the pair (v0, v1) at row r, column col of the scratch
// plane `pl` (rows of `wd`)
__device__ __forceinline__ void f32_put(__nv_bfloat16* scratch, int pl, int wd, int r, int col,
                                        float v0, float v1) {
  __nv_bfloat16 a[3], b[3];
  split3(v0, a);
  split3(v1, b);
#pragma unroll
  for (int pi = 0; pi < 3; ++pi)
    *reinterpret_cast<__nv_bfloat162*>(scratch + ((size_t)(pl + pi) * kRows + r) * wd + col) =
        __halves2bfloat162(a[pi], b[pi]);
}

}  // namespace rec90
}  // namespace inpaint
