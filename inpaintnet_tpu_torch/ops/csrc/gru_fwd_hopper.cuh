// The Hopper design of K5 (gru_fwd_seq.cu), both dtypes: the forward of one
// GRU layer direction in training over a precomputed xw = x @ W_ih + b_ih,
// emitting beside ys the gates K6 consumes (r, z, n, hn). It replaces the
// TPU kernel inpaintnet_tpu/ops/gru_bwd_pallas.py gru_fwd_seq_pallas
// (_fwd_seq_kernel). K5 is K6's forward twin (gru_bwd_hopper.cuh), and is
// built the same way.
//
// Function (gru_train_kernel.gru_fwd_seq_reference): per processed step, hw
// = T(h) @ W_hh + b_hh, the product taking the f32 carry h rounded to the
// parameter dtype T and accumulating in f32; r = sigmoid(x_r + hw_r), z =
// sigmoid(x_z + hw_z), n = tanh(x_n + r * hw_n), h' = (1 - z) * n + z * h in
// f32, each multiply and add rounded on its own in that order; ys, r, z, n
// and hn = hw_n stored in T; h' carried in f32.
//
// What bounds it on an H100: the product, 2 * steps * B * H * 3H operations
// (155 GFLOP at the VAE encoder's 24 steps x 4,096 rows x H 512): 2.31 ms
// on the f32 FMA units, 0.16 ms on the bf16 tensor cores; the five outputs'
// bytes (0.24 ms in bf16). The first kernel (one block of 16 or 32 rows
// streaming the whole W_hh from L2 every step) took 9.58 ms in f32 and 2.64
// in bf16 there.
//
// Design:
// - The product on the tensor cores. bf16: T(h) and W_hh are one bf16
//   piece each, one wgmma pass accumulating in f32 over all of K (as K8).
//   f32: both are split into three exact bf16 pieces (split3: hi, mid, lo;
//   24 bits), and six passes keep the cross terms down to 2^-24 (lh, hl, mm,
//   mh, hm, hh, smallest first), as K6's; each 64-wide k-slab's passes sum
//   in an accumulator of their own, added into the result with rounded f32
//   adds, since the tensor cores' own f32 sums are not rounded to nearest
//   (over all of K they broke K6's f32 bounds). One partial, not K6's two in
//   turns: three 64 x 96 accumulators spilled at ptxas' 168-register cap,
//   and the other consumer warpgroup's products fill the tensor cores while
//   one adds its partial.
// - A cluster of C CTAs shares a 64-row tile; CTA rank p owns the U = H / C
//   units [pU, pU + U) of all three gates (U = 64 in f32, where the sum and
//   the partial of a 32-unit chunk's 64 x 96 tile fill the registers; 64 or 128
//   in bf16): two consumer warpgroups each take U / 2 of them, in 32-unit
//   chunks whose r, z and n columns form one 64 x 96 wgmma tile. The f32
//   carry of the CTA's units stays in its shared memory, read and written
//   only by the thread whose accumulator fragment holds the (row, unit).
// - bf16: each output goes through a small shared buffer of the warpgroup
//   (two in turns) and leaves in whole runs of a row (64 or 128 bytes) per
//   lane group: stored straight from the accumulator's layout (8 rows x 16
//   bytes a warp instruction) the five outputs took a third of K5's time
//   (PERF.md). f32 stores them straight: its ring leaves no room, and there
//   they took 9%.
// - The product's A operand is the whole (64, H) T(h) tile, in one or three
//   bf16 pieces: each CTA writes its units' pieces of the new h into an
//   L2-resident scratch (tile, step parity, piece, row, unit), then a
//   release/acquire arrival on every peer's `ready` mbarrier; a producer
//   warp streams each 64-wide k-slab of the pieces (one TMA box) beside the
//   CTA's W_hh k-slab (one 5-D box of its chunks' 96 x 64 gate slabs in
//   every piece, gru_train_kernel.pack_fwd_weights: encoder_kernel.
//   pack_gate_blocks of each piece) through a ring into wgmma. The cluster
//   only moves data, so every cluster size gives bit-equal outputs. The
//   scratch alternates between two buffers by step parity: a CTA writes
//   step s + 1's pieces after its own product of step s, which waited for
//   every peer's arrival of step s, made after each peer had consumed all
//   of step s - 1's slabs (the same buffer).
// - Rows past B compute on zeros and are never stored.
//
// K1's f32 route (the frozen encoder's two layers, encoder_gru.cu) runs
// the same kernel through its kMode parameter, both directions in one
// launch (blockIdx.y; W's pieces of both stacked in the map's last
// dimension, the scratch's planes per direction): h0 = 0; layer 0 (kEnc0)
// reads its input projection as a row of the f32 (V, 3H) table with b_ih
// folded in, gathered by token, and writes only the outputs' pieces (the
// projection GEMM's A operand) and h_n; layer 1 (kEnc1) reads the GEMM's
// f32 rows (b_ih added) and writes only h_n. Neither writes r, z, n or hn.
//
// K8's f32 route (the generic GRU layer, gru_layer.cu) is mode kLayer: K5's
// function with hold masks, writing ys (B, steps, H) or only h_n and no
// gates (gru_kernel.gru_layer_reference; in f32 its carry, rounded to the
// parameter dtype, is K5's f32 carry). A step whose keep is 0 (keep is
// indexed by the time t, not the step s, under reverse) keeps h, emits the
// held h, and writes the held h's pieces into the scratch buffer of the
// next step like any new h: a held row that wrote nothing there would
// leave that buffer's pieces of two steps before for the peers to read.
// An all-zero row returns h0. Its CTAs own 64 units as K5's, so H 1024
// takes a cluster of 16 (non-portable: the launch opts in); two 32-unit
// chunks a warpgroup at 8 CTAs would need 168 KB ring stages (K5's
// layout), and a ring holds at least two. K5's f32 route (kTrain) takes
// the same plan from H 576 to 1024 (9-16 CTAs); its bf16 route 8 CTAs of
// 128 units at H 1024. Nothing here holds a whole h tile: T(h) streams in
// 64-wide k-slabs at every width, so only the cluster grows.
//
// Above 1024 units (and wherever a check forces it) a tile's CTAs form a
// tile group instead of a cluster (kSync, hopper_common.cuh TileSync): 64
// units a CTA in f32, 128 in bf16, so G = H / 64 or H / 128 CTAs a tile,
// more than a cluster holds. The cluster only moved data, so the group
// replaces its `ready` arrival alone:
// - kSyncGroup: after a CTA writes its pieces of step s it adds 1 to its
//   tile's counter in global memory (red.release.gpu); the producer waits
//   (ld.acquire.gpu, bounded: it traps) for G (s + 1) before step s's
//   first A box. The count is monotonic, so nothing resets it. The two
//   parity buffers keep the cluster route's rule: a CTA writes step s + 1's
//   pieces after its product of step s, which waited for every peer's count
//   of step s. Every CTA of a group must be resident at once: the launch is
//   persistent, `groups` groups (at most the CTAs the card holds / G, from
//   the occupancy API), each walking the tiles i, i + groups, ... with its
//   counters and scratch planes indexed by tile. The launch is cooperative
//   (set_tile_launch), so a grid the card cannot hold at once is refused
//   rather than left waiting on a peer that never starts.
// - kSyncStep, for a group the card cannot hold at once: one launch a
//   step, the launch boundary the barrier; a prologue launch writes h0's
//   pieces into parity 0 and h0 into the f32 `carry` (B, H), which each
//   step's launch reads at its start and writes at its end (the kernel's own
//   carry, so the result equals the one-launch routes bit for bit).
// The outputs equal the cluster route's bit for bit at any G. K8's bf16
// layer above 1024 runs here too (kLayer with P 1: its whole 64 x H h tile
// no longer fits gru_layer_hopper.cuh's CTAs), its carry rounded to bf16
// after every step as K8's function asks.
#pragma once

#include "gru_common.cuh"
#include "hopper_common.cuh"

namespace inpaint {
namespace fwd90 {

using namespace sm90;

constexpr int kRows = 64;                    // rows of a tile: one wgmma m64
constexpr int kUnits = 32;                   // units of a chunk
constexpr int kSlabBytes = 3 * kUnits * 128; // a chunk's r, z, n rows x 64 of K: 12 KB
constexpr int kPieceBytes = kRows * 128;     // a 64-wide k-slab of one piece of T(h): 8 KB
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kMaxStages = 6;
constexpr int kMaxCluster = 8;
constexpr int kMaxLayerCluster = 16;         // kLayer's: H 1024 at 64 units a CTA (non-portable)
constexpr int kCarryPad = 8;                 // f32 padding of the carry's rows in shared memory
constexpr int kBar = 1;                      // named barrier of the consumers (2, 3: each warpgroup's)
constexpr int kSmemBudget = 232448 - 2048;

// T's traits: bf16 pieces of the product's operands (1, or 3 of the split),
// the units a CTA may own, pairs of T in and out of memory
template <typename T> struct Fwd;
template <> struct Fwd<float> {
  static constexpr int kPieces = 3, kMaxUnits = 64;
  __device__ static float2 load2(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  __device__ static void pieces(float v, __nv_bfloat16 (&pc)[3]) { split3(v, pc); }
};
__device__ __forceinline__ uint32_t pack_bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <> struct Fwd<__nv_bfloat16> {
  static constexpr int kPieces = 1, kMaxUnits = 128;
  __device__ static float2 load2(const __nv_bfloat16* p) {
    const uint32_t x = __ldg(reinterpret_cast<const unsigned int*>(p));
    return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xFFFF0000u));
  }
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  __device__ static void pieces(float v, __nv_bfloat16 (&pc)[1]) { pc[0] = __float2bfloat16_rn(v); }
};

// what the kernel computes: K5, one of K1's f32 layers, or K8's f32 layer
enum FwdMode { kTrain = 0, kEnc0 = 1, kEnc1 = 2, kLayer = 3 };

struct FwdArgs {
  const void* xw;   // (B, steps, 3H) T; kEnc1: (2, steps * rows, 3H) f32, b_ih added
  const void* bhh;  // (3H,) T; K1: (2, 3H) f32
  const void* h0;   // (B, H) T; K1: unused (zeros)
  void* out;        // (5, steps, B, H) T: ys, r, z, n, hn in original time order;
                    // kLayer: ys (B, steps, H) T, or null (h_n only)
  __nv_bfloat16* scratch;  // (dirs, tiles, 2, P, 64, H): T(h)'s pieces by step parity
  int B, steps, H, reverse, stages;
  // K1 (kEnc0, kEnc1), over the rows [row0, row0 + rows) of B
  const int* tokens;  // (B, steps) int32: kEnc0
  const float* tab;   // (2, V, 3H): kEnc0's input projection table, b_ih folded in
  __nv_bfloat16* ys;  // (3, steps * rows, 2H): kEnc0's outputs' pieces [fwd | bwd]
  float* hn;          // (2, B, H): the layer's h_n [fwd, bwd]; kLayer: (B, H) T
  int row0, rows, V;
  const uint8_t* keep;  // kLayer: (B, steps), 0 holds h at that step; null: every step runs
                        // kEnc0 in training (K1's training mode), else null: the
                        // inter-layer dropout keep mask (B, steps, 2H) [fwd | bwd] of
                        // the GLOBAL rows; the outputs' pieces are keep ? y / keep_div : 0
  float keep_div;       // kEnc0: 1 - rate
  // tile groups (kSyncGroup, kSyncStep; K5 and K8 only)
  unsigned int* counters;  // kSyncGroup: (tiles,) zeros, each tile's arrivals
  float* carry;            // kSyncStep: (B, H) f32, h between launches
  int group;               // CTAs a tile (the cluster's size under kSyncCluster)
  int s_begin, s_end;      // kSyncStep: the processed steps [s_begin, s_end) of this launch;
                           // s_begin == s_end: the prologue (h0 into carry and pieces)
  int fault;               // GroupFault: a planted fault of the group's exchange
};

// bytes of one ring stage: a k-slab of T(h)'s P pieces and of the CTA's
// U / 32 gate slabs in each of W's P pieces
__host__ __device__ __forceinline__ int stage_bytes(int U, int P) {
  return P * kPieceBytes + P * (U / kUnits) * kSlabBytes;
}

// NCH: 32-unit chunks of a consumer warpgroup (U / 64): 1, or 2 in bf16.
// kSync (TileSync): how the CTAs of a tile meet at each step. Under
// kSyncCluster the grid is the tiles' clusters; under kSyncGroup it is
// `gridDim.x / group` groups of `group` CTAs, each walking the tiles i, i +
// groups, ...; under kSyncStep one CTA group a tile runs one step.
template <typename T, int NCH, int kMode, int kSync = kSyncCluster>
__global__ void __launch_bounds__(kThreads, 1)
    gru_fwd_kernel(const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap a_map, const __grid_constant__ FwdArgs p) {
  using F = Fwd<T>;
  constexpr int P = F::kPieces;
  constexpr bool kEnc = kMode == kEnc0 || kMode == kEnc1;
  constexpr bool kClustered = kSync == kSyncCluster;
  static_assert(P == 1 || NCH == 1, "the f32 route's two accumulators fit one chunk");
  static_assert(!kEnc || (P == 3 && kClustered), "K1's layers run the f32 cluster route");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kMaxStages];
  __shared__ __align__(8) uint64_t ready;  // every CTA's pieces of a step's h are written
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  // B: the rows this launch computes (K1: its chunk's)
  const int H = p.H, H3 = 3 * H, B = kEnc ? p.rows : p.B, steps = p.steps, KB = H / 64;
  const int C = kClustered ? (int)cluster_nctarank() : p.group;
  const uint32_t rank = kClustered ? cluster_ctarank() : blockIdx.x % (uint32_t)p.group;
  const int U = H / C, u0 = (int)rank * U, cpc = U / kUnits;
  const int d = kEnc ? (int)blockIdx.y : 0;  // K1's direction: 0 forward, 1 backward
  const bool reverse = kEnc ? d == 1 : p.reverse != 0;
  const int tiles = kClustered ? (int)(gridDim.x / C) : (B + kRows - 1) / kRows;
  const int tile_stride = (int)(gridDim.x / C);  // the tile groups of the launch
  const int s_begin = kSync == kSyncStep ? p.s_begin : 0;
  const int s_end = kSync == kSyncStep ? p.s_end : steps;
  const int fault = kClustered ? kFaultNone : p.fault;
  const int sbytes = stage_bytes(U, P), a_bytes = P * kPieceBytes;
  const int wg = threadIdx.x >> 7;
  constexpr int kStageLd = kUnits * NCH + 8;  // bf16 row stride of an output buffer

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    mbar_init(&ready, C);
    fence_barrier_init();
  }
  __syncthreads();
  if constexpr (kClustered) cluster_sync();  // every CTA's barriers are set before any peer arrives

  if (wg == kConsumers) {  // the producer warp
    if ((threadIdx.x & 31) == 0) {
      int stage = 0;
      uint32_t phase = 0;
      const auto produce = [&](int ti) {
        const int tile = d * tiles + ti;  // the scratch's tile index
        for (int s = s_begin; s < s_end; ++s) {
          const int plane = (tile * 2 + ((s + (fault == kFaultOtherParity)) & 1)) * P;
          for (int k = 0; k < KB; ++k) {
            unsigned char* st = ring + stage * sbytes;
            mbar_wait_bounded<false>(&empty_bar[stage], phase ^ 1);
            mbar_expect_tx(&full_bar[stage], (uint32_t)sbytes);
            tma_load_5d(st + a_bytes, &w_map, &full_bar[stage], 0, 0, k, (int)rank * cpc,
                        d * P);
            if (k == 0) {  // this step's pieces, from every CTA of the tile (under
                           // kSyncStep the launch before this one wrote them)
              if constexpr (kClustered) {
                mbar_wait_bounded<true>(&ready, s & 1);
                fence_proxy_async_global();
              } else if constexpr (kSync == kSyncGroup) {
                group_wait_bounded(p.counters + ti,
                                   (unsigned)(C * (s + 1) - (fault == kFaultCountShort)));
                fence_proxy_async_global();
              }
            }
            tma_load_3d(st, &a_map, &full_bar[stage], k * 64, 0, plane);
            if (++stage == p.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      };
      if constexpr (kClustered)  // one tile: no loop, whose live values spilled
        produce((int)(blockIdx.x / C));
      else
        for (int ti = (int)(blockIdx.x / C); ti < tiles; ti += tile_stride) produce(ti);
    }
    if constexpr (kClustered) cluster_sync();
    return;
  }

  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            q = lane & 3;
  const T* xw = static_cast<const T*>(p.xw);
  const T* bhh = static_cast<const T*>(p.bhh) + d * H3;
  T* out = static_cast<T*>(p.out);
  const size_t plane_out = (size_t)steps * B * H;  // one of the five outputs
  // the f32 carry of the CTA's 64 rows x U units, rows of U + kCarryPad
  const int ld = U + kCarryPad;
  float* carry = reinterpret_cast<float*>(ring + p.stages * sbytes);
  int stage = 0;
  uint32_t phase = 0;

  // The row of step t's input projection of local row `row` (< B): xw's
  // (K5, K1 layer 1: the GEMM's f32 rows), or the table's row of the token
  // (K1 layer 0)
  const auto x_row = [&](int row, int t) -> const T* {
    if constexpr (kMode == kEnc0) {
      const int tok = p.tokens[(size_t)(p.row0 + row) * steps + t];
      return p.tab + ((size_t)d * p.V + min(max(tok, 0), p.V - 1)) * H3;  // never outside
    } else if constexpr (kMode == kEnc1) {
      return xw + ((size_t)d * steps * B + (size_t)t * B + row) * H3;
    } else {
      return xw + ((size_t)row * steps + t) * H3;
    }
  };

  const auto consume = [&](int ti) {
    const int tile0 = ti * kRows;
    const int tile = d * tiles + ti;  // the scratch's tile index

    // The thread's (row, unit) pairs, in every step: chunk wg NCH + ci of the
    // CTA's, units jl = 32 (wg NCH + ci) + 8 n8 + 2q (+ e) among the CTA's,
    // rows r = 16 warp + g + 8 half: the accumulator fragment's.
    // T(h)'s pieces of a pair into the scratch plane of parity `par`
    const auto put_pieces = [&](int par, int r, int jl, float v0, float v1) {
      __nv_bfloat16 a[P], b[P];
      F::pieces(v0, a);
      F::pieces(v1, b);
#pragma unroll
      for (int pi = 0; pi < P; ++pi)
        *reinterpret_cast<__nv_bfloat162*>(
            p.scratch + ((size_t)((tile * 2 + par) * P + pi) * kRows + r) * H + u0 + jl) =
            __halves2bfloat162(a[pi], b[pi]);
    };
    // the pieces are written: make them visible to the peers' TMA loads
    // (async proxy), then tell every CTA of the tile: under kSyncCluster
    // thread c arrives on CTA c's `ready`, under kSyncGroup thread 0 adds 1
    // to the tile's counter (under kSyncStep the launch ends first)
    const auto publish = [&]() {
      __threadfence();
      fence_proxy_async_global();
      named_barrier(kBar, kConsumerThreads);
      if constexpr (kClustered) {
        if (tid < C) mbar_arrive_cluster(mapa(smem_u32(&ready), tid));
      } else if constexpr (kSync == kSyncGroup) {
        if (tid == 0) group_arrive(p.counters + ti);
      }
    };

    // h0 into the carry and its pieces into the scratch of step 0 (kSyncStep:
    // the prologue does that and keeps h in the f32 `carry` between launches)
    const bool prologue = kSync == kSyncStep && s_begin == s_end;
#pragma unroll
    for (int ci = 0; ci < NCH; ++ci)
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * warp + g + 8 * half, row = tile0 + r;
          const int jl = kUnits * (wg * NCH + ci) + 8 * n8 + 2 * q;
          float2 v = make_float2(0.0f, 0.0f);
          if (kSync == kSyncStep && !prologue) {
            if (row < B) v = *reinterpret_cast<const float2*>(p.carry + (size_t)row * H + u0 + jl);
          } else if (row < B && !kEnc) {
            v = F::load2(static_cast<const T*>(p.h0) + (size_t)row * H + u0 + jl);
          }
          *reinterpret_cast<float2*>(carry + r * ld + jl) = v;
          if (kSync != kSyncStep || prologue) put_pieces(s_begin & 1, r, jl, v.x, v.y);
        }
    if constexpr (kSync != kSyncStep) publish();

    for (int s = s_begin; s < s_end; ++s) {
      const int t = reverse ? steps - 1 - s : s;
      const bool last = s == steps - 1;
      // this step's xw rows of the thread's units into L2 while the products
      // run (lanes of q 0: a quad's run of a gate's 32 units; K1's layer-0
      // table stays in L2)
      if (q == 0 && kMode != kEnc0)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = tile0 + 16 * warp + g + 8 * half;
          if (row < B)
#pragma unroll
            for (int ci = 0; ci < NCH; ++ci)
#pragma unroll
              for (int gate = 0; gate < 3; ++gate)
                prefetch_l2(x_row(row, t) + gate * H + u0 + kUnits * (wg * NCH + ci));
        }

      // the product: acc[ci][a] is r, acc[ci][16 + a] z and acc[ci][32 + a]
      // n of chunk ci's (row, unit) a = 4 n8 + 2 half + e
      float acc[NCH][48];
      if constexpr (P == 1) {
        int prev = 0;
        for (int k = 0; k < KB; ++k) {
          unsigned char* st = ring + stage * sbytes;
          mbar_wait_bounded<false>(&full_bar[stage], phase);
          wgmma_fence();
#pragma unroll
          for (int ci = 0; ci < NCH; ++ci)
            mma_slab(acc[ci], desc_sw128(st),
                     desc_sw128(st + a_bytes + (wg * NCH + ci) * kSlabBytes), k > 0);
          wgmma_commit();
          if (k > 0) {
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(&empty_bar[prev]);
          }
          prev = stage;
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(&empty_bar[prev]);
#pragma unroll
        for (int ci = 0; ci < NCH; ++ci) fence_operands(acc[ci]);
      } else {
        // six passes a k-slab into the partial, added into acc with rounded
        // f32 adds once they are done
        float part[48];
        const uint32_t wrow = (uint32_t)(wg * kSlabBytes);
        const int wplane = cpc * kSlabBytes;
        for (int k = 0; k < KB; ++k) {
          unsigned char* st = ring + stage * sbytes;
          mbar_wait_bounded<false>(&full_bar[stage], phase);
          wgmma_fence();
#pragma unroll
          for (int pass = 0; pass < 6; ++pass) {
            // (h piece, W piece), smallest terms first: lh, hl, mm, mh, hm, hh
            const int ap = (0x001102 >> (4 * pass)) & 0xF;
            const int wp = (0x010120 >> (4 * pass)) & 0xF;
            const uint64_t da = desc_sw128(st + ap * kPieceBytes);
            const uint64_t db = desc_sw128(st + a_bytes + wp * wplane + wrow);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_bf16_n96(part, da + 2 * kk, db + 2 * kk, (pass > 0 || kk > 0) ? 1 : 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(part);
          if (lane == 0) mbar_arrive(&empty_bar[stage]);
#pragma unroll
          for (int a = 0; a < 48; ++a)
            acc[0][a] = k == 0 ? part[a] : __fadd_rn(acc[0][a], part[a]);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      if (fault == kFaultCountShort && rank == (uint32_t)(C - 1)) late_rank_pause();

      // the gates, the carry, the five outputs and the next step's pieces
      uint32_t staged[P == 1 ? 5 : 1][NCH][4][2];  // bf16: the outputs' pairs, to the buffer
#pragma unroll
      for (int ci = 0; ci < NCH; ++ci) {
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * warp + g + 8 * half, row = tile0 + r;
            const bool valid = row < B;
            const int jl = kUnits * (wg * NCH + ci) + 8 * n8 + 2 * q, j = u0 + jl;
            float2 x[3], b[3];
            const T* xr = valid ? x_row(row, t) : nullptr;
#pragma unroll
            for (int gate = 0; gate < 3; ++gate) {
              x[gate] = valid ? F::load2(xr + gate * H + j) : make_float2(0.0f, 0.0f);
              b[gate] = F::load2(bhh + gate * H + j);
            }
            float2* cp = reinterpret_cast<float2*>(carry + r * ld + jl);
            const float2 h2 = *cp;
            float o[5][2];  // h', r, z, n, hn of the pair
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int a = 4 * n8 + 2 * half + e;
              const auto pick = [e](float2 v) { return e ? v.y : v.x; };
              const float hr = __fadd_rn(acc[ci][a], pick(b[0]));
              const float hz = __fadd_rn(acc[ci][16 + a], pick(b[1]));
              const float hn = __fadd_rn(acc[ci][32 + a], pick(b[2]));
              const float rg = sigmoid_f(__fadd_rn(pick(x[0]), hr));
              const float zg = sigmoid_f(__fadd_rn(pick(x[1]), hz));
              const float ng = tanhf(__fadd_rn(pick(x[2]), __fmul_rn(rg, hn)));
              o[0][e] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, zg), ng), __fmul_rn(zg, pick(h2)));
              if constexpr (kMode == kLayer && P == 1)  // K8's carry: the parameter dtype
                o[0][e] = __bfloat162float(__float2bfloat16_rn(o[0][e]));
              o[1][e] = rg;
              o[2][e] = zg;
              o[3][e] = ng;
              o[4][e] = hn;
            }
            if constexpr (kMode == kLayer) {  // a held step keeps h: its pieces go on below
              if (valid && p.keep != nullptr && p.keep[(size_t)row * steps + t] == 0) {
                o[0][0] = h2.x;
                o[0][1] = h2.y;
              }
            }
            *cp = make_float2(o[0][0], o[0][1]);
            if constexpr (kEnc) {
              if (valid && kMode == kEnc0) {  // the outputs' pieces, at row t * rows + row
                float y0 = o[0][0], y1 = o[0][1];
                if (p.keep != nullptr) {  // dropped (a true division) before the split;
                  // the carry keeps h. The mask's row is the global row0 + row
                  const uint8_t* kp =
                      p.keep + ((size_t)(p.row0 + row) * steps + t) * 2 * H + d * H + j;
                  y0 = kp[0] ? __fdiv_rn(y0, p.keep_div) : 0.0f;
                  y1 = kp[1] ? __fdiv_rn(y1, p.keep_div) : 0.0f;
                }
                __nv_bfloat16 a[3], b2[3];
                split3(y0, a);
                split3(y1, b2);
                const size_t plane = (size_t)steps * B * 2 * H;
#pragma unroll
                for (int pi = 0; pi < 3; ++pi)
                  *reinterpret_cast<__nv_bfloat162*>(
                      p.ys + pi * plane + ((size_t)t * B + row) * 2 * H + d * H + j) =
                      __halves2bfloat162(a[pi], b2[pi]);
              }
              if (valid && last)
                *reinterpret_cast<float2*>(p.hn + ((size_t)d * p.B + p.row0 + row) * H + j) =
                    make_float2(o[0][0], o[0][1]);
            } else if constexpr (kMode == kLayer) {
              if (valid && p.out != nullptr)
                F::store2(out + ((size_t)row * steps + t) * H + j, o[0][0], o[0][1]);
              if (valid && last)
                F::store2(reinterpret_cast<T*>(p.hn) + (size_t)row * H + j, o[0][0], o[0][1]);
            } else if constexpr (P == 1) {
#pragma unroll
              for (int v = 0; v < 5; ++v)
                staged[v][ci][n8][half] = pack_bf16_pair(o[v][0], o[v][1]);
            } else if (valid) {
              T* dst = out + ((size_t)t * B + row) * H + j;
#pragma unroll
              for (int v = 0; v < 5; ++v) F::store2(dst + v * plane_out, o[v][0], o[v][1]);
            }
            if (!last) put_pieces((s + 1) & 1, r, jl, o[0][0], o[0][1]);
          }
        }
      }
      if constexpr (P == 1 && kMode != kLayer) {
        // output v through the warpgroup's buffer v % 2, then out in 16-byte
        // pieces, a row's NW units contiguous (a later write to the buffer
        // comes after the next barrier, which every reader of it has passed)
        __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(carry + kRows * ld) +
                             wg * 2 * kRows * kStageLd;
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          __nv_bfloat16* buf = stg + (v & 1) * kRows * kStageLd;
#pragma unroll
          for (int ci = 0; ci < NCH; ++ci)
#pragma unroll
            for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
              for (int half = 0; half < 2; ++half)
                *reinterpret_cast<uint32_t*>(buf + (16 * warp + g + 8 * half) * kStageLd +
                                             kUnits * ci + 8 * n8 + 2 * q) =
                    staged[v][ci][n8][half];
          named_barrier(2 + wg, 128);
          constexpr int kPerRow = kUnits * NCH / 8;  // 16-byte pieces of a row
          for (int i = tid & 127; i < kRows * kPerRow; i += 128) {
            const int r = i / kPerRow, c = i % kPerRow, row = tile0 + r;
            if (row < B)
              *reinterpret_cast<uint4*>(out + v * plane_out + ((size_t)t * B + row) * H + u0 +
                                        wg * kUnits * NCH + 8 * c) =
                  *reinterpret_cast<const uint4*>(buf + r * kStageLd + 8 * c);
          }
        }
      }
      if (kSync != kSyncStep && !last) publish();
    }
    if constexpr (kSync == kSyncStep) {  // h for the next launch: the thread's own pairs
#pragma unroll
      for (int ci = 0; ci < NCH; ++ci)
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * warp + g + 8 * half, row = tile0 + r;
            const int jl = kUnits * (wg * NCH + ci) + 8 * n8 + 2 * q;
            if (row < B)
              *reinterpret_cast<float2*>(p.carry + (size_t)row * H + u0 + jl) =
                  *reinterpret_cast<const float2*>(carry + r * ld + jl);
          }
    }
  };
  if constexpr (kClustered)  // one tile: no loop, whose live values spilled
    consume((int)(blockIdx.x / C));
  else
    for (int ti = (int)(blockIdx.x / C); ti < tiles; ti += tile_stride) consume(ti);
  if constexpr (kClustered) cluster_sync();
}

// dynamic shared memory of a K5 block: the ring, the carry (64 rows of U +
// kCarryPad f32), in bf16 the two output buffers of each consumer
// warpgroup (64 rows of U / 2 + 8 bf16), and 1 KB of alignment
inline size_t smem_bytes(int U, int P, int stages) {
  const size_t staging = P == 1 ? (size_t)kConsumers * 2 * kRows * (U / 2 + 8) * 2 : 0;
  return (size_t)stages * stage_bytes(U, P) + (size_t)kRows * (U + kCarryPad) * 4 + staging +
         1024;
}

// the launch's checks: C CTAs (up to max_cluster) owning whole 64-unit
// blocks of at most Fwd<T>::kMaxUnits units each, a ring of 2..kMaxStages
// stages that fits
template <typename T>
inline bool plan_fits(int H, int C, int stages, int max_cluster = kMaxCluster) {
  if (H % 64 != 0 || H <= 0 || C < 1 || C > max_cluster || (H / 64) % C != 0) return false;
  const int U = H / C;
  if (U > Fwd<T>::kMaxUnits || stages < 2 || stages > kMaxStages) return false;
  return smem_bytes(U, Fwd<T>::kPieces, stages) <= (size_t)kSmemBudget;
}

// the W map over the packed pieces (P pieces of H / 32 chunks of H / 64
// k-slabs of 96 x 64 bf16; K1: of each of two directions, direction-major),
// a box of one k-slab of U / 32 consecutive chunks in every piece
inline cudaError_t make_w_map(CUtensorMap* map, const void* packed, int H, int P, int U,
                              int dirs = 1) {
  const uint64_t dims[5] = {64, 3 * kUnits, (uint64_t)(H / 64), (uint64_t)(H / kUnits),
                            (uint64_t)(P * dirs)};
  const uint64_t strides[4] = {128, (uint64_t)kSlabBytes, (uint64_t)(H / 64) * kSlabBytes,
                               (uint64_t)(H / kUnits) * (H / 64) * kSlabBytes};
  const uint32_t box[5] = {64, 3 * kUnits, 1, (uint32_t)(U / kUnits), (uint32_t)P};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, packed, dims, strides, box);
}

// the A map over the scratch: planes of (64 rows, H), a box of one 64-wide
// k-slab of the P pieces
inline cudaError_t make_a_map(CUtensorMap* map, const void* scratch, int H, int P, int tiles) {
  const uint64_t dims[3] = {(uint64_t)H, (uint64_t)kRows, (uint64_t)tiles * 2 * P};
  const uint64_t strides[2] = {(uint64_t)H * 2, (uint64_t)kRows * H * 2};
  const uint32_t box[3] = {64, (uint32_t)kRows, (uint32_t)P};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, scratch, dims, strides, box);
}

// K5 or K8's f32 layer over a.B rows, or one of K1's layers over a.rows
// rows in both directions (grid y). kSyncCluster: a cluster of C CTAs a
// tile; otherwise C = a.group CTAs a tile and `groups` tile groups (the
// persistent kSyncGroup launch; kSyncStep: one a tile)
template <typename T, int NCH, int kMode, int kSync = kSyncCluster>
inline cudaError_t run_k5(const CUtensorMap& w_map, const FwdArgs& a, int C, cudaStream_t stream,
                          int groups = 0) {
  constexpr int P = Fwd<T>::kPieces;
  constexpr bool kEnc = kMode == kEnc0 || kMode == kEnc1;
  constexpr int dirs = kEnc ? 2 : 1;
  const auto kernel = gru_fwd_kernel<T, NCH, kMode, kSync>;
  const int rows = kEnc ? a.rows : a.B;
  const int U = a.H / C, tiles = (rows + kRows - 1) / kRows;
  CUtensorMap a_map;
  cudaError_t err = make_a_map(&a_map, a.scratch, a.H, P, tiles * dirs);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(U, P, a.stages);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (kSync == kSyncCluster && C > kMaxCluster) {  // beyond the portable cluster sizes
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  if (kSync == kSyncGroup && (groups < 1 || groups > tiles)) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((kSync == kSyncGroup ? groups : tiles) * C, dirs, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  set_tile_launch(attr[0], kSync, kSync == kSyncCluster ? C : 1);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, w_map, a_map, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The CTAs of a tile beyond one cluster (K5 and K8 above 1,024 units, or
// any width a check forces there): `sync` kSyncGroup (`groups` persistent
// tile groups) or kSyncStep (a prologue, then one launch a step).
// a.counters: (tiles,) zeros for kSyncGroup; a.carry: (B, H) f32 for
// kSyncStep.
template <typename T, int NCH, int kMode>
inline cudaError_t run_k5_tiles(const CUtensorMap& w_map, FwdArgs a, int sync, int groups,
                                cudaStream_t stream) {
  const int G = a.group;
  if (G < 1 || a.H % G != 0 || a.H / G != 64 * NCH || a.B < 1 || a.steps < 1 ||
      a.scratch == nullptr || a.stages < 2 || a.stages > kMaxStages ||
      smem_bytes(a.H / G, Fwd<T>::kPieces, a.stages) > (size_t)kSmemBudget)
    return cudaErrorInvalidValue;
  if (sync == kSyncGroup) {
    if (a.counters == nullptr) return cudaErrorInvalidValue;
    return run_k5<T, NCH, kMode, kSyncGroup>(w_map, a, G, stream, groups);
  }
  if (sync != kSyncStep || a.carry == nullptr) return cudaErrorInvalidValue;
  for (int s = -1; s < a.steps; ++s) {  // the prologue (s_begin == s_end == 0), then each step
    a.s_begin = s < 0 ? 0 : s;
    a.s_end = s + 1;
    const cudaError_t err = run_k5<T, NCH, kMode, kSyncStep>(w_map, a, G, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// K5's launch: bf16 CTAs of 64 or 128 units in clusters of up to 8; f32
// CTAs of 64 units, so up to 16 at H 1024 (kLayer's non-portable plan)
template <typename T>
inline cudaError_t launch_gru_fwd(const CUtensorMap& w_map, const FwdArgs& a, int C,
                                  cudaStream_t stream) {
  constexpr int kMost = Fwd<T>::kPieces == 3 ? kMaxLayerCluster : kMaxCluster;
  if (!plan_fits<T>(a.H, C, a.stages, kMost) || a.B < 1 || a.steps < 1 || a.scratch == nullptr)
    return cudaErrorInvalidValue;
  switch (a.H / C / 64) {
    case 1: return run_k5<T, 1, kTrain>(w_map, a, C, stream);
    case 2:
      if constexpr (Fwd<T>::kPieces == 1) return run_k5<T, 2, kTrain>(w_map, a, C, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fwd90
}  // namespace inpaint
