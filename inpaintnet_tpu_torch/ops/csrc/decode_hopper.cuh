// The Hopper design of K2's bf16 route (decode_sampling.cu) and of K4
// (decode_sampling_int8.cu): the 24-tick 2-layer tick-GRU argmax decode on
// gru_layer_hopper.cuh's cluster recurrence, one kernel templated on the
// operand type (bf16 or int8). It replaces the TPU kernels
// inpaintnet_tpu/ops/decode_pallas.py decode_sampling_pallas (in bf16) and
// decode_sampling_pallas_int8. K2's f32 route (decode_sampling.cu
// decode_f32_kernel) runs the same tick chain with split products.
//
// What bounds it on an H100: every tick runs a serial chain, layer 0 ->
// layer 1 -> head -> argmax -> the fed-back token, each product a 64-row
// tile by an (H, 3H) weight streamed from L2 (three of them and the (H, 64)
// head: 4.6 MB of bf16 at H 512 a tick, 2.3 MB of int8). The mma.sync
// kernels this replaces walked each product as a chain of dependent L2
// fragment loads; and at 2,048 or 6 rows too few row tiles exist to fill
// the card.
//
// Design, per 64-row tile and cluster of C CTAs (decode_kernel.launch_plan
// picks K2's C from the rows, int8_plan K4's):
// - Each CTA holds the whole h0 and h1 tiles (the A operands, swizzled:
//   2 x 64 KB of bf16 at H 512, 2 x 32 KB of int8) and computes U = H / C
//   units of each layer, its W_hh0, W_ih1 and W_hh1 gate slabs streaming
//   through the consumer warpgroups' TMA rings into wgmma (a producer warp
//   per ring, running ahead across layers and ticks; the rest of the
//   producer warpgroup idles and hands its registers to the consumers,
//   setmaxnreg). Layer 1 takes h0' @ W_ih1 and h1 @ W_hh1 in accumulators
//   of their own, summed in the plain version's order, (x + b_ih1) +
//   (h + b_hh1): one accumulator over K = 2H summed them as ((x + h) +
//   b_ih1) + b_hh1, which drifted from the plain version (PERF.md).
// - After each layer a CTA pushes its k-blocks of the new h to its peers
//   (gru_layer_hopper.cuh write_and_push); the next product waits on the
//   tile's `full` mbarrier. In bf16 the new h is written in place once every
//   CTA's products have read the old one (the `done` mbarrier), so two
//   tiles, not four, fit beside the rings.
// - int8 (K4, decode_i8_kernel): s8 wgmma (m64nNk32, int32 sums, exact).
//   8-bit wgmma takes both operands K-major, so the int8 tiles and slabs use
//   the 64-byte swizzle: one 64-unit block of h is a 64-byte row, as one of
//   bf16 is a 128-byte row, and the packed slabs (decode_kernel.
//   pack_decode_weights, the bf16 route's layout) are 96 x 64 bytes, two a
//   TMA box. Its tiles are half the bf16 ones' bytes, so four fit: each
//   layer's h is double-buffered by tick parity, and a CTA writes its new
//   blocks straight into the other buffer, its own and its peers', with no
//   wait for the cluster to finish reading the old h (no `done` round trip
//   and no registers holding the new h). A peer writes a buffer two ticks
//   after it was last read, and only after it has received this CTA's blocks
//   of the tick between, which this CTA pushed after that read.
// - Every CTA needs the fed-back token, so every CTA recomputes the head
//   and the argmax on its own identical h1: no second exchange. The head is
//   a loop over chunks of 96 vocabulary columns (V zero-padded to whole
//   chunks; a 64 x 48 wgmma tile over H in each warpgroup), each chunk's
//   slabs streaming through the same rings as the layers', so the shared
//   memory plan does not depend on V; a vocabulary of at most 96 is one
//   chunk (head_argmax, today's path). Over more chunks each thread keeps a
//   running (max, index) of its two rows, a later column winning only by a
//   larger logit; then a row's four lanes (two shuffles) and the two
//   warpgroups (shared memory) merge, the lower index winning a tie
//   (gru_layer_hopper.cuh): the first index among equal maxima over the V
//   real columns. CTA 0 of the cluster writes the logits and the tokens.
// - The layers and the head are inlined: as functions of their own that
//   were not inlined they spilled less but took 66% more time (PERF.md).
// - Above H 512 (decode_box_halves, decode_plan_fits; decode_kernel.
//   decode_width): a width of an odd number of 64-unit blocks takes an odd
//   cluster (576: 3 CTAs of 192 units); where two-slab boxes leave fewer
//   than two stages beside the h tiles a box is one k-slab (K2 at 640, K4
//   at 768); and where one-slab boxes do too (K2 at 768: its two bf16 tiles
//   are 192 KB of the 225) a box is half a k-slab, 32 values wide with the
//   64-byte swizzle (HalfFeed, HalfRing), its two k16 steps in a whole
//   slab's order. None of these moves a chunk's sum order or K8's plans.
// - Numerics as K2: products in f32, biases and gates in f32, both carries
//   rounded to bf16 every tick, layer 0's input the fed-back row of tok_tab
//   (x_0's projection at tick 0) plus ctx_xw summed in f32, ReLU logits in
//   f32, written in bf16; both hiddens reset to the beat's init hiddens at
//   t % 6 == 0.
// - Numerics as K4 (decode_kernel.decode_sampling_int8_reference, bit for
//   bit): each row's scale q = 127 / bound, dq = 1 / q (a true division);
//   every product dequantized as ((acc * column scale) * dq) + bias; the
//   gates in f32 on the dequantized carry (int8 * dq); the new carry
//   round_half_even(h * q) clamped to +-127; the fed-back token's
//   projection tok_q[tok] * s_tok rounded to the master dtype T before
//   ctx_xw is added; every multiply and add rounded on its own.
#pragma once

#include <limits.h>
#include <math.h>

#include <type_traits>

#include "gru_layer_hopper.cuh"

namespace inpaint {
namespace rec90 {

constexpr int kTicks = 24;
constexpr int kTicksPerBeat = 6;
constexpr int kHeadCols = 96;  // columns of a head chunk: a 96-row slab, 48 a warpgroup
// a whole producer warpgroup (two warps feed the rings, two idle), so that
// setmaxnreg can hand its registers to the consumers, whose layer 1 holds
// two accumulators
constexpr int kDecodeThreads = kConsumerThreads + 128;
constexpr int kDecodeProducerRegs = 40, kDecodeConsumerRegs = 232;

struct DecodeArgs {
  const __nv_bfloat16* ctx_xw;   // (4, B, 3H): beat-context part of x @ W_ih0, b_ih0 folded in
  const __nv_bfloat16* hi0;      // (4, B, H) per-beat layer-0 init hiddens
  const __nv_bfloat16* hi1;      // (4, B, H) per-beat layer-1 init hiddens
  const __nv_bfloat16* tok_tab;  // (V, 3H): emb @ W_ih0[:E]
  const __nv_bfloat16* x0_xw;    // (3H,): x_0 @ W_ih0[:E], the tick-0 input
  const __nv_bfloat16* bias;     // (3, 3H): b_hh0, b_ih1, b_hh1
  const __nv_bfloat16* head_b;   // (96 NHC,), zero past V
  __nv_bfloat16* logits;         // (B, 24, V)
  int* samples;                  // (B, 24)
  int B, H, V, stages, ties;     // ties: the planted fault (gru_layer_hopper.cuh chunk_at)
};

// chunks of the head: V zero-padded to whole chunks of kHeadCols
__host__ __device__ __forceinline__ int head_chunks(int V) {
  return (V + kHeadCols - 1) / kHeadCols;
}

// K4's: T is the master dtype (ctx_xw, x0_xw and the logits), bf16 or f32
template <typename T>
struct DecodeI8Args {
  const T* ctx_xw;       // (4, B, 3H): beat-context part of x @ W_ih0, b_ih0 folded in
  const int8_t* hi0;     // (4, B, H) per-beat layer-0 init hiddens, quantized at q
  const int8_t* hi1;     // (4, B, H) per-beat layer-1 init hiddens, quantized at q
  const float* q;        // (B,) each row's hidden scale 127 / bound
  const int8_t* tok_q;   // (V, 3H) quantized emb @ W_ih0[:E]
  const T* x0_xw;        // (3H,): x_0 @ W_ih0[:E], the tick-0 input
  const float* scales;   // (4, 3H): column scales of W_hh0, W_ih1, W_hh1, tok_q
  const float* bias;     // (3, 3H) f32: b_hh0, b_ih1, b_hh1
  const float* head_s;   // (96 NHC,) the head's column scales, zero past V
  const float* head_b;   // (96 NHC,) f32, zero past V
  T* logits;             // (B, 24, V)
  int* samples;          // (B, 24)
  int B, H, V, stages, ties;
};

// K2's and K4's boxes: the halves of a 64-value k-slab that a TMA box and
// a ring stage hold beside `tiles` h tiles of `row_bytes` rows (128: bf16,
// 64: K4's int8): box_slabs(H) whole slabs where two stages of them fit, else
// one slab, else (bf16) half of one; 0 where none fits. At H 512 and below
// it is 2 box_slabs(H) (gru_layer_hopper.cuh, K8's).
__host__ __device__ inline int decode_box_halves(int H, int tiles, int row_bytes) {
  const long long free =
      (long long)kSmemBudget - 1024 - (long long)tiles * (H / 64) * kRows * row_bytes;
  const int options[3] = {2 * box_slabs(H), 2, row_bytes == 128 ? 1 : 2};
  for (int i = 0; i < 3; ++i)
    if (free >= 2LL * kConsumers * options[i] * kSlabRows * row_bytes / 2) return options[i];
  return 0;
}

// K2's and K4's dynamic shared memory: `tiles` h tiles and the rings
inline size_t decode_smem_bytes(int H, int tiles, int stages, int row_bytes) {
  return (size_t)tiles * (H / 64) * kRows * row_bytes +
         (size_t)kConsumers * stages * decode_box_halves(H, tiles, row_bytes) * kSlabRows *
             row_bytes / 2 +
         1024;
}

// The launch's checks of K2 and K4: C CTAs (any portable size, odd ones
// too) owning whole 64-unit k-blocks each, at most 8 chunks a consumer
// warpgroup, a ring of 2..kMaxStages stages of decode_box_halves that fits
// beside `tiles` h tiles.
inline bool decode_plan_fits(int H, int C, int stages, int tiles, int row_bytes) {
  if (H % 64 != 0 || H <= 0 || C < 1 || C > kMaxCluster) return false;
  if ((H / 64) % C != 0 || H / C > 8 * kConsumers * kUnits) return false;
  if (stages < 2 || stages > kMaxStages || decode_box_halves(H, tiles, row_bytes) < 1)
    return false;
  return decode_smem_bytes(H, tiles, stages, row_bytes) <= (size_t)kSmemBudget;
}

// The tensor map of K2's (bf16) or K4's (int8) packed weights: `blocks`
// contiguous 96 x 64 k-slabs, loaded decode_box_halves of a slab a box
// (beside two tiles of bf16, four of int8): whole slabs with the 128-byte
// swizzle in bf16 and the 64-byte one in int8, or half slabs (32 bf16
// values, 64 bytes) with the 64-byte swizzle.
inline cudaError_t make_decode_map(CUtensorMap* map, const void* packed, int blocks, int H,
                                   bool int8) {
  const int row_bytes = int8 ? 64 : 128;
  const int kh = decode_box_halves(H, int8 ? 4 : 2, row_bytes);
  if (H % 64 != 0 || H <= 0 || blocks < 1 || kh < 1) return cudaErrorInvalidValue;
  const uint64_t dims[3] = {64, (uint64_t)kSlabRows, (uint64_t)blocks};
  const uint64_t strides[2] = {(uint64_t)row_bytes, (uint64_t)kSlabRows * row_bytes};
  const uint32_t box[3] = {kh == 1 ? 32u : 64u, (uint32_t)kSlabRows, kh == 1 ? 1u : kh / 2u};
  return make_map(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  packed, dims, strides, box,
                  int8 || kh == 1 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

// K2's ring where a stage is half a k-slab (decode_box_halves 1): the
// producer loads each k-slab as two boxes of 32 values of K, one a stage;
// the consumer multiplies each half by its two k16 steps (a whole slab's
// four, in the same order; gru_layer_hopper.cuh HalfFeedT, HalfRingT).
constexpr int kHalfBytes = kSlabBytes / 2;  // 96 rows x 64 bytes: 6 KB
using HalfFeed = HalfFeedT<kHalfBytes>;
using HalfRing = HalfRingT<kHalfBytes>;

// acc (+)= the bf16 h tile `tile` (its nk 64-unit k-blocks) @ the ring's
// next nk k-slabs, each slab's rows from `row0` on (a head half: 48 of 96)
template <int N>
__device__ __forceinline__ void ring_product(Ring& rg, float (&acc)[N],
                                             const unsigned char* tile, int nk, int lane,
                                             int row0 = 0) {
  rg.consume(nk, lane, [&](int kk, unsigned char* slab) {
    mma_slab(acc, desc_sw128(tile + kk * kBlockBytes), desc_sw128(slab + row0 * 128), kk > 0);
  });
}
template <int N>
__device__ __forceinline__ void ring_product(HalfRing& rg, float (&acc)[N],
                                             const unsigned char* tile, int nk, int lane,
                                             int row0 = 0) {
  rg.consume(nk, lane, [&](int kk, int h, unsigned char* half) {
    mma_half(acc, desc_sw128(tile + kk * kBlockBytes), desc_sw64(half + row0 * 64), h,
             kk > 0 || h > 0);
  });
}

// K4's int8 tiles and slabs: rows of 64 bytes (64 units or 64 of K) with
// the 64-byte swizzle
constexpr int kBlockI8 = kRows * 64;      // a 64-unit k-block of an int8 h tile: 4 KB
constexpr int kSlabI8 = kSlabRows * 64;   // a chunk's k-slab of int8 weights: 6 KB
using RingI8 = RingT<kSlabI8>;

// A pair of adjacent T values in registers: one 32-bit load of bf16, one
// 64-bit load of f32.
template <typename T> struct Two;
template <> struct Two<__nv_bfloat16> {
  using V = uint32_t;
  __device__ static V ld(const __nv_bfloat16* p) { return ldg_u32(p); }
  __device__ static float get(V v, int e) { return e ? bf_hi(v) : bf_lo(v); }
};
template <> struct Two<float> {
  using V = float2;
  __device__ static V ld(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }
  __device__ static float get(V v, int e) { return e ? v.y : v.x; }
};

__device__ __forceinline__ float2 ldg_f2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ uint16_t ldg_u16(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float s8_of(uint32_t pair, int e) {  // int8 e of an int8 pair
  return (float)(int8_t)(pair >> (8 * e));
}
__device__ __forceinline__ uint16_t pack_s8(int8_t lo, int8_t hi) {
  return (uint16_t)((uint8_t)lo | ((uint16_t)(uint8_t)hi << 8));
}
// the int8 pair of units (jp, jp + 1) of row r of a K4 h tile, its bytes
__device__ __forceinline__ uint16_t& s8_pair(unsigned char* tile, int r, int jp) {
  return *reinterpret_cast<uint16_t*>(tile + sw64_offset(r, jp, kRows));
}
__device__ __forceinline__ uint32_t old_pair_s8(const unsigned char* tile, int r, int jp) {
  return *reinterpret_cast<const uint16_t*>(tile + sw64_offset(r, jp, kRows));
}

// What every consumer thread of a decode CTA reads in each layer.
struct DecodeCta {
  unsigned char* h0t;  // K2: the layer-0 and layer-1 h tiles (swizzled)
  unsigned char* h1t;
  int* prev_tok;       // each row's fed-back token, -1: x_0
  const float* row_q;  // K4: each row's q and dq = 1 / q (64 rows)
  const float* row_dq;
  int H, KB, tile0, chunk0, nch, wg;
};

// ---------------------------------------------------------------------------
// K2 (bf16)
// ---------------------------------------------------------------------------

// layer 0: xw = the fed-back token's row + the beat context (summed in
// f32); hw = h0 @ W_hh0 + b_hh0
template <int MAXC, typename R>
__device__ __forceinline__ void decode_layer0(const DecodeArgs& p, const DecodeCta& k, R& rg,
                                              const Exchange& ex, int t) {
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            q = lane & 3;
  const int H = k.H, H3 = 3 * H, beat = t / kTicksPerBeat;
  uint32_t hold[MAXC][8];
#pragma unroll
  for (int ci = 0; ci < MAXC; ++ci) {
    const int c = k.wg + ci * kConsumers;
    if (c < k.nch) {
      const int j0 = (k.chunk0 + c) * kUnits;
      // the token's row and the beat context of the thread's two rows and
      // b_hh0, loaded before the products (pairs of bf16; rows past B take
      // the token's row alone, and are never stored)
      uint32_t fv[2][3][4], cv[2][3][4], bv[3][4];
      bool has_ctx[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + g + 8 * half, row = k.tile0 + r;
        const int prev = k.prev_tok[r];
        const __nv_bfloat16* fb =
            (prev < 0 ? p.x0_xw : p.tok_tab + (size_t)prev * H3) + j0 + 2 * q;
        const __nv_bfloat16* ctx = p.ctx_xw + ((size_t)beat * p.B + row) * H3 + j0 + 2 * q;
        has_ctx[half] = row < p.B;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
#pragma unroll
          for (int n8 = 0; n8 < 4; ++n8) {
            fv[half][gate][n8] = ldg_u32(fb + gate * H + 8 * n8);
            cv[half][gate][n8] = has_ctx[half] ? ldg_u32(ctx + gate * H + 8 * n8) : 0u;
          }
      }
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) bv[gate][n8] = ldg_u32(p.bias + gate * H + j0 + 8 * n8 + 2 * q);
      float acc[48];
      ring_product(rg, acc, k.h0t, k.KB, lane);
      fence_operands(acc);
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t old = old_pair(k.h0t, 16 * warp + g + 8 * half, j0 + 8 * n8 + 2 * q);
          float hv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int a = 4 * n8 + 2 * half + e;
            const auto pick = [e](uint32_t v) { return e ? bf_hi(v) : bf_lo(v); };
            float x[3];
#pragma unroll
            for (int gate = 0; gate < 3; ++gate) {
              x[gate] = pick(fv[half][gate][n8]);
              if (has_ctx[half]) x[gate] = __fadd_rn(x[gate], pick(cv[half][gate][n8]));
            }
            hv[e] = gru_gate(x[0], __fadd_rn(acc[a], pick(bv[0][n8])), x[1],
                             __fadd_rn(acc[16 + a], pick(bv[1][n8])), x[2],
                             __fadd_rn(acc[32 + a], pick(bv[2][n8])), pick(old));
          }
          hold[ci][2 * n8 + half] = pack_bf16(hv[0], hv[1]);
        }
      }
    }
  }
  write_and_push(k.h0t, ex, hold, k.wg, k.nch, k.chunk0, t & 1);
  if (ex.C > 1) mbar_wait_bounded<true>(ex.full, t & 1);
}

// layer 1: xw = h0' @ W_ih1 + b_ih1; hw = h1 @ W_hh1 + b_hh1, each product
// in an accumulator of its own
template <int MAXC, typename R>
__device__ __forceinline__ void decode_layer1(const DecodeArgs& p, const DecodeCta& k, R& rg,
                                              const Exchange& ex, int t) {
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            q = lane & 3;
  const int H = k.H, H3 = 3 * H;
  const __nv_bfloat16* bih1 = p.bias + H3;
  const __nv_bfloat16* bhh1 = p.bias + 2 * H3;
  uint32_t hold[MAXC][8];
#pragma unroll
  for (int ci = 0; ci < MAXC; ++ci) {
    const int c = k.wg + ci * kConsumers;
    if (c < k.nch) {
      const int j0 = (k.chunk0 + c) * kUnits + opaque_zero();
      float ax[48], ah[48];
      ring_product(rg, ax, k.h0t, k.KB, lane);
      ring_product(rg, ah, k.h1t, k.KB, lane);
      fence_operands(ax);
      fence_operands(ah);
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int jp = j0 + 8 * n8 + 2 * q;
          const uint32_t old = old_pair(k.h1t, 16 * warp + g + 8 * half, jp);
          float hv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int a = 4 * n8 + 2 * half + e;
            float x[3], h[3];  // (x @ W_ih1 + b_ih1), (h @ W_hh1 + b_hh1) of each gate
#pragma unroll
            for (int gate = 0; gate < 3; ++gate) {
              x[gate] = __fadd_rn(ax[16 * gate + a], bf_pick(ldg_u32(bih1 + gate * H + jp), e));
              h[gate] = __fadd_rn(ah[16 * gate + a], bf_pick(ldg_u32(bhh1 + gate * H + jp), e));
            }
            hv[e] = gru_gate(x[0], h[0], x[1], h[1], x[2], h[2], bf_pick(old, e));
          }
          hold[ci][2 * n8 + half] = pack_bf16(hv[0], hv[1]);
        }
      }
    }
  }
  write_and_push(k.h1t, ex, hold, k.wg, k.nch, k.chunk0, t & 1);
  if (ex.C > 1) mbar_wait_bounded<true>(ex.full, t & 1);
}

// ---------------------------------------------------------------------------
// K4 (int8)
// ---------------------------------------------------------------------------

// K4's exchange of a layer's new h (see the design note): this CTA's
// k-blocks of a buffer, pushed into every peer's same buffer, each push
// completing on that peer's `full` mbarrier of the buffer
struct PushExchange {
  int C;
  uint32_t rank;
  int kb0, nkb;     // this CTA's k-blocks
  uint64_t* full;   // the buffer's: completes when every peer's blocks have landed here
  // every consumer thread, after it wrote its part of the new h into `tile`:
  // hand them to the async proxy; thread p pushes this CTA's blocks to peer
  // p, thread 0 arms `full` for the peers' blocks; then wait for those
  __device__ void publish(unsigned char* tile, uint32_t parity, int tid) const {
    fence_proxy_async();
    named_barrier(kBar, kConsumerThreads);
    if (C == 1) return;
    if (tid < C && tid != (int)rank) {
      const uint32_t bar = mapa(smem_u32(full), tid);
      for (int b = 0; b < nkb; ++b) {
        unsigned char* blk = tile + (kb0 + b) * kBlockI8;
        bulk_copy_to_cluster(mapa(smem_u32(blk), tid), blk, kBlockI8, bar);
      }
    }
    if (tid == 0) mbar_expect_tx(full, (uint32_t)((C - 1) * nkb * kBlockI8));
    mbar_wait_bounded<true>(full, parity);
  }
};

// layer 0 on h0 `hr`, its new h0 into `hw`: xw = T(tok_q[tok] * s_tok)
// (x0_xw at tick 0) + the beat context, in f32; hw = ((acc * s_whh0) * dq)
// + b_hh0; the old carry int8 * dq
template <int MAXC, typename T>
__device__ __forceinline__ void decode_layer0(const DecodeI8Args<T>& p, const DecodeCta& k,
                                              RingI8& rg, const unsigned char* hr,
                                              unsigned char* hw, int t) {
  using Tr = Traits<T>;
  using TT = Two<T>;
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            q = lane & 3;
  const int H = k.H, H3 = 3 * H, beat = t / kTicksPerBeat;
  const float* s_whh0 = p.scales;
  const float* s_tok = p.scales + 3 * H3;
#pragma unroll
  for (int ci = 0; ci < MAXC; ++ci) {
    const int c = k.wg + ci * kConsumers;
    if (c < k.nch) {
      const int j0 = (k.chunk0 + c) * kUnits;
      // the token's int8 row and the beat context of the thread's two rows,
      // loaded before the products (pairs; rows past B take the token's row
      // alone, and are never stored)
      uint16_t tv[2][3][4];
      typename TT::V cv[2][3][4];
      int prev[2];
      bool in[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + g + 8 * half, row = k.tile0 + r;
        prev[half] = k.prev_tok[r];
        in[half] = row < p.B;
        const int8_t* tk = p.tok_q + (size_t)(prev[half] < 0 ? 0 : prev[half]) * H3 + j0 + 2 * q;
        const T* ctx = p.ctx_xw + ((size_t)beat * p.B + (in[half] ? row : 0)) * H3 + j0 + 2 * q;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
#pragma unroll
          for (int n8 = 0; n8 < 4; ++n8) {
            tv[half][gate][n8] = ldg_u16(tk + gate * H + 8 * n8);
            cv[half][gate][n8] = TT::ld(ctx + gate * H + 8 * n8);
          }
      }
      int acc[48];
      rg.consume(k.KB, lane, [&](int kk, unsigned char* slab) {
        mma_slab64(acc, desc_sw64(hr + kk * kBlockI8), desc_sw64(slab), kk > 0);
      });
      fence_operands(acc);
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
        const int jp = j0 + 8 * n8 + 2 * q;
        float2 sw[3], bh[3], st[3];  // the pair's column scales and b_hh0 of each gate
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          sw[gate] = ldg_f2(s_whh0 + gate * H + jp);
          bh[gate] = ldg_f2(p.bias + gate * H + jp);
          st[gate] = ldg_f2(s_tok + gate * H + jp);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * warp + g + 8 * half;
          const float qv = k.row_q[r], dq = k.row_dq[r];
          const uint32_t old = old_pair_s8(hr, r, jp);
          int8_t hq[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int a = 4 * n8 + 2 * half + e;
            const auto pick = [e](float2 v) { return e ? v.y : v.x; };
            float x[3], h[3];
#pragma unroll
            for (int gate = 0; gate < 3; ++gate) {
              const float fb =
                  prev[half] < 0
                      ? Tr::to_f(p.x0_xw[gate * H + jp + e])
                      : Tr::to_f(Tr::from_f(
                            __fmul_rn(s8_of(tv[half][gate][n8], e), pick(st[gate]))));
              x[gate] = in[half] ? __fadd_rn(fb, TT::get(cv[half][gate][n8], e)) : fb;
              h[gate] = dequant(acc[16 * gate + a], pick(sw[gate]), dq, pick(bh[gate]));
            }
            const float hold = __fmul_rn(s8_of(old, e), dq);  // the old carry
            hq[e] = quant_h(gru_gate(x[0], h[0], x[1], h[1], x[2], h[2], hold), qv);
          }
          s8_pair(hw, r, jp) = pack_s8(hq[0], hq[1]);
        }
      }
    }
  }
}

// layer 1 on h0' `h0n` and h1 `hr`, its new h1 into `hw`: xw = ((h0' @
// W_ih1) * s_wih1) * dq + b_ih1; hw = ((h1 @ W_hh1) * s_whh1) * dq + b_hh1,
// each int32 product in an accumulator of its own
template <int MAXC, typename T>
__device__ __forceinline__ void decode_layer1(const DecodeI8Args<T>& p, const DecodeCta& k,
                                              RingI8& rg, const unsigned char* h0n,
                                              const unsigned char* hr, unsigned char* hw) {
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            q = lane & 3;
  const int H = k.H, H3 = 3 * H;
  const float* s_wih1 = p.scales + H3;
  const float* s_whh1 = p.scales + 2 * H3;
  const float* b_ih1 = p.bias + H3;
  const float* b_hh1 = p.bias + 2 * H3;
#pragma unroll
  for (int ci = 0; ci < MAXC; ++ci) {
    const int c = k.wg + ci * kConsumers;
    if (c < k.nch) {
      const int j0 = (k.chunk0 + c) * kUnits + opaque_zero();
      int ax[48], ah[48];
      rg.consume(k.KB, lane, [&](int kk, unsigned char* slab) {
        mma_slab64(ax, desc_sw64(h0n + kk * kBlockI8), desc_sw64(slab), kk > 0);
      });
      rg.consume(k.KB, lane, [&](int kk, unsigned char* slab) {
        mma_slab64(ah, desc_sw64(hr + kk * kBlockI8), desc_sw64(slab), kk > 0);
      });
      fence_operands(ax);
      fence_operands(ah);
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
        const int jp = j0 + 8 * n8 + 2 * q;
        float2 sx[3], sh[3], bx[3], bh[3];
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          const int col = gate * H + jp;
          sx[gate] = ldg_f2(s_wih1 + col);
          sh[gate] = ldg_f2(s_whh1 + col);
          bx[gate] = ldg_f2(b_ih1 + col);
          bh[gate] = ldg_f2(b_hh1 + col);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * warp + g + 8 * half;
          const float qv = k.row_q[r], dq = k.row_dq[r];
          const uint32_t old = old_pair_s8(hr, r, jp);
          int8_t hq[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int a = 4 * n8 + 2 * half + e;
            const auto pick = [e](float2 v) { return e ? v.y : v.x; };
            float x[3], h[3];
#pragma unroll
            for (int gate = 0; gate < 3; ++gate) {
              x[gate] = dequant(ax[16 * gate + a], pick(sx[gate]), dq, pick(bx[gate]));
              h[gate] = dequant(ah[16 * gate + a], pick(sh[gate]), dq, pick(bh[gate]));
            }
            const float hold = __fmul_rn(s8_of(old, e), dq);  // the old carry
            hq[e] = quant_h(gru_gate(x[0], h[0], x[1], h[1], x[2], h[2], hold), qv);
          }
          s8_pair(hw, r, jp) = pack_s8(hq[0], hq[1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The head, chunk hc: warpgroup w takes the logits' columns 96 hc + [48w,
// 48w + 48), a 64 x 48 tile over K = H, in every CTA on its own (identical)
// h1
// ---------------------------------------------------------------------------

// K2: relu(h1 @ W + b) in f32
template <typename R>
__device__ __forceinline__ void head_logits(const DecodeArgs& p, const DecodeCta& k, R& rg,
                                            int hc, float (&lg)[24]) {
  const int col0 = 48 * k.wg, lane = threadIdx.x & 31, q = lane & 3;
  ring_product(rg, lg, k.h1t, k.KB, lane, col0);
  fence_operands(lg);
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const int col = kHeadCols * hc + col0 + 8 * (i >> 2) + 2 * q + (i & 1);
    lg[i] = fmaxf(__fadd_rn(lg[i], __bfloat162float(p.head_b[col])), 0.0f);
  }
}

// K4: relu(((acc * head_s) * dq) + head_b) in f32
template <typename T>
__device__ __forceinline__ void head_logits(const DecodeI8Args<T>& p, const DecodeCta& k,
                                            RingI8& rg, const unsigned char* h1, int hc,
                                            float (&lg)[24]) {
  const int col0 = 48 * k.wg, tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31,
            g = lane >> 2, q = lane & 3;
  int acc[24];
  rg.consume(k.KB, lane, [&](int kk, unsigned char* slab) {
    mma_slab64(acc, desc_sw64(h1 + kk * kBlockI8), desc_sw64(slab + col0 * 64), kk > 0);
  });
  fence_operands(acc);
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const int col = kHeadCols * hc + col0 + 8 * (i >> 2) + 2 * q + (i & 1);
    const float dq = k.row_dq[16 * warp + g + 8 * ((i >> 1) & 1)];
    lg[i] = fmaxf(dequant(acc[i], p.head_s[col], dq, p.head_b[col]), 0.0f);
  }
}

// One chunk's logits lg[i] (row 16 warp + g + 8 ((i / 2) % 2), column c0 +
// 8 (i / 4) + 2q + i % 2, c0 = 96 hc + 48 wg) into the thread's running
// (max, index) of its two rows (a later column only by a larger logit); CTA
// 0 of the cluster writes them (rounded to OutT).
template <typename OutT>
__device__ __forceinline__ void head_chunk(const float (&lg)[24], int c0, OutT* logits, int B,
                                           int V, const DecodeCta& k, uint32_t rank, int t,
                                           float (&best)[2], int (&arg)[2]) {
  using Tr = Traits<OutT>;
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const int half = (i >> 1) & 1, col = c0 + 8 * (i >> 2) + 2 * q + (i & 1);
    if (col < V && lg[i] > best[half]) {
      best[half] = lg[i];
      arg[half] = col;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = k.tile0 + 16 * warp + g + 8 * half;
    if (rank == 0 && row < B) {
      OutT* out = logits + ((size_t)row * kTicks + t) * V;
#pragma unroll
      for (int i = 2 * half; i < 24; i += 4) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * (i >> 2) + 2 * q + e;
          if (col < V) out[col] = Tr::from_f(lg[i + e]);
        }
      }
    }
  }
}

// After the last chunk: a row's bests meet across the four lanes of its
// quad (two shuffles), then across the two warpgroups in shared memory, the
// lower index winning a tie; CTA 0 of the cluster writes the tokens.
__device__ __forceinline__ void head_finish(float (&best)[2], int (&arg)[2], int* samples,
                                            int B, const DecodeCta& k, uint32_t rank, int t,
                                            int ties, float (&best_s)[kConsumers][kRows],
                                            int (&arg_s)[kConsumers][kRows]) {
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    quad_best(best[half], arg[half]);
    const int r = 16 * warp + g + 8 * half;
    if (q == 0) {
      best_s[k.wg][r] = best[half];
      arg_s[k.wg][r] = arg[half];
    }
  }
  named_barrier(kBar, kConsumerThreads);
  if (tid < kRows) {
    const int a = head_beats(best_s[1][tid], arg_s[1][tid], best_s[0][tid], arg_s[0][tid],
                             kHeadCols, ties)
                      ? arg_s[1][tid]
                      : arg_s[0][tid];
    k.prev_tok[tid] = a;
    const int row = k.tile0 + tid;
    if (rank == 0 && row < B) samples[(size_t)row * kTicks + t] = a;
  }
}

// A head of one chunk (V at most 96, the flagship's): the first-index argmax
// of the logits lg[i] (row 16 warp + g + 8 ((i / 2) % 2), column 48 wg + 8
// (i / 4) + 2q + i % 2): a row's 48 columns sit in the four lanes of a quad
// (two shuffles), and the two warpgroups' bests meet in shared memory,
// warpgroup 0's winning ties (its columns come first). CTA 0 of the cluster
// writes the logits (rounded to OutT) and the tokens. The same function as
// head_chunk and head_finish over one chunk, in fewer steps (those were
// slower at one chunk; PERF.md).
template <typename OutT>
__device__ __forceinline__ void head_argmax(const float (&lg)[24], OutT* logits, int* samples,
                                            int B, int V, const DecodeCta& k, uint32_t rank,
                                            int t, float (&best_s)[kConsumers][kRows],
                                            int (&arg_s)[kConsumers][kRows]) {
  using Tr = Traits<OutT>;
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            q = lane & 3;
  const int col0 = 48 * k.wg;
  float best[2] = {-INFINITY, -INFINITY};
  int arg[2] = {INT_MAX, INT_MAX};
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const int half = (i >> 1) & 1, col = col0 + 8 * (i >> 2) + 2 * q + (i & 1);
    if (col < V && lg[i] > best[half]) {  // columns ascend: the first of equal maxima
      best[half] = lg[i];
      arg[half] = col;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the quad holding the row's 48 columns
      const float ob = __shfl_xor_sync(0xffffffffu, best[half], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[half], off);
      if (ob > best[half] || (ob == best[half] && oa < arg[half])) {
        best[half] = ob;
        arg[half] = oa;
      }
    }
    const int r = 16 * warp + g + 8 * half, row = k.tile0 + r;
    if (q == 0) {
      best_s[k.wg][r] = best[half];
      arg_s[k.wg][r] = arg[half];
    }
    if (rank == 0 && row < B) {
      OutT* out = logits + ((size_t)row * kTicks + t) * V;
#pragma unroll
      for (int i = 2 * half; i < 24; i += 4) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * (i >> 2) + 2 * q + e;
          if (col < V) out[col] = Tr::from_f(lg[i + e]);
        }
      }
    }
  }
  named_barrier(kBar, kConsumerThreads);
  if (tid < kRows) {  // warpgroup 1's columns win only by a larger logit
    const int a = best_s[1][tid] > best_s[0][tid] ? arg_s[1][tid] : arg_s[0][tid];
    k.prev_tok[tid] = a;
    const int row = k.tile0 + tid;
    if (rank == 0 && row < B) samples[(size_t)row * kTicks + t] = a;
  }
}

// each row's q and dq (K4; rows past B take q = 127)
template <typename T>
__device__ __forceinline__ void init_row_scale(const DecodeI8Args<T>& p, int r, float* row_q,
                                               float* row_dq) {
  const int row = (int)(blockIdx.x / cluster_nctarank()) * kRows + r;
  const float qv = row < p.B ? p.q[row] : 127.0f;
  row_q[r] = qv;
  row_dq[r] = 1.0f / qv;  // a true division, as the plain version's
}

// The producer warps of a decode CTA, in the consumers' order of use: the
// packed weights the map covers (decode_kernel.pack_decode_weights, bf16 or
// int8) are W_hh0, W_ih1 and W_hh1 as gru_kernel.pack_gate_blocks lays them
// out (H / 32 chunks each of H / 64 contiguous 96 x 64 k-slabs), then the
// head's W^T as `nhc` more chunks: rows 96 hc + [0, 96) of chunk hc are its
// columns, zero rows past V.
template <typename F>
__device__ __forceinline__ void feed_ticks(F& f, int w, int H, int KB, int nch, int chunk0,
                                           int nhc, int ties) {
  const int chunks = H / kUnits;  // the chunks of one packed weight
  for (int t = 0; t < kTicks; ++t) {
    for (int c = w; c < nch; c += kConsumers) f.slabs((chunk0 + c) * KB, KB);
    for (int c = w; c < nch; c += kConsumers) {
      f.slabs((chunks + chunk0 + c) * KB, KB);
      f.slabs((2 * chunks + chunk0 + c) * KB, KB);
    }
    // the head: each warpgroup takes half of each chunk
    for (int j = 0; j < nhc; ++j) f.slabs((3 * chunks + chunk_at(j, nhc, ties)) * KB, KB);
  }
}

// (kHalf: K2's half-slab ring, HalfFeed; `ks` unused)
template <int kSlab, bool kHalf = false>
__device__ __forceinline__ void feed_decode(const CUtensorMap* map, unsigned char* ring,
                                            uint64_t (&full_bar)[kConsumers][kMaxStages],
                                            uint64_t (&empty_bar)[kConsumers][kMaxStages],
                                            int stages, int ks, int H, int KB, int nch,
                                            int chunk0, int nhc, int ties) {
  setmaxnreg_dec<kDecodeProducerRegs>();
  const int w = (threadIdx.x >> 5) & 3;
  if (w < kConsumers && (threadIdx.x & 31) == 0) {
    if constexpr (kHalf) {
      HalfFeed f{map, ring + w * stages * kHalfBytes, full_bar[w], empty_bar[w], stages, 0, 0};
      feed_ticks(f, w, H, KB, nch, chunk0, nhc, ties);
    } else {
      FeedT<kSlab> f{map, ring + w * stages * ks * kSlab, full_bar[w], empty_bar[w], stages, ks,
                     0, 0};
      feed_ticks(f, w, H, KB, nch, chunk0, nhc, ties);
    }
  }
}

// K2. kChunks: the head over more than one chunk (an instantiation of its
// own, so that the one-chunk path keeps today's registers); kHalf: boxes of
// half a k-slab (decode_box_halves 1)
template <int MAXC, bool kChunks, bool kHalf = false>
__global__ void __launch_bounds__(kDecodeThreads, 1)
    decode_kernel(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ DecodeArgs p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kConsumers][kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kConsumers][kMaxStages];
  __shared__ __align__(8) uint64_t h_full[2], h_done[2];
  __shared__ int prev_tok[kRows];
  __shared__ float head_best[kConsumers][kRows];
  __shared__ int head_arg[kConsumers][kRows];
  const int H = p.H, KB = H / 64, ks = decode_box_halves(H, 2, 128) / 2, B = p.B,
            nhc = head_chunks(p.V);
  unsigned char* h0t = align1024(smem_raw);
  unsigned char* h1t = h0t + KB * kBlockBytes;
  unsigned char* ring = h1t + KB * kBlockBytes;
  const int C = (int)cluster_nctarank();
  const uint32_t rank = cluster_ctarank();
  const int U = H / C, nch = U / kUnits, chunk0 = (int)rank * nch;
  const int tile0 = (int)(blockIdx.x / C) * kRows;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int w = 0; w < kConsumers; ++w)
      for (int s = 0; s < p.stages; ++s) {
        mbar_init(&full_bar[w][s], 1);
        mbar_init(&empty_bar[w][s], 4);
      }
    for (int l = 0; l < 2; ++l) {
      mbar_init(&h_full[l], 1);
      mbar_init(&h_done[l], C);
    }
    fence_barrier_init();
  }
  if (threadIdx.x < kRows) prev_tok[threadIdx.x] = -1;
  __syncthreads();
  cluster_sync();

  if (wg == kConsumers) {
    feed_decode<kSlabBytes, kHalf>(&w_map, ring, full_bar, empty_bar, p.stages, ks, H, KB, nch,
                                   chunk0, head_chunks(p.V), p.ties);
    cluster_sync();
    return;
  }

  setmaxnreg_inc<kDecodeConsumerRegs>();
  const int tid = threadIdx.x;
  using R = std::conditional_t<kHalf, HalfRing, Ring>;
  R rg;
  if constexpr (kHalf)
    rg = HalfRing{ring + wg * p.stages * kHalfBytes, full_bar[wg], empty_bar[wg], p.stages, 0, 0};
  else
    rg = Ring{ring + wg * p.stages * ks * kSlabBytes, full_bar[wg], empty_bar[wg], p.stages, ks,
              0, 0};
  const Exchange ex0{C, rank, (int)rank * (U / 64), U / 64, &h_full[0], &h_done[0]};
  const Exchange ex1{C, rank, (int)rank * (U / 64), U / 64, &h_full[1], &h_done[1]};
  const DecodeCta cta{h0t, h1t, prev_tok, nullptr, nullptr, H, KB, tile0, chunk0, nch, wg};

  for (int t = 0; t < kTicks; ++t) {
    const int beat = t / kTicksPerBeat;
    // the last tick's head is done: prev_tok is set and h1 is no longer read
    named_barrier(kBar, kConsumerThreads);
    if (t % kTicksPerBeat == 0) {
      load_h_tile(h0t, p.hi0 + (size_t)beat * B * H, tile0, B, H, tid);
      load_h_tile(h1t, p.hi1 + (size_t)beat * B * H, tile0, B, H, tid);
      fence_proxy_async();
      named_barrier(kBar, kConsumerThreads);
    }
    decode_layer0<MAXC>(p, cta, rg, ex0, t);
    decode_layer1<MAXC>(p, cta, rg, ex1, t);
    if constexpr (!kChunks) {
      float lg[24];
      head_logits(p, cta, rg, 0, lg);
      head_argmax(lg, p.logits, p.samples, B, p.V, cta, rank, t, head_best, head_arg);
    } else {
      float best[2] = {-INFINITY, -INFINITY};
      int arg[2] = {INT_MAX, INT_MAX};
      for (int j = 0; j < nhc; ++j) {
        const int hc = chunk_at(j, nhc, p.ties);
        float lg[24];
        head_logits(p, cta, rg, hc, lg);
        head_chunk(lg, kHeadCols * hc + 48 * wg, p.logits, B, p.V, cta, rank, t, best, arg);
      }
      head_finish(best, arg, p.samples, B, cta, rank, t, p.ties, head_best, head_arg);
    }
  }
  cluster_sync();
}

// K2's launch at C CTAs a tile, by chunks a consumer warpgroup (the
// instantiations of one-chunk heads live in decode_sampling.cu, of chunked
// ones in decode_sampling_chunks.cu)
template <bool kChunks>
inline cudaError_t launch_decode_as(const CUtensorMap& map, const DecodeArgs& a, int C,
                                    int clusters, size_t smem, cudaStream_t stream) {
  switch (chunks_per_warpgroup(a.H, C)) {
    case 1: return launch_clusters(decode_kernel<1, kChunks>, clusters, C, smem, stream, map, a,
                                   kDecodeThreads);
    case 2: return launch_clusters(decode_kernel<2, kChunks>, clusters, C, smem, stream, map, a,
                                   kDecodeThreads);
    case 3:
    case 4: return launch_clusters(decode_kernel<4, kChunks>, clusters, C, smem, stream, map, a,
                                   kDecodeThreads);
    case 5:
    case 6:
    case 7:
    case 8: return launch_clusters(decode_kernel<8, kChunks>, clusters, C, smem, stream, map, a,
                                   kDecodeThreads);
    default: return cudaErrorInvalidValue;
  }
}

// K4: h0 and h1 each in two int8 tiles, tick t reading buffer t % 2 and
// writing buffer (t + 1) % 2; kChunks as K2's
template <typename T, int MAXC, bool kChunks>
__global__ void __launch_bounds__(kDecodeThreads, 1)
    decode_i8_kernel(const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ DecodeI8Args<T> p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kConsumers][kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kConsumers][kMaxStages];
  __shared__ __align__(8) uint64_t h_full[2][2];  // [layer][buffer]
  __shared__ int prev_tok[kRows];
  __shared__ float row_q[kRows], row_dq[kRows];
  __shared__ float head_best[kConsumers][kRows];
  __shared__ int head_arg[kConsumers][kRows];
  const int H = p.H, KB = H / 64, ks = decode_box_halves(H, 4, 64) / 2, B = p.B,
            nhc = head_chunks(p.V);
  unsigned char* h0t[2];
  unsigned char* h1t[2];
  h0t[0] = align1024(smem_raw);
  h0t[1] = h0t[0] + KB * kBlockI8;
  h1t[0] = h0t[1] + KB * kBlockI8;
  h1t[1] = h1t[0] + KB * kBlockI8;
  unsigned char* ring = h1t[1] + KB * kBlockI8;
  const int C = (int)cluster_nctarank();
  const uint32_t rank = cluster_ctarank();
  const int U = H / C, nch = U / kUnits, chunk0 = (int)rank * nch;
  const int tile0 = (int)(blockIdx.x / C) * kRows;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int w = 0; w < kConsumers; ++w)
      for (int s = 0; s < p.stages; ++s) {
        mbar_init(&full_bar[w][s], 1);
        mbar_init(&empty_bar[w][s], 4);
      }
    for (int l = 0; l < 2; ++l)
      for (int b = 0; b < 2; ++b) mbar_init(&h_full[l][b], 1);
    fence_barrier_init();
  }
  if (threadIdx.x < kRows) {
    prev_tok[threadIdx.x] = -1;
    init_row_scale(p, threadIdx.x, row_q, row_dq);
  }
  __syncthreads();
  cluster_sync();

  if (wg == kConsumers) {
    feed_decode<kSlabI8>(&w_map, ring, full_bar, empty_bar, p.stages, ks, H, KB, nch, chunk0,
                         head_chunks(p.V), p.ties);
    cluster_sync();
    return;
  }

  setmaxnreg_inc<kDecodeConsumerRegs>();
  const int tid = threadIdx.x;
  RingI8 rg{ring + wg * p.stages * ks * kSlabI8, full_bar[wg], empty_bar[wg], p.stages, ks, 0, 0};
  const DecodeCta cta{nullptr, nullptr, prev_tok, row_q, row_dq, H, KB, tile0, chunk0, nch, wg};
  const int kb0 = (int)rank * (U / 64);

  for (int t = 0; t < kTicks; ++t) {
    const int beat = t / kTicksPerBeat, rb = t & 1, wb = rb ^ 1;
    const uint32_t parity = (uint32_t)(t >> 1) & 1;  // buffer wb's uses so far, mod 2
    // the last tick's head is done: prev_tok is set
    named_barrier(kBar, kConsumerThreads);
    if (t % kTicksPerBeat == 0) {  // t even: the read buffers are 0
      load_h_tile(h0t[rb], p.hi0 + (size_t)beat * B * H, tile0, B, H, tid);
      load_h_tile(h1t[rb], p.hi1 + (size_t)beat * B * H, tile0, B, H, tid);
      fence_proxy_async();
      named_barrier(kBar, kConsumerThreads);
    }
    decode_layer0<MAXC>(p, cta, rg, h0t[rb], h0t[wb], t);
    PushExchange{C, rank, kb0, U / 64, &h_full[0][wb]}.publish(h0t[wb], parity, tid);
    decode_layer1<MAXC>(p, cta, rg, h0t[wb], h1t[rb], h1t[wb]);
    PushExchange{C, rank, kb0, U / 64, &h_full[1][wb]}.publish(h1t[wb], parity, tid);
    if constexpr (!kChunks) {
      float lg[24];
      head_logits(p, cta, rg, h1t[wb], 0, lg);
      head_argmax(lg, p.logits, p.samples, B, p.V, cta, rank, t, head_best, head_arg);
    } else {
      float best[2] = {-INFINITY, -INFINITY};
      int arg[2] = {INT_MAX, INT_MAX};
      for (int j = 0; j < nhc; ++j) {
        const int hc = chunk_at(j, nhc, p.ties);
        float lg[24];
        head_logits(p, cta, rg, h1t[wb], hc, lg);
        head_chunk(lg, kHeadCols * hc + 48 * wg, p.logits, B, p.V, cta, rank, t, best, arg);
      }
      head_finish(best, arg, p.samples, B, cta, rank, t, p.ties, head_best, head_arg);
    }
  }
  cluster_sync();
}

// K4's dynamic shared memory: four int8 h tiles and the rings
inline size_t decode_i8_smem_bytes(int H, int stages) {
  return decode_smem_bytes(H, 4, stages, 64);
}

template <typename T, bool kChunks>
inline cudaError_t launch_decode_i8_as(const CUtensorMap& map, const DecodeI8Args<T>& a, int C,
                                       int clusters, size_t smem, cudaStream_t stream) {
  switch (chunks_per_warpgroup(a.H, C)) {
    case 1: return launch_clusters(decode_i8_kernel<T, 1, kChunks>, clusters, C, smem, stream, map,
                                   a, kDecodeThreads);
    case 2: return launch_clusters(decode_i8_kernel<T, 2, kChunks>, clusters, C, smem, stream, map,
                                   a, kDecodeThreads);
    case 3:
    case 4: return launch_clusters(decode_i8_kernel<T, 4, kChunks>, clusters, C, smem, stream, map,
                                   a, kDecodeThreads);
    case 5:
    case 6:
    case 7:
    case 8: return launch_clusters(decode_i8_kernel<T, 8, kChunks>, clusters, C, smem, stream, map,
                                   a, kDecodeThreads);
    default: return cudaErrorInvalidValue;
  }
}

// K4's launchers of a head of more than one chunk: decode_sampling_int8_chunks.cu
// instantiates decode_i8_kernel<T, MAXC, true> in a source of its own, built
// beside decode_sampling_int8.cu in parallel (together they were the build's
// longest source)
cudaError_t launch_decode_i8_chunks(const CUtensorMap& map, const DecodeI8Args<float>& a, int C,
                                    int clusters, size_t smem, cudaStream_t stream);
cudaError_t launch_decode_i8_chunks(const CUtensorMap& map, const DecodeI8Args<__nv_bfloat16>& a,
                                    int C, int clusters, size_t smem, cudaStream_t stream);

template <typename T>
inline cudaError_t launch_decode_i8(const CUtensorMap& map, const DecodeI8Args<T>& a, int C,
                                    cudaStream_t stream) {
  if (!decode_plan_fits(a.H, C, a.stages, 4, 64) || a.B < 1 || a.V < 1)
    return cudaErrorInvalidValue;
  const int clusters = (a.B + kRows - 1) / kRows;
  const size_t smem = decode_i8_smem_bytes(a.H, a.stages);
  return head_chunks(a.V) > 1 ? launch_decode_i8_chunks(map, a, C, clusters, smem, stream)
                              : launch_decode_i8_as<T, false>(map, a, C, clusters, smem, stream);
}

}  // namespace rec90
}  // namespace inpaint
