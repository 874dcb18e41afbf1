// The Hopper design of K7's bf16 route (arnn_decode.cu): the
// AnticipationRNN's argmax decode as a cluster recurrence, K2's design
// (decode_hopper.cuh) carried to the 2-layer LSTM. It replaces, in bf16,
// the TPU kernel inpaintnet_tpu/ops/arnn_pallas.py
// arnn_sampled_decode_pallas (_arnn_kernel).
//
// What bounds it on an H100: a serial chain of 384 ticks, each layer 0 ->
// layer 1 -> head -> argmax -> the fed-back token, over 2.2 MB of bf16
// weights a tick at the flagship's H = C = L = 256. The first kernel
// (arnn_decode.cu, now the f32 route) walked each product as a chain of
// dependent L2 fragment loads in one block of 32 rows (about 92 us a tick
// at 1, 64 or 512 rows), 16 blocks at batch 512.
//
// Design (arnn_kernel.arnn_plan picks the cluster size C from the rows):
// - The context product ctx_t @ W_ctx does not depend on the recurrence: the
//   wrapper runs it first for every tick as one TMA + wgmma GEMM
//   (encoder_hopper.cuh launch_proj_gemm), in f32, and the tick adds its row
//   in the plain version's order: (prev_xw + ctx_t @ W_ctx) + b_ih0.
// - C CTAs share a 64-row tile; each computes U = H / C units of both
//   layers from its own W^T slabs, packed in 4-gate blocks (32 units x
//   [i, f, g, o] = 128 rows x 64 of K: 16 KB, arnn_kernel.pack_lstm_blocks),
//   streamed through a TMA ring per consumer warpgroup into wgmma (a
//   producer warp per ring, running ahead across layers and ticks). Layer
//   1 streams a chunk's W_ih1 slabs, then its W_hh1 slabs, each product
//   into an accumulator of its own: one accumulator over K = 2H drifted
//   further from the plain version than the first kernel (the tensor cores'
//   f32 sums are not rounded to nearest, and the sum's order was another).
// - Every CTA holds both layers' whole h tiles (the A operands) and pushes
//   its 64-unit blocks of each new h to its peers after each layer
//   (gru_layer_hopper.cuh write_and_push). The c carries of its own units
//   stay in its shared memory, read and written by the thread that owns
//   each (row, unit).
// - The head: every CTA recomputes it on its identical h1 (so every CTA
//   reaches the same token with no exchange): relu(h1 @ W_l1 + b_l1), 128
//   hidden columns a warpgroup chunk, rounded to bf16 into a shared tile of
//   HT columns; then that tile @ W_out + b_out by chunks of 64 vocabulary
//   columns (V zero-padded to whole chunks), warpgroup w taking the columns
//   [32w, 32w + 32) of every chunk, each streaming its own half in blocks
//   of four k-slabs where HT is whole 256-column blocks or the whole head
//   (arnn_kernel.arnn_out_kslabs), else blocks of two k-slabs of the whole
//   chunk through both rings. One chunk on the whole hidden row (V at most
//   64) takes the one-chunk path of the flagship. HT is the whole
//   padded head width LP where that fits beside the h tiles and rings
//   (arnn_kernel.arnn_hid_cols), else a part of it: then the hidden tile is
//   computed in LP / HT rounds, each chunk's logits accumulating over the
//   rounds in the same wgmma order, and recomputed for each chunk. Each
//   thread keeps a running (max, index) of its rows across the chunks, then
//   a quad's shuffles and the two warpgroups in shared memory merge them,
//   the lower index winning a tie (gru_layer_hopper.cuh): the first index
//   among equal maxima over the V real columns; after the last chunk the
//   force mask; CTA 0 writes the logits and the tokens.
// - Numerics as the f32 route's kernel: products in f32 (layer 0's and
//   W_ih1's over more than 256 values of K as partials of kSumSlabs
//   k-slabs added in rounded f32), biases and gates
//   in f32, both layers' h and c rounded to bf16 every tick, the head's
//   hidden rounded to bf16, unbounded f32 logits written in bf16. Rows past
//   B run on the token table alone and are never stored.
// - Above 512 units (H 576 and 640, arnn_kernel.arnn_box_halves) two h
//   tiles of 64 x H leave no cluster size room for rings of whole 16 KB
//   k-slabs beside the hidden tile and the c carries (H 640 on 10 CTAs:
//   263,168 bytes against 230,400). There (kHalf) a box and a ring stage
//   hold half a k-slab, 32 values of K with the 64-byte swizzle
//   (gru_layer_hopper.cuh HalfFeedT, HalfRingT), a consumer issuing its two
//   k16 steps a half (box_mma), and a cluster of 9 or 10 CTAs, past the
//   portable 8, gives each CTA 64 units: one chunk a consumer warpgroup, c
//   carries of 16 KB. H 640 then takes the budget exactly with two stages.
#pragma once

#include <limits.h>
#include <math.h>

#include <type_traits>

#include "gru_layer_hopper.cuh"

namespace inpaint {

// torch's LSTM cell from its four gate pre-activations (biases added) and
// the previous c, in f32, each multiply and add rounded on its own in the
// order of the plain version's tensor ops (kernel_common.lstm_gates_f32).
__device__ __forceinline__ void lstm_gate(const float (&gate)[4], float c, float& h_out,
                                          float& c_out) {
  const float i = sigmoid_f(gate[0]);
  const float f = sigmoid_f(gate[1]);
  const float g = tanhf(gate[2]);
  const float o = sigmoid_f(gate[3]);
  c_out = __fadd_rn(__fmul_rn(f, c), __fmul_rn(i, g));
  h_out = __fmul_rn(o, tanhf(c_out));
}

namespace rec90 {

constexpr int kLstmRows = 4 * kUnits;              // a chunk's i, f, g, o rows: the wgmma N
constexpr int kLstmSlabBytes = kLstmRows * 128;    // one k-slab of a chunk: 16 KB
constexpr int kLstmHalfBytes = kLstmSlabBytes / 2; // half of one, 32 values of K: 8 KB
constexpr int kMaxArnnCluster = 16;                // the non-portable sizes an H100 takes
constexpr int kHidCols = 128;                      // hidden columns of a head chunk
constexpr int kOutCols = 64;                       // vocabulary columns of an output chunk
// a whole producer warpgroup (two warps feed the rings, two idle), so that
// setmaxnreg can hand its registers to the consumers: 232 each, where the
// launch's 384 threads leave 168, and layer 1's two 64 x 128 accumulators
// spilled
constexpr int kArnnThreads = kConsumerThreads + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

struct ArnnArgs {
  const float* xwc;              // (B, S, 4H): ctx @ W_ctx, f32
  const int* score;              // (B, S) ground-truth tokens
  const int* force;              // (B, S) 1 where the token is forced
  const __nv_bfloat16* tok_tab;  // (n_tok, 4H): emb @ W_ih0[:E]
  const __nv_bfloat16* start_xw; // (4H,): the tick-0 input
  const __nv_bfloat16* bias;     // (4, 4H): b_ih0, b_hh0, b_ih1, b_hh1
  const __nv_bfloat16* b_l1;     // (LP,), zero past the head's width
  const __nv_bfloat16* b_out;    // (64 NOC,), zero past V
  __nv_bfloat16* logits;         // (B, S, V)
  int* tokens;                   // (B, S)
  int B, S, H, LP, HT, V, stages, ties;  // HT: the hidden tile's width; ties: chunk_at's
  int OK;                        // k-slabs of a W_out^T block: 4 or 2 (arnn_out_kslabs)
};

// output chunks of the head: V zero-padded to whole chunks of kOutCols
__host__ __device__ __forceinline__ int out_chunks(int V) {
  return (V + kOutCols - 1) / kOutCols;
}

// what every consumer thread of a K7 CTA reads in each stage of a tick
struct ArnnCta {
  unsigned char* h0t;   // the layer-0 and layer-1 h tiles (swizzled bf16)
  unsigned char* h1t;
  unsigned char* hid;   // the head's hidden tile (swizzled bf16)
  uint32_t* c0;         // (64, U / 2): bf16 pairs of this CTA's layer-0 c
  uint32_t* c1;
  int* prev_tok;        // each row's fed-back token, -1: start_xw
  int H, KB, U, tile0, chunk0, nch, wg;
};

// A consumer warpgroup's ring and its producer's feed: boxes of a whole
// k-slab, or (kHalf) of half of one
template <bool kHalf>
using LstmRing = std::conditional_t<kHalf, HalfRingT<kLstmHalfBytes>, RingT<kLstmSlabBytes>>;
template <bool kHalf>
using LstmFeed = std::conditional_t<kHalf, HalfFeedT<kLstmHalfBytes>, FeedT<kLstmSlabBytes>>;
template <bool kHalf>
constexpr int kLstmBoxBytes = kHalf ? kLstmHalfBytes : kLstmSlabBytes;

// `products(k, h, box)` for the boxes of the ring's next nk k-slabs: box h
// of k-slab k (h 0, the whole slab; with half boxes, h 0 and 1)
template <typename Products>
__device__ __forceinline__ void each_box(RingT<kLstmSlabBytes>& rg, int nk, int lane,
                                         Products products) {
  rg.consume(nk, lane, [&](int k, unsigned char* box) { products(k, 0, box); });
}
template <typename Products>
__device__ __forceinline__ void each_box(HalfRingT<kLstmHalfBytes>& rg, int nk, int lane,
                                         Products products) {
  rg.consume(nk, lane, products);
}

// acc (+)= the 128-byte-swizzled k-block `a` (64 rows x 64 of K) @ the
// box's rows from row0 on: the whole k-slab's four k16 steps, or (kHalf)
// half h's two, 64-byte swizzled, in a whole slab's k16 order
template <bool kHalf, int N>
__device__ __forceinline__ void box_mma(float (&acc)[N], const unsigned char* a,
                                        const unsigned char* box, int row0, int h,
                                        bool accumulate) {
  if constexpr (kHalf)
    mma_half(acc, desc_sw128(a), desc_sw64(box + row0 * 64), h, accumulate || h > 0);
  else
    mma_slab(acc, desc_sw128(a), desc_sw128(box + row0 * 128), accumulate);
}

// k-slabs of an LSTM product that the tensor cores sum into one partial
// (256 values of K, the flagship's whole sum); the partials are added in
// rounded f32. Their own sum over 640 values of K in one accumulator
// drifts from the plain version's IEEE f32 sums toward zero (PERF.md).
constexpr int kSumSlabs = 4;

// acc = the A tile `a` (64 rows x nk k-slabs of 64) @ the ring's next nk
// k-slabs, in partials of kSumSlabs k-slabs summed in `part` (free
// registers of the caller's)
template <bool kHalf>
__device__ __forceinline__ void lstm_product(LstmRing<kHalf>& rg, float (&acc)[64],
                                             float (&part)[64], const unsigned char* a, int nk,
                                             int lane) {
  each_box(rg, nk < kSumSlabs ? nk : kSumSlabs, lane, [&](int kk, int h, unsigned char* box) {
    box_mma<kHalf>(acc, a + kk * kBlockBytes, box, 0, h, kk > 0);
  });
  fence_operands(acc);
  for (int k0 = kSumSlabs; k0 < nk; k0 += kSumSlabs) {
    each_box(rg, nk - k0 < kSumSlabs ? nk - k0 : kSumSlabs, lane,
             [&](int kk, int h, unsigned char* box) {
               box_mma<kHalf>(part, a + (k0 + kk) * kBlockBytes, box, 0, h, kk > 0);
             });
    fence_operands(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }
}

// The LSTM cells of a chunk's 64 rows x 32 units: `pre(gi, n8, a, e)` is
// gate gi's pre-activation of the thread's (row half, unit) a = 4 n8 + 2 half
// + e (unit j0 + 8 n8 + 2q + e of row 16 warp + g + 8 half; in a chunk's
// 64 x 128 accumulator gate gi sits at 16 gi + a). The c carries are read
// from and written to `c` (64 rows x U units of bf16, this CTA's units, as
// pairs; the chunk's first unit is `uc`); the new h pairs go to `hold`.
template <typename Pre>
__device__ __forceinline__ void lstm_epilogue(Pre pre, uint32_t* c, int U, int uc,
                                              uint32_t (&hold)[8]) {
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
  // every c first, every cell next, the new c last: a store between two
  // cells would keep the next cell's c load, and so its math, behind it
  uint32_t c_old[4][2], c_new[4][2];
#pragma unroll
  for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      c_old[n8][half] = c[(16 * warp + g + 8 * half) * (U / 2) + (uc + 8 * n8 + 2 * q) / 2];
#pragma unroll
  for (int n8 = 0; n8 < 4; ++n8) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float hv[2], cv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float gate[4];
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) gate[gi] = pre(gi, n8, 4 * n8 + 2 * half + e, e);
        const uint32_t co = c_old[n8][half];
        lstm_gate(gate, e ? bf_hi(co) : bf_lo(co), hv[e], cv[e]);
      }
      c_new[n8][half] = pack_bf16(cv[0], cv[1]);
      hold[2 * n8 + half] = pack_bf16(hv[0], hv[1]);
    }
  }
#pragma unroll
  for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      c[(16 * warp + g + 8 * half) * (U / 2) + (uc + 8 * n8 + 2 * q) / 2] = c_new[n8][half];
}

// layer 0: gates = ((prev_xw + ctx_t @ W_ctx) + b_ih0) + (h0 @ W_hh0 + b_hh0)
template <int MAXC, bool kHalf>
__device__ __forceinline__ void arnn_layer0(const ArnnArgs& p, const ArnnCta& k,
                                            LstmRing<kHalf>& rg, const Exchange& ex, int t) {
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            q = lane & 3;
  const int H = k.H, H4 = 4 * H;
  const __nv_bfloat16* bih = p.bias;
  const __nv_bfloat16* bhh = p.bias + H4;
  uint32_t hold[MAXC][8];
#pragma unroll
  for (int ci = 0; ci < MAXC; ++ci) {
    const int c = k.wg + ci * kConsumers;
    if (c < k.nch) {
      const int j0 = (k.chunk0 + c) * kUnits + opaque_zero();
      // the thread's two rows: their fed-back token rows and context
      // projection rows, pulled into L2 while the products run (lanes of q
      // 0: a quad's 8 units of a gate; the chunk's 32 are 128 bytes of f32)
      const __nv_bfloat16* fb[2];
      const float* px[2];
      bool in[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + g + 8 * half, row = k.tile0 + r;
        in[half] = row < p.B;
        const int prev = k.prev_tok[r];
        fb[half] = prev < 0 ? p.start_xw : p.tok_tab + (size_t)prev * H4;
        px[half] = p.xwc + ((size_t)(in[half] ? row : 0) * p.S + t) * H4;
        if (q == 0)
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) {
            prefetch_l2(px[half] + gi * H + j0);
            prefetch_l2(fb[half] + gi * H + j0);
          }
      }
      float acc[64], part[64];
      lstm_product<kHalf>(rg, acc, part, k.h0t, k.KB, lane);
      lstm_epilogue(
          [&](int gi, int n8, int a, int e) {
            // ((the fed-back row + the context projection) + b_ih0) + (acc + b_hh0)
            const int half = (a >> 1) & 1, col = gi * H + j0 + 8 * n8 + 2 * q;
            const float f = bf_pick(ldg_u32(fb[half] + col), e);
            const float x = in[half] ? __fadd_rn(f, __ldg(px[half] + col + e)) : f;
            const float xw = __fadd_rn(x, bf_pick(ldg_u32(bih + col), e));
            return __fadd_rn(xw, __fadd_rn(acc[16 * gi + a], bf_pick(ldg_u32(bhh + col), e)));
          },
          k.c0, k.U, c * kUnits, hold[ci]);
    }
  }
  write_and_push(k.h0t, ex, hold, k.wg, k.nch, k.chunk0, t & 1);
  if (ex.C > 1) mbar_wait_bounded<true>(ex.full, t & 1);
}

// layer 1: gates = (h0' @ W_ih1 + b_ih1) + (h1 @ W_hh1 + b_hh1), the two
// products in accumulators of their own, summed in the plain version's
// order
template <int MAXC, bool kHalf>
__device__ __forceinline__ void arnn_layer1(const ArnnArgs& p, const ArnnCta& k,
                                            LstmRing<kHalf>& rg, const Exchange& ex, int t) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int H = k.H, H4 = 4 * H;
  const __nv_bfloat16* bih = p.bias + 2 * H4;
  const __nv_bfloat16* bhh = p.bias + 3 * H4;
  uint32_t hold[MAXC][8];
#pragma unroll
  for (int ci = 0; ci < MAXC; ++ci) {
    const int c = k.wg + ci * kConsumers;
    if (c < k.nch) {
      const int j0 = (k.chunk0 + c) * kUnits + opaque_zero();
      // W_ih1's product in partials, their sums in ah's registers before
      // W_hh1's product takes them in one accumulator: a third 64 x 128
      // accumulator spilled (PERF.md)
      float ax[64], ah[64];
      lstm_product<kHalf>(rg, ax, ah, k.h0t, k.KB, lane);
      each_box(rg, k.KB, lane, [&](int kk, int h, unsigned char* box) {
        box_mma<kHalf>(ah, k.h1t + kk * kBlockBytes, box, 0, h, kk > 0);
      });
      fence_operands(ah);
      lstm_epilogue(
          [&](int gi, int n8, int a, int e) {
            const int col = gi * H + j0 + 8 * n8 + 2 * q;
            const uint32_t bi = ldg_u32(bih + col), bh = ldg_u32(bhh + col);
            return __fadd_rn(__fadd_rn(ax[16 * gi + a], bf_pick(bi, e)),
                             __fadd_rn(ah[16 * gi + a], bf_pick(bh, e)));
          },
          k.c1, k.U, c * kUnits, hold[ci]);
    }
  }
  write_and_push(k.h1t, ex, hold, k.wg, k.nch, k.chunk0, t & 1);
  if (ex.C > 1) mbar_wait_bounded<true>(ex.full, t & 1);
}

// The head and the argmax with the force mask, in every CTA on its own
// (identical) h1. CTA 0 of the cluster writes the logits and the tokens.
// kChunks: more than one output chunk or hidden round (else the one-chunk
// path, in an instantiation of its own that keeps today's registers).
template <bool kChunks, bool kHalf>
__device__ __forceinline__ void arnn_head(const ArnnArgs& p, const ArnnCta& k,
                                          LstmRing<kHalf>& rg, uint32_t rank, int t,
                                          float (&best_s)[kConsumers][kRows],
                                          int (&arg_s)[kConsumers][kRows]) {
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            q = lane & 3;
  const int rounds = p.LP / p.HT, RC = p.HT / kHidCols, HB = p.HT / 64;
  const int NOC = out_chunks(p.V);
  if constexpr (!kChunks) {
    // one output chunk (V at most 64, the flagship's) on the whole hidden
    // row (OK 4): the same function as the general path below, in fewer
    // steps (the general path was slower at one chunk; PERF.md)
    const int LC = p.LP / kHidCols, LB = p.LP / 64;
    // relu(h1 @ W_l1 + b_l1), rounded to bf16, into the hidden tile
    for (int lc = k.wg; lc < LC; lc += kConsumers) {
      float acc[64];
      each_box(rg, k.KB, lane, [&](int kk, int h, unsigned char* box) {
        box_mma<kHalf>(acc, k.h1t + kk * kBlockBytes, box, 0, h, kk > 0);
      });
      fence_operands(acc);
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
        const int col = lc * kHidCols + 8 * (i >> 2) + 2 * q;
        const uint32_t b = ldg_u32(p.b_l1 + col);
        *reinterpret_cast<uint32_t*>(k.hid + sw128_offset(r, col * 2, kRows)) =
            pack_bf16(fmaxf(__fadd_rn(acc[i], bf_lo(b)), 0.0f),
                      fmaxf(__fadd_rn(acc[i + 1], bf_hi(b)), 0.0f));
      }
    }
    fence_proxy_async();
    named_barrier(kBar, kConsumerThreads);
    // the logits: warpgroup w takes the columns [32w, 32w + 32), four k-slabs
    // of them a 128-row block (its own blocks of W_out^T)
    const int col0 = 32 * k.wg;
    float lg[16];
    each_box(rg, (LB + 3) / 4, lane, [&](int b, int h, unsigned char* box) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int ks = 4 * b + kk;
        if (ks < LB) box_mma<kHalf>(lg, k.hid + ks * kBlockBytes, box, 32 * kk, h, ks > 0);
      }
    });
    fence_operands(lg);
    // lg[i]: row 16 warp + g + 8 ((i / 2) % 2), column col0 + 8 (i / 4) + 2q + i % 2
    float best[2] = {-INFINITY, -INFINITY};
    int arg[2] = {INT_MAX, INT_MAX};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int half = (i >> 1) & 1, col = col0 + 8 * (i >> 2) + 2 * q + (i & 1);
      lg[i] = __fadd_rn(lg[i], __bfloat162float(p.b_out[col]));
      if (col < p.V && lg[i] > best[half]) {  // columns ascend: the first of equal maxima
        best[half] = lg[i];
        arg[half] = col;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {  // the quad holding the row's 32 columns
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
      if (rank == 0 && row < p.B) {
        __nv_bfloat16* out = p.logits + ((size_t)row * p.S + t) * p.V;
#pragma unroll
        for (int i = 2 * half; i < 16; i += 4) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + 8 * (i >> 2) + 2 * q + e;
            if (col < p.V) out[col] = __float2bfloat16_rn(lg[i + e]);
          }
        }
      }
    }
    named_barrier(kBar, kConsumerThreads);
    if (tid < kRows) {  // warpgroup 1's columns win only by a larger logit
      int a = best_s[1][tid] > best_s[0][tid] ? arg_s[1][tid] : arg_s[0][tid];
      const int row = k.tile0 + tid;
      if (row < p.B) {
        const size_t o = (size_t)row * p.S + t;
        if (p.force[o] > 0) a = p.score[o];
        if (rank == 0) p.tokens[o] = a;
      }
      k.prev_tok[tid] = a;
    }
    return;
  }
  float best[2] = {-INFINITY, -INFINITY};
  int arg[2] = {INT_MAX, INT_MAX};
  for (int j = 0; j < NOC; ++j) {
    const int oc = chunk_at(j, NOC, p.ties);
    float lg[16];
    for (int hr = 0; hr < rounds; ++hr) {
      if (j == 0 || rounds > 1) {
        // the hidden tile is free: every warpgroup has read the last round's
        if (j > 0 || hr > 0) named_barrier(kBar, kConsumerThreads);
        // relu(h1 @ W_l1 + b_l1) of round hr's hidden columns, rounded to bf16
        for (int lc = k.wg; lc < RC; lc += kConsumers) {
          float acc[64];
          each_box(rg, k.KB, lane, [&](int kk, int h, unsigned char* box) {
            box_mma<kHalf>(acc, k.h1t + kk * kBlockBytes, box, 0, h, kk > 0);
          });
          fence_operands(acc);
#pragma unroll
          for (int i = 0; i < 64; i += 2) {
            const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
            const int col = lc * kHidCols + 8 * (i >> 2) + 2 * q;
            const uint32_t b = ldg_u32(p.b_l1 + hr * p.HT + col);
            *reinterpret_cast<uint32_t*>(k.hid + sw128_offset(r, col * 2, kRows)) =
                pack_bf16(fmaxf(__fadd_rn(acc[i], bf_lo(b)), 0.0f),
                          fmaxf(__fadd_rn(acc[i + 1], bf_hi(b)), 0.0f));
          }
        }
        fence_proxy_async();
        named_barrier(kBar, kConsumerThreads);
      }
      // this warpgroup's 32 columns of chunk oc over round hr's k-slabs: a
      // block of its own four 32-row k-slabs, or rows 64 kk + 32 wg of a
      // block of two k-slabs of the chunk's 64 columns
      if (p.OK == 4)
        each_box(rg, (HB + 3) / 4, lane, [&](int b, int h, unsigned char* box) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int ks = 4 * b + kk;
            if (ks < HB)
              box_mma<kHalf>(lg, k.hid + ks * kBlockBytes, box, 32 * kk, h, hr > 0 || ks > 0);
          }
        });
      else
        each_box(rg, HB / 2, lane, [&](int b, int h, unsigned char* box) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int ks = 2 * b + kk;
            box_mma<kHalf>(lg, k.hid + ks * kBlockBytes, box, 64 * kk + 32 * k.wg, h,
                           hr > 0 || ks > 0);
          }
        });
      fence_operands(lg);
    }
    // lg[i]: row 16 warp + g + 8 ((i / 2) % 2), column 64 oc + 32 wg + 8 (i / 4) + 2q + i % 2
    const int c0 = kOutCols * oc + 32 * k.wg;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int half = (i >> 1) & 1, col = c0 + 8 * (i >> 2) + 2 * q + (i & 1);
      lg[i] = __fadd_rn(lg[i], __bfloat162float(p.b_out[col]));
      if (col < p.V && lg[i] > best[half]) {
        best[half] = lg[i];
        arg[half] = col;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = k.tile0 + 16 * warp + g + 8 * half;
      if (rank == 0 && row < p.B) {
        __nv_bfloat16* out = p.logits + ((size_t)row * p.S + t) * p.V;
#pragma unroll
        for (int i = 2 * half; i < 16; i += 4) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * (i >> 2) + 2 * q + e;
            if (col < p.V) out[col] = __float2bfloat16_rn(lg[i + e]);
          }
        }
      }
    }
  }
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
    int a = head_beats(best_s[1][tid], arg_s[1][tid], best_s[0][tid], arg_s[0][tid], kOutCols,
                       p.ties)
                ? arg_s[1][tid]
                : arg_s[0][tid];
    const int row = k.tile0 + tid;
    if (row < p.B) {
      const size_t o = (size_t)row * p.S + t;
      if (p.force[o] > 0) a = p.score[o];
      if (rank == 0) p.tokens[o] = a;
    }
    k.prev_tok[tid] = a;
  }
}

// The packed weights the map covers (arnn_kernel.pack_arnn_weights): 16 KB
// blocks of 128 rows x 64 of K. W_hh0 in H / 32 chunks of H / 64 k-slabs;
// layer 1 in H / 32 chunks of 2H / 64 k-slabs (W_ih1's, then W_hh1's); the
// head's W_l1^T in LP / 128 chunks of H / 64 k-slabs; W_out^T by chunks of
// 64 (padded) vocabulary columns: with OK 4 each chunk's columns 0-31, then
// 32-63, each half in blocks of four 32-row k-slabs (LP padded to 256),
// streamed by its warpgroup's ring; with OK 2 the chunk in LP / 128 blocks
// of two 64-row k-slabs, which both rings stream (each warpgroup reads 32
// rows of each). kHalf: boxes of half a k-slab (the map's box is 32 values
// of K with the 64-byte swizzle, make_lstm_map).
template <int MAXC, bool kChunks, bool kHalf = false>
__global__ void __launch_bounds__(kArnnThreads, 1)
    arnn_kernel(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ ArnnArgs p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kConsumers][kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kConsumers][kMaxStages];
  __shared__ __align__(8) uint64_t h_full[2], h_done[2];
  __shared__ int prev_tok[kRows];
  __shared__ float head_best[kConsumers][kRows];
  __shared__ int head_arg[kConsumers][kRows];
  const int H = p.H, KB = H / 64, S = p.S;
  unsigned char* h0t = align1024(smem_raw);
  unsigned char* h1t = h0t + KB * kBlockBytes;
  unsigned char* hid = h1t + KB * kBlockBytes;
  unsigned char* ring = hid + (p.HT / 64) * kBlockBytes;
  const int C = (int)cluster_nctarank();
  const uint32_t rank = cluster_ctarank();
  const int U = H / C, nch = U / kUnits, chunk0 = (int)rank * nch;
  constexpr int kBox = kLstmBoxBytes<kHalf>;
  uint32_t* c0 = reinterpret_cast<uint32_t*>(ring + kConsumers * p.stages * kBox);
  uint32_t* c1 = c0 + kRows * U / 2;
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
  // h0 = c0 = h1 = c1 = 0
  for (int i = threadIdx.x; i < 2 * KB * kBlockBytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(h0t)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < kRows * U / 4; i += blockDim.x)
    reinterpret_cast<uint4*>(c0)[i] = make_uint4(0, 0, 0, 0);  // c0 and c1
  fence_proxy_async();
  __syncthreads();
  cluster_sync();

  if (wg == kConsumers) {  // the producer warps, in the consumers' order of use
    setmaxnreg_dec<kProducerRegs>();
    const int w = (threadIdx.x >> 5) & 3;
    if (w < kConsumers && (threadIdx.x & 31) == 0) {
      LstmFeed<kHalf> f;
      if constexpr (kHalf)
        f = {&w_map, ring + w * p.stages * kBox, full_bar[w], empty_bar[w], p.stages, 0, 0};
      else
        f = {&w_map, ring + w * p.stages * kBox, full_bar[w], empty_bar[w], p.stages, 1, 0, 0};
      const int chunks = H / kUnits;
      const int l1_base = chunks * KB, head_base = l1_base + chunks * 2 * KB;
      const int LC = p.LP / kHidCols, out_base = head_base + LC * KB;
      const int rounds = p.LP / p.HT, RC = p.HT / kHidCols, NOC = out_chunks(p.V);
      // W_out^T's blocks of a chunk (of this warpgroup's half of it) and of a round
      const int OB = p.OK == 4 ? (p.LP + 255) / 256 : p.LP / 128;
      const int RB = p.OK == 4 ? (p.HT + 255) / 256 : p.HT / 128;
      for (int t = 0; t < S; ++t) {
        for (int c = w; c < nch; c += kConsumers) f.slabs((chunk0 + c) * KB, KB);
        for (int c = w; c < nch; c += kConsumers) f.slabs(l1_base + (chunk0 + c) * 2 * KB, 2 * KB);
        for (int j = 0; j < NOC; ++j)
          for (int hr = 0; hr < rounds; ++hr) {
            const int oc = chunk_at(j, NOC, p.ties);
            if (j == 0 || rounds > 1)
              for (int lc = w; lc < RC; lc += kConsumers)
                f.slabs(head_base + (hr * RC + lc) * KB, KB);
            f.slabs(out_base + (p.OK == 4 ? 2 * oc + w : oc) * OB + hr * RB, RB);
          }
      }
    }
    cluster_sync();
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  LstmRing<kHalf> rg;
  if constexpr (kHalf)
    rg = {ring + wg * p.stages * kBox, full_bar[wg], empty_bar[wg], p.stages, 0, 0};
  else
    rg = {ring + wg * p.stages * kBox, full_bar[wg], empty_bar[wg], p.stages, 1, 0, 0};
  const Exchange ex0{C, rank, (int)rank * (U / 64), U / 64, &h_full[0], &h_done[0]};
  const Exchange ex1{C, rank, (int)rank * (U / 64), U / 64, &h_full[1], &h_done[1]};
  const ArnnCta cta{h0t, h1t, hid, c0, c1, prev_tok, H, KB, U, tile0, chunk0, nch, wg};

  for (int t = 0; t < S; ++t) {
    // the last tick's head is done: prev_tok is set, h1 and hid are read
    named_barrier(kBar, kConsumerThreads);
    arnn_layer0<MAXC, kHalf>(p, cta, rg, ex0, t);
    arnn_layer1<MAXC, kHalf>(p, cta, rg, ex1, t);
    arnn_head<kChunks, kHalf>(p, cta, rg, rank, t, head_best, head_arg);
  }
  cluster_sync();
}

// dynamic shared memory of a K7 block: both h tiles, the hidden tile of HT
// columns, the rings of boxes of `halves` half k-slabs and the two c arrays
// (and 1 KB of alignment)
inline size_t arnn_smem_bytes(int H, int C, int HT, int stages, int halves) {
  return (size_t)(2 * (H / 64) + HT / 64) * kBlockBytes +
         (size_t)kConsumers * stages * halves * kLstmHalfBytes + 2ull * kRows * (H / C) * 2 +
         1024;
}

// the launch's checks: C in 1..16 owning whole 64-unit k-blocks, at most 4
// chunks a warpgroup (more leave no ring beside the tiles and c carries),
// half boxes only at one chunk a warpgroup (their one instantiation), a
// hidden tile of whole 128-column chunks that splits the head's LP into
// rounds, a ring of 2..kMaxStages stages that fits
inline bool arnn_plan_fits(int H, int C, int LP, int HT, int V, int stages, int halves) {
  if (H % 64 != 0 || H <= 0 || C < 1 || C > kMaxArnnCluster) return false;
  if ((H / 64) % C != 0 || H / C > 4 * kConsumers * kUnits) return false;
  if (!(halves == 2 || (halves == 1 && chunks_per_warpgroup(H, C) == 1))) return false;
  if (HT < kHidCols || HT % kHidCols != 0 || LP % HT != 0 || V < 1) return false;
  if (stages < 2 || stages > kMaxStages) return false;
  return arnn_smem_bytes(H, C, HT, stages, halves) <= (size_t)kSmemBudget;
}

// `kernel` opted in to clusters past the portable 8 CTAs where C asks
template <typename Kernel>
inline cudaError_t allow_cluster(Kernel kernel, int C) {
  return C > kMaxCluster
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
             : cudaSuccess;
}

template <typename Kernel>
inline int arnn_kernel_slots(Kernel kernel, int C, size_t smem) {
  if (allow_cluster(kernel, C) != cudaSuccess) return -1;
  return max_clusters(kernel, C, smem, kArnnThreads);
}

template <typename Kernel>
inline cudaError_t launch_arnn_kernel(Kernel kernel, const CUtensorMap& map, const ArnnArgs& a,
                                      int C, int clusters, size_t smem, cudaStream_t stream) {
  const cudaError_t err = allow_cluster(kernel, C);
  if (err != cudaSuccess) return err;
  return launch_clusters(kernel, clusters, C, smem, stream, map, a, kArnnThreads);
}

template <bool kChunks>
inline cudaError_t launch_arnn_as(const CUtensorMap& map, const ArnnArgs& a, int C, int clusters,
                                  size_t smem, cudaStream_t stream) {
  switch (chunks_per_warpgroup(a.H, C)) {
    case 1: return launch_arnn_kernel(arnn_kernel<1, kChunks>, map, a, C, clusters, smem, stream);
    case 2: return launch_arnn_kernel(arnn_kernel<2, kChunks>, map, a, C, clusters, smem, stream);
    case 3:
    case 4: return launch_arnn_kernel(arnn_kernel<4, kChunks>, map, a, C, clusters, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// A 3D tensor map over K7's packed 16 KB blocks (128 rows x 64 bf16 of K),
// one block a box (`halves` 2, the 128-byte swizzle) or half of one, 32
// values of K (1, the 64-byte swizzle).
inline cudaError_t make_lstm_map(CUtensorMap* map, const void* packed, int blocks, int halves) {
  if (halves != 1 && halves != 2) return cudaErrorInvalidValue;
  const uint64_t dims[3] = {64, (uint64_t)kLstmRows, (uint64_t)blocks};
  const uint64_t strides[2] = {128, (uint64_t)kLstmSlabBytes};
  const uint32_t box[3] = {32u * (uint32_t)halves, (uint32_t)kLstmRows, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, packed, dims, strides, box,
                  halves == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// ---------------------------------------------------------------------------
// K7's f32 route: the same tick chain with every product split
// ---------------------------------------------------------------------------
// It replaces, in f32, the TPU kernel arnn_sampled_decode_pallas
// (_arnn_kernel). What bounds it: the f32 products, 2 x 512 x 384 x 1.18M
// operations at the flagship (0.46 TFLOP: 6.6 ms of f32 FMA), on the
// tensor cores six bf16 passes (2.8 ms at the bf16 peak), behind the
// 384-tick serial chain.
//
// Design (arnn_kernel.arnn_f32_plan picks the cluster size C):
// - Every product is split as K5's (gru_fwd_hopper.cuh): the operand and
//   the weight each as three exact bf16 pieces (split3), six wgmma passes a
//   64-wide k-slab into a partial of its own, added into the sum with
//   rounded f32 adds. The context product runs first for every tick as the
//   split GEMM (encoder_hopper.cuh launch_proj_gemm_split) into f32 rows.
// - Three f32 tiles of pieces (h0, h1 and the head's hidden) would take 288
//   KB of shared memory at H 256, so the pieces go through an L2 scratch as
//   K5's do: (tile, plane h0 / h1 / hidden, tick parity, piece, 64 rows,
//   max(H, LP)). After each stage of a tick every CTA writes its part's
//   pieces there and arrives on every peer's `ready` mbarrier of that
//   plane; one producer warp streams each 64-wide k-slab of the operand's
//   pieces (one TMA box, 24 KB) with the matching k-slab of two weight
//   chunks' pieces (one box of six 8 KB blocks) through a two-stage ring
//   that both consumer warpgroups read. The parity keeps a plane's tick
//   t + 2 pieces from landing before every CTA has read its tick t ones.
// - Registers: layer 1's x- and h-products keep accumulators of their own
//   (summed (x + b_ih1) + (h + b_hh1), the plain version's order), each
//   beside the slab's partial. So a chunk is 16 units (its i, f, g, o rows
//   are a 64 x 64 tile: 32 registers an accumulator), a warpgroup takes one
//   chunk a round, and a CTA owns U = H / C units in U / 32 rounds (1..4).
//   Its c carries stay in shared memory in f32.
// - The head: CTA r computes the hidden columns of rounds r, r + C, ... of
//   128 (64 a warpgroup), relu(h1 @ W_l1 + b_l1), and writes their pieces;
//   then every CTA computes every logit column from the whole hidden row,
//   by pairs of 64-column chunks (V zero-padded to whole chunks; warpgroup
//   w takes chunk w of a pair, and idles where that chunk is past V), so
//   every CTA takes the same running argmax (arnn_head's) with no exchange.
//   CTA 0 writes the logits (f32) and the tokens.
// - Every cluster size sums in the same order, so all give bit-equal
//   outputs: the check for a race in the exchange.
constexpr int kF32Units = 16;                        // units of a chunk: i, f, g, o rows = 64
constexpr int kF32Block = kRows * 128;               // a 64 x 64 bf16 block of weights: 8 KB
constexpr int kF32StageBytes = kF32ABytes + 6 * kF32Block;  // + two chunks' pieces: 72 KB
constexpr int kF32Stages = 2;
// + a whole producer warpgroup, so that setmaxnreg can hand its registers
// to the consumers (232 each): at the launch's 168 the kernel spilled 1 KB
// and took 12% longer (PERF.md)
constexpr int kF32Threads = kConsumerThreads + 128;
constexpr int kF32CarryPad = 8;                      // f32 padding of the c carries' rows
constexpr int kF32MaxRounds = 4;                     // 32-unit rounds a CTA: 128 units at most

struct ArnnF32Args {
  const float* xwc;       // (B, S, 4H): ctx @ W_ctx from the split GEMM
  const int* score;       // (B, S) ground-truth tokens
  const int* force;       // (B, S) 1 where the token is forced
  const float* tok_tab;   // (n_tok, 4H): emb @ W_ih0[:E]
  const float* start_xw;  // (4H,): the tick-0 input
  const float* bias;      // (4, 4H): b_ih0, b_hh0, b_ih1, b_hh1
  const float* b_l1;      // (LP,), zero past the head's width
  const float* b_out;     // (64 NOC,), zero past V
  float* logits;          // (B, S, V)
  int* tokens;            // (B, S)
  __nv_bfloat16* scratch;  // (tiles, 3, 2, 3, 64, max(H, LP)), zero at the start
  int B, S, H, LP, V, ties;
};

// The LSTM cells of a round's chunk: units j0 + 8 n8 + 2q + e of rows r =
// 16 warp + g + 8 half, gate gi's pre-activation pre(gi, r, gi H + unit, a)
// with a = 8 gi + 4 n8 + 2 half + e its accumulator index; their c carries
// in `c` (rows of ldc, the chunk's first unit at jl0), the new h's pieces
// into the scratch plane `pl`.
template <typename Pre>
__device__ __forceinline__ void f32_cells(Pre pre, float* c, int ldc, int jl0, int j0, int H,
                                          __nv_bfloat16* scratch, int pl, int wd) {
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
#pragma unroll
  for (int n8 = 0; n8 < 2; ++n8) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + g + 8 * half;
      float* cp = c + r * ldc + jl0 + 8 * n8 + 2 * q;
      float hv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float gate[4];
#pragma unroll
        for (int gi = 0; gi < 4; ++gi)
          gate[gi] = pre(gi, r, gi * H + j0 + 8 * n8 + 2 * q + e, 8 * gi + 4 * n8 + 2 * half + e);
        float cn;
        lstm_gate(gate, cp[e], hv[e], cn);
        cp[e] = cn;
      }
      f32_put(scratch, pl, wd, r, j0 + 8 * n8 + 2 * q, hv[0], hv[1]);
    }
  }
}

// The packed weights (arnn_kernel.pack_arnn_f32_weights): 8 KB blocks of
// 64 rows x 64 of K, six a k-slab of two chunks: [piece][chunk]. W_hh0,
// W_ih1 and W_hh1 by pairs of 16-unit chunks (rows 16 gate + unit), then
// W_l1^T by rounds of 128 hidden columns, then W_out^T by pairs of 64
// (padded) vocabulary columns (a zero chunk past the last), by k-slab.
// kChunks: more than one output chunk (else the one-chunk path of the
// flagship, in an instantiation of its own).
template <bool kChunks>
__global__ void __launch_bounds__(kF32Threads, 1)
    arnn_f32_kernel(const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ ArnnF32Args p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kF32Stages];
  __shared__ __align__(8) uint64_t empty_bar[kF32Stages];
  __shared__ __align__(8) uint64_t ready[3];  // every CTA's h0 / h1 / hidden pieces of a tick
  __shared__ int prev_tok[kRows];
  __shared__ float head_best[kConsumers][kRows];
  __shared__ int head_arg[kConsumers][kRows];
  unsigned char* ring = align1024(smem_raw);
  const int H = p.H, H4 = 4 * H, KB = H / 64, LB = p.LP / 64, S = p.S;
  const int NOC = out_chunks(p.V), pairs = (NOC + 1) / 2;
  const int wd = H > p.LP ? H : p.LP;  // the scratch's row width
  const int C = (int)cluster_nctarank();
  const uint32_t rank = cluster_ctarank();
  const int U = H / C, rounds = U / 32, pair0 = (int)rank * rounds;
  const int hid_rounds = p.LP / 128;
  const int tile = (int)(blockIdx.x / C), tile0 = tile * kRows;
  const int wg = threadIdx.x >> 7;
  const int ldc = U + kF32CarryPad;
  float* c0 = reinterpret_cast<float*>(ring + kF32Stages * kF32StageBytes);
  float* c1 = c0 + kRows * ldc;
  const int blk_ih1 = (H / 32) * KB * 6, blk_hh1 = 2 * blk_ih1, blk_l1 = 3 * blk_ih1;
  const int blk_out = blk_l1 + hid_rounds * KB * 6;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    for (int i = 0; i < 3; ++i) mbar_init(&ready[i], C);
    fence_barrier_init();
  }
  if (threadIdx.x < kRows) prev_tok[threadIdx.x] = -1;
  for (int i = threadIdx.x; i < 2 * kRows * ldc; i += blockDim.x) c0[i] = 0.0f;  // c0, c1
  __syncthreads();
  cluster_sync();

  // the first scratch plane (of three pieces) of `kind` at tick parity `par`
  const auto plane = [&](int kind, int par) { return ((tile * 3 + kind) * 2 + par) * 3; };
  if (wg == kConsumers) {  // the producer, in the consumers' order of use
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      int stage = 0;
      uint32_t phase = 0;
      const auto load = [&](int pl, int k, int block) {
        unsigned char* st = ring + stage * kF32StageBytes;
        mbar_wait_bounded<false>(&empty_bar[stage], phase ^ 1);
        mbar_expect_tx(&full_bar[stage], kF32StageBytes);
        tma_load_3d(st, &a_map, &full_bar[stage], k * 64, 0, pl);
        tma_load_3d(st + kF32ABytes, &w_map, &full_bar[stage], 0, 0, block);
        if (++stage == kF32Stages) {
          stage = 0;
          phase ^= 1;
        }
      };
      // every CTA's pieces of this tick's plane are written
      const auto wait_ready = [&](int i, int t) {
        mbar_wait_bounded<true>(&ready[i], t & 1);
        fence_proxy_async_global();
      };
      for (int t = 0; t < S; ++t) {
        const int cur = t & 1, prev = cur ^ 1;  // tick -1's planes are the zeros
        for (int r = 0; r < rounds; ++r)
          for (int k = 0; k < KB; ++k) load(plane(0, prev), k, ((pair0 + r) * KB + k) * 6);
        wait_ready(0, t);
        for (int r = 0; r < rounds; ++r) {
          for (int k = 0; k < KB; ++k) load(plane(0, cur), k, blk_ih1 + ((pair0 + r) * KB + k) * 6);
          for (int k = 0; k < KB; ++k) load(plane(1, prev), k, blk_hh1 + ((pair0 + r) * KB + k) * 6);
        }
        wait_ready(1, t);
        for (int hr = (int)rank; hr < hid_rounds; hr += C)
          for (int k = 0; k < KB; ++k) load(plane(1, cur), k, blk_l1 + (hr * KB + k) * 6);
        wait_ready(2, t);
        for (int j = 0; j < pairs; ++j)
          for (int k = 0; k < LB; ++k)
            load(plane(2, cur), k, blk_out + (chunk_at(j, pairs, p.ties) * LB + k) * 6);
      }
    }
    cluster_sync();
    return;
  }

  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            q = lane & 3;
  setmaxnreg_inc<kConsumerRegs>();
  F32Ring rg{ring, full_bar, empty_bar, kF32Stages, kF32StageBytes, kF32Block, 0, 0};
  // the pieces are written: make them visible to the peers' TMA loads, then
  // tell every CTA of the cluster (thread c tells CTA c)
  const auto publish = [&](int i) {
    __threadfence();
    fence_proxy_async_global();
    named_barrier(kBar, kConsumerThreads);
    if (tid < C) mbar_arrive_cluster(mapa(smem_u32(&ready[i]), tid));
  };

  for (int t = 0; t < S; ++t) {
    const int cur = t & 1;
    // the last tick's head is done: prev_tok is set
    named_barrier(kBar, kConsumerThreads);
    // layer 0: ((the fed-back row + the context projection) + b_ih0) + (acc + b_hh0)
    for (int r = 0; r < rounds; ++r) {
      const int jl0 = 32 * r + kF32Units * wg, j0 = (int)rank * U + jl0;
      float acc[32];
      f32_product(rg, acc, KB, true, wg, lane);
      f32_cells(
          [&](int gi, int rr, int col, int a) {
            const int row = tile0 + rr, prev = prev_tok[rr];
            const float f = (prev < 0 ? p.start_xw : p.tok_tab + (size_t)prev * H4)[col];
            const float x = row < p.B ? __fadd_rn(f, p.xwc[((size_t)row * S + t) * H4 + col]) : f;
            return __fadd_rn(__fadd_rn(x, p.bias[col]), __fadd_rn(acc[a], p.bias[H4 + col]));
          },
          c0, ldc, jl0, j0, H, p.scratch, plane(0, cur), wd);
    }
    publish(0);
    // layer 1: (h0' @ W_ih1 + b_ih1) + (h1 @ W_hh1 + b_hh1)
    for (int r = 0; r < rounds; ++r) {
      const int jl0 = 32 * r + kF32Units * wg, j0 = (int)rank * U + jl0;
      float ax[32], ah[32];
      f32_product(rg, ax, KB, true, wg, lane);
      f32_product(rg, ah, KB, true, wg, lane);
      f32_cells(
          [&](int gi, int rr, int col, int a) {
            return __fadd_rn(__fadd_rn(ax[a], p.bias[2 * H4 + col]),
                             __fadd_rn(ah[a], p.bias[3 * H4 + col]));
          },
          c1, ldc, jl0, j0, H, p.scratch, plane(1, cur), wd);
    }
    publish(1);
    // this CTA's hidden columns of the head, relu(h1 @ W_l1 + b_l1)
    for (int hr = (int)rank; hr < hid_rounds; hr += C) {
      float acc[32];
      f32_product(rg, acc, KB, true, wg, lane);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
        const int col = hr * 128 + 64 * wg + 8 * (i >> 2) + 2 * q;
        f32_put(p.scratch, plane(2, cur), wd, r, col, fmaxf(__fadd_rn(acc[i], p.b_l1[col]), 0.0f),
            fmaxf(__fadd_rn(acc[i + 1], p.b_l1[col + 1]), 0.0f));
      }
    }
    publish(2);
    if constexpr (!kChunks) {  // the one-chunk path (the general one was slower there)
      // the logits of the whole hidden row, the argmax and the force mask
      float lg[32];
      f32_product(rg, lg, LB, wg == 0, wg, lane);
      if (wg == 0) {
        float best[2] = {-INFINITY, -INFINITY};
        int arg[2] = {INT_MAX, INT_MAX};
#pragma unroll
        for (int i = 0; i < 32; ++i) {  // a half's columns ascend: the first of equal maxima
          const int half = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * q + (i & 1);
          lg[i] = __fadd_rn(lg[i], p.b_out[col]);
          if (col < p.V && lg[i] > best[half]) {
            best[half] = lg[i];
            arg[half] = col;
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {  // the quad holding the row's 64 columns
            const float ob = __shfl_xor_sync(0xffffffffu, best[half], off);
            const int oa = __shfl_xor_sync(0xffffffffu, arg[half], off);
            if (ob > best[half] || (ob == best[half] && oa < arg[half])) {
              best[half] = ob;
              arg[half] = oa;
            }
          }
          const int r = 16 * warp + g + 8 * half, row = tile0 + r;
          if (rank == 0 && row < p.B) {
            float* out = p.logits + ((size_t)row * S + t) * p.V;
#pragma unroll
            for (int i = 2 * half; i < 32; i += 4)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = 8 * (i >> 2) + 2 * q + e;
                if (col < p.V) out[col] = lg[i + e];
              }
          }
          if (q == 0) {
            int a = arg[half];
            if (row < p.B) {
              const size_t o = (size_t)row * S + t;
              if (p.force[o] > 0) a = p.score[o];
              if (rank == 0) p.tokens[o] = a;
            }
            prev_tok[r] = a;
          }
        }
      }
    } else {
      // the logits of the whole hidden row by pairs of chunks, the running
      // argmax and, after the last, the force mask
      float best[2] = {-INFINITY, -INFINITY};
      int arg[2] = {INT_MAX, INT_MAX};
      for (int j = 0; j < pairs; ++j) {
        const int oc = 2 * chunk_at(j, pairs, p.ties) + wg, col0 = kOutCols * oc;
        float lg[32];
        f32_product(rg, lg, LB, oc < NOC, wg, lane);
        if (oc >= NOC) continue;
#pragma unroll
        for (int i = 0; i < 32; ++i) {  // a half's columns ascend
          const int half = (i >> 1) & 1, col = col0 + 8 * (i >> 2) + 2 * q + (i & 1);
          lg[i] = __fadd_rn(lg[i], p.b_out[col]);
          if (col < p.V && lg[i] > best[half]) {
            best[half] = lg[i];
            arg[half] = col;
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = tile0 + 16 * warp + g + 8 * half;
          if (rank == 0 && row < p.B) {
            float* out = p.logits + ((size_t)row * S + t) * p.V;
#pragma unroll
            for (int i = 2 * half; i < 32; i += 4)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = col0 + 8 * (i >> 2) + 2 * q + e;
                if (col < p.V) out[col] = lg[i + e];
              }
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        quad_best(best[half], arg[half]);
        if (q == 0) {
          head_best[wg][16 * warp + g + 8 * half] = best[half];
          head_arg[wg][16 * warp + g + 8 * half] = arg[half];
        }
      }
      named_barrier(kBar, kConsumerThreads);
      if (tid < kRows) {
        int a = head_beats(head_best[1][tid], head_arg[1][tid], head_best[0][tid],
                           head_arg[0][tid], kOutCols, p.ties)
                    ? head_arg[1][tid]
                    : head_arg[0][tid];
        const int row = tile0 + tid;
        if (row < p.B) {
          const size_t o = (size_t)row * S + t;
          if (p.force[o] > 0) a = p.score[o];
          if (rank == 0) p.tokens[o] = a;
        }
        prev_tok[tid] = a;
      }
    }
  }
  cluster_sync();
}

// dynamic shared memory of an f32 K7 block: the ring and the two c carries
// (and 1 KB of alignment)
inline size_t arnn_f32_smem_bytes(int H, int C) {
  return (size_t)kF32Stages * kF32StageBytes + 2ull * kRows * (H / C + kF32CarryPad) * 4 + 1024;
}

// the launch's checks: C in 1..8 owning whole 32-unit pairs of chunks, at
// most kF32MaxRounds of them; a head of 128-column rounds; a block that
// fits
inline bool arnn_f32_plan_fits(int H, int C, int LP, int V) {
  if (H % 64 != 0 || H <= 0 || C < 1 || C > kMaxCluster || H % C != 0) return false;
  const int U = H / C;
  if (U % 32 != 0 || U / 32 > kF32MaxRounds) return false;
  if (LP < 128 || LP % 128 != 0 || V < 1) return false;
  return arnn_f32_smem_bytes(H, C) <= (size_t)kSmemBudget;
}

// A 3D tensor map over the f32 route's packed 8 KB blocks, six a box.
inline cudaError_t make_arnn_f32_map(CUtensorMap* map, const void* packed, int blocks) {
  const uint64_t dims[3] = {64, (uint64_t)kRows, (uint64_t)blocks};
  const uint64_t strides[2] = {128, (uint64_t)kF32Block};
  const uint32_t box[3] = {64, (uint32_t)kRows, 6};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, packed, dims, strides, box);
}

}  // namespace rec90
}  // namespace inpaint
