// The Hopper design of K2's bf16 route (decode_sampling.cu): the 24-tick
// 2-layer tick-GRU argmax decode on gru_layer_hopper.cuh's cluster
// recurrence. It replaces, in bf16, the TPU kernel
// inpaintnet_tpu/ops/decode_pallas.py decode_sampling_pallas.
//
// What bounds it on an H100: every tick runs a serial chain, layer 0 ->
// layer 1 -> head -> argmax -> the fed-back token, each product a 64-row
// tile by an (H, 3H) weight streamed from L2 (three of them and the (H, 64)
// head: 4.6 MB at H 512 a tick). The mma.sync kernel this replaces walked
// each product as a chain of dependent L2 fragment loads; and at 2,048 or 6
// rows too few row tiles exist to fill the card.
//
// Design, per 64-row tile and cluster of C CTAs (decode_kernel.launch_plan
// picks C from the rows):
// - Each CTA holds the whole h0 and h1 tiles (the A operands; 2 x 64 KB at
//   H 512, bf16, swizzled) and computes U = H / C units of each layer, its
//   W_hh0, W_ih1 and W_hh1 gate slabs streaming through the consumer
//   warpgroups' TMA rings into wgmma (a producer warp per ring, running
//   ahead across layers and ticks). Layer 1's r and z columns take one
//   accumulator over K = 2H (x- and h-products summed, one 64 x 64 tile);
//   n keeps x @ W_ih1 and h @ W_hh1 apart (two 64 x 32 tiles), because
//   n = tanh(xn + r * hn).
// - After each layer a CTA pushes its k-blocks of the new h to its peers
//   (gru_layer_hopper.cuh write_and_push); the next product waits on the
//   tile's `full` mbarrier. The new h is written in place once the CTA's
//   products have read the old one, so two tiles, not four, fit beside the
//   rings.
// - Every CTA needs the fed-back token, so every CTA recomputes the small
//   head (a 64 x 32 wgmma tile over H in each warpgroup) and the argmax on
//   its own identical h1: no second exchange. The argmax of a row runs in
//   the four lanes that hold its columns (two shuffles), then across the two
//   warpgroups in shared memory, first index among equal maxima over the V
//   real columns. CTA 0 of the cluster writes the logits and the tokens.
// - The layers and the head are inlined: as functions of their own that
//   were not inlined they spilled less but took 66% more time (PERF.md).
// - Numerics as K2: products in f32, biases and gates in f32, both carries
//   rounded to bf16 every tick, layer 0's input the fed-back row of tok_tab
//   (x_0's projection at tick 0) plus ctx_xw summed in f32, ReLU logits in
//   f32, written in bf16; both hiddens reset to the beat's init hiddens at
//   t % 6 == 0.
#pragma once

#include <limits.h>
#include <math.h>

#include "gru_layer_hopper.cuh"

namespace inpaint {
namespace rec90 {

constexpr int kTicks = 24;
constexpr int kTicksPerBeat = 6;
constexpr int kHeadCols = 64;  // the head's vocabulary, zero-padded: one 64 x 64 tile

struct DecodeArgs {
  const __nv_bfloat16* ctx_xw;   // (4, B, 3H): beat-context part of x @ W_ih0, b_ih0 folded in
  const __nv_bfloat16* hi0;      // (4, B, H) per-beat layer-0 init hiddens
  const __nv_bfloat16* hi1;      // (4, B, H) per-beat layer-1 init hiddens
  const __nv_bfloat16* tok_tab;  // (V, 3H): emb @ W_ih0[:E]
  const __nv_bfloat16* x0_xw;    // (3H,): x_0 @ W_ih0[:E], the tick-0 input
  const __nv_bfloat16* bias;     // (3, 3H): b_hh0, b_ih1, b_hh1
  const __nv_bfloat16* head_b;   // (64,), zero past V
  __nv_bfloat16* logits;         // (B, 24, V)
  int* samples;                  // (B, 24)
  int B, H, V, stages;
};

// What every consumer thread of a decode CTA reads in each layer.
struct DecodeCta {
  unsigned char* h0t;  // the layer-0 and layer-1 h tiles (swizzled bf16)
  unsigned char* h1t;
  int* prev_tok;       // each row's fed-back token, -1: x_0
  int H, KB, tile0, chunk0, nch, wg;
};

// Each layer, and the head, is a function of its own; each layer ends with
// its h exchanged.

// layer 0: xw = the fed-back token's row + the beat context (summed in
// f32); hw = h0 @ W_hh0 + b_hh0
template <int MAXC>
__device__ __forceinline__ void decode_layer0(const DecodeArgs& p, const DecodeCta& k, Ring& rg,
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
      rg.consume(k.KB, lane, [&](int kk, unsigned char* slab) {
        mma_slab(acc, desc_sw128(k.h0t + kk * kBlockBytes), desc_sw128(slab), kk > 0);
      });
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

// layer 1: xw = h0' @ W_ih1 + b_ih1; hw = h1 @ W_hh1 + b_hh1
template <int MAXC>
__device__ __forceinline__ void decode_layer1(const DecodeArgs& p, const DecodeCta& k, Ring& rg,
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
      const int j0 = (k.chunk0 + c) * kUnits;
      uint32_t bi[3][4], bh[3][4];  // b_ih1 and b_hh1 pairs of the thread's units
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
          bi[gate][n8] = ldg_u32(bih1 + gate * H + j0 + 8 * n8 + 2 * q);
          bh[gate][n8] = ldg_u32(bhh1 + gate * H + j0 + 8 * n8 + 2 * q);
        }
      // acc: x @ W_ih1's r, z, n columns (a 64 x 96 tile), then h1 @ W_hh1's
      // r and z columns added into its first 64 (their n columns apart in hn)
      float acc[48], hn[16];
      float(&rz)[32] = *reinterpret_cast<float(*)[32]>(acc);
      rg.consume(k.KB, lane, [&](int kk, unsigned char* slab) {
        mma_slab(acc, desc_sw128(k.h0t + kk * kBlockBytes), desc_sw128(slab), kk > 0);
      });
      rg.consume(k.KB, lane, [&](int kk, unsigned char* slab) {
        const uint64_t a = desc_sw128(k.h1t + kk * kBlockBytes);
        mma_slab(rz, a, desc_sw128(slab), true);
        mma_slab(hn, a, desc_sw128(slab + 2 * kUnits * 128), kk > 0);
      });
      fence_operands(acc);
      fence_operands(hn);
      // r and z: (the x- and h-product sums) + b_ih, then + b_hh in gru_gate
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t old = old_pair(k.h1t, 16 * warp + g + 8 * half, j0 + 8 * n8 + 2 * q);
          float hv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int a = 4 * n8 + 2 * half + e;
            const auto pick = [e](uint32_t v) { return e ? bf_hi(v) : bf_lo(v); };
            hv[e] = gru_gate(__fadd_rn(acc[a], pick(bi[0][n8])), pick(bh[0][n8]),
                             __fadd_rn(acc[16 + a], pick(bi[1][n8])), pick(bh[1][n8]),
                             __fadd_rn(acc[32 + a], pick(bi[2][n8])),
                             __fadd_rn(hn[a], pick(bh[2][n8])), pick(old));
          }
          hold[ci][2 * n8 + half] = pack_bf16(hv[0], hv[1]);
        }
      }
    }
  }
  write_and_push(k.h1t, ex, hold, k.wg, k.nch, k.chunk0, t & 1);
  if (ex.C > 1) mbar_wait_bounded<true>(ex.full, t & 1);
}

// The ReLU head and the first-index argmax, in every CTA on its own
// (identical) h1: warpgroup w takes the logits' columns [32w, 32w + 32), a
// 64 x 32 tile over K = H; a row's 32 columns sit in the four lanes of a
// quad (two shuffles), and the two warpgroups' bests meet in shared memory,
// warpgroup 0's winning ties (its columns come first). CTA 0 of the cluster
// writes the logits and the tokens.
__device__ __forceinline__ void decode_head(const DecodeArgs& p, const DecodeCta& k, Ring& rg,
                                            uint32_t rank, int t, float (&best_s)[kConsumers][kRows],
                                            int (&arg_s)[kConsumers][kRows]) {
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            q = lane & 3;
  const int col0 = 32 * k.wg;
  float lg[16];
  rg.consume(k.KB, lane, [&](int kk, unsigned char* slab) {
    mma_slab(lg, desc_sw128(k.h1t + kk * kBlockBytes), desc_sw128(slab + col0 * 128), kk > 0);
  });
  fence_operands(lg);
  // lg[i]: row 16 warp + g + 8 ((i / 2) % 2), column col0 + 8 (i / 4) + 2q + i % 2
  float best[2] = {-INFINITY, -INFINITY};
  int arg[2] = {INT_MAX, INT_MAX};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int half = (i >> 1) & 1, col = col0 + 8 * (i >> 2) + 2 * q + (i & 1);
    lg[i] = fmaxf(__fadd_rn(lg[i], __bfloat162float(p.head_b[col])), 0.0f);
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
      __nv_bfloat16* out = p.logits + ((size_t)row * kTicks + t) * p.V;
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
    const int a = best_s[1][tid] > best_s[0][tid] ? arg_s[1][tid] : arg_s[0][tid];
    k.prev_tok[tid] = a;
    const int row = k.tile0 + tid;
    if (rank == 0 && row < p.B) p.samples[(size_t)row * kTicks + t] = a;
  }
}

// The packed weights the map covers (decode_kernel.pack_decode_weights):
// W_hh0, W_ih1 and W_hh1 as gru_kernel.pack_gate_blocks lays them out (H / 32
// chunks each of H / 64 contiguous 96 x 64 k-slabs), then the head's W^T as
// one more chunk: rows 0..V-1 its columns, zero rows after.
template <int MAXC>
__global__ void __launch_bounds__(kThreads, 1)
    decode_kernel(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ DecodeArgs p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kConsumers][kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kConsumers][kMaxStages];
  __shared__ __align__(8) uint64_t h_full[2], h_done[2];
  __shared__ int prev_tok[kRows];
  __shared__ float head_best[kConsumers][kRows];
  __shared__ int head_arg[kConsumers][kRows];
  const int H = p.H, KB = H / 64, ks = box_slabs(H), B = p.B;
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

  if (wg == kConsumers) {  // the producer warps, in the consumers' order of use
    const int w = (threadIdx.x >> 5) & 3;
    if ((threadIdx.x & 31) == 0) {
      Feed f{&w_map, ring + w * p.stages * ks * kSlabBytes, full_bar[w], empty_bar[w],
             p.stages, ks, 0, 0};
      const int chunks = H / kUnits;  // the chunks of one packed weight
      for (int t = 0; t < kTicks; ++t) {
        for (int c = w; c < nch; c += kConsumers) f.slabs((chunk0 + c) * KB, KB);
        for (int c = w; c < nch; c += kConsumers) {
          f.slabs((chunks + chunk0 + c) * KB, KB);
          f.slabs((2 * chunks + chunk0 + c) * KB, KB);
        }
        f.slabs(3 * chunks * KB, KB);  // the head: each warpgroup takes half of it
      }
    }
    cluster_sync();
    return;
  }

  const int tid = threadIdx.x;
  Ring rg{ring + wg * p.stages * ks * kSlabBytes, full_bar[wg], empty_bar[wg], p.stages, ks, 0, 0};
  const Exchange ex0{C, rank, (int)rank * (U / 64), U / 64, &h_full[0], &h_done[0]};
  const Exchange ex1{C, rank, (int)rank * (U / 64), U / 64, &h_full[1], &h_done[1]};
  const DecodeCta cta{h0t, h1t, prev_tok, H, KB, tile0, chunk0, nch, wg};

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
    decode_head(p, cta, rg, rank, t, head_best, head_arg);
  }
  cluster_sync();
}

inline int decode_slots(int H, int C, int stages) {
  if (!plan_fits(H, C, stages, 2)) return -1;
  const size_t smem = smem_bytes(H, 2, stages);
  switch (chunks_per_warpgroup(H, C)) {
    case 1: return max_clusters(decode_kernel<1>, C, smem);
    case 2: return max_clusters(decode_kernel<2>, C, smem);
    case 3:
    case 4: return max_clusters(decode_kernel<4>, C, smem);
    default: return max_clusters(decode_kernel<8>, C, smem);
  }
}

inline cudaError_t launch_decode(const CUtensorMap& map, const DecodeArgs& a, int C,
                                 cudaStream_t stream) {
  if (!plan_fits(a.H, C, a.stages, 2) || a.B < 1 || a.V < 1 || a.V > kHeadCols)
    return cudaErrorInvalidValue;
  const int clusters = (a.B + kRows - 1) / kRows;
  const size_t smem = smem_bytes(a.H, 2, a.stages);
  switch (chunks_per_warpgroup(a.H, C)) {
    case 1: return launch_clusters(decode_kernel<1>, clusters, C, smem, stream, map, a);
    case 2: return launch_clusters(decode_kernel<2>, clusters, C, smem, stream, map, a);
    case 3:
    case 4: return launch_clusters(decode_kernel<4>, clusters, C, smem, stream, map, a);
    case 5:
    case 6:
    case 7:
    case 8: return launch_clusters(decode_kernel<8>, clusters, C, smem, stream, map, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rec90
}  // namespace inpaint
