// The Hopper design of the frozen encoder, K1's bf16 route (encoder_gru.cu)
// and K3 (encoder_gru_int8.cu): two kernels, run per chunk of rows by the
// wrapper (ops/encoder_kernel.py) as layer 0, the GEMM, layer 1.
//
// encoder_rec_kernel: one GRU layer of one direction over all the steps for
// a tile of 64 rows. The recurrent product h @ W_hh is a wgmma of the h tile
// (64 x H, in shared memory, double-buffered old/new) by W_hh, whose k-slabs
// stream from L2 through TMA rings: the host stores W_hh^T per direction as
// (3H, Hk) K-major with the rows of each 32-unit chunk grouped [r, z, n], so
// one box of 96 rows x 128 bytes holds the three gates of the same 32 units
// and the gate epilogue runs on the accumulator registers. Four consumer
// warpgroups take chunks in turn (each a 64 x 96 accumulator), each fed by
// one warp of the producer warpgroup through a ring of its own (2 stages in
// bf16, 3 in int8: what shared memory holds beside the h tiles at H 512).
// A step is a long chain per chunk (the products, then the gate math of
// 2,048 (row, unit) pairs with exact f32 exp, tanh and division), so four
// warpgroups let one's gate math run beside another's products. Above H
// 512 in bf16 the two h tiles (2 x 64 x 640 x 2 B at H 577) leave room for
// the rings of two consumer warpgroups only: the wrapper's plan
// (encoder_kernel.encoder_consumers) launches two there, each taking every
// other chunk, each chunk's k-slabs summed in the same order. The new h
// is rounded to bf16 (or quantized with quant_h) into the other h buffer,
// in the swizzled layout the next step's wgmma reads. Layer 0's input
// projection is a row of an f32 (V, 3H) table with b_ih (and on the int8
// route the dequantization) folded in by the host, in the plain version's
// operations; layer 1's comes from the GEMM.
//
// encoder_xw_gemm_kernel: layer 1's input projection for every step of a
// chunk at once, xw[d] = [ys_f | ys_b] @ W_ih1[d] (+ b_ih1[d] in f32 on the
// bf16 route; int32 sums on the int8 route), M = steps x rows, K = 2H,
// N = 3H per direction. K7's context projection (arnn_hopper.cuh) runs the
// same kernel with one direction, K = C, N = 4H and no bias
// (launch_proj_gemm). Persistent blocks (one an SM) walk 128 x 256 tiles;
// one producer warp keeps TMA loads of A and B k-slabs in flight through a
// 4-stage ring gated by mbarriers, across tiles, so a tile's stores overlap
// the next tile's loads; two consumer warpgroups (64 rows each) run wgmma
// with f32 / s32 accumulators.
//
// encoder_xw_gemm_split_kernel: the same GEMM with f32 operands (K1's f32
// route, and K7's: arnn_hopper.cuh), on the tensor cores, which have no
// f32 product. A (M, K) and W^T are each taken as three exact bf16 pieces
// (hi, mid, lo: split3), A's stacked as (3, M, K), W's per direction as
// (dirs, 3, N3, K); six wgmma passes a 64-wide k-slab keep the cross terms
// down to 2^-24 (lh, hl, mm, mh, hm, hh: the smallest first), summed into a
// partial of their own that is added into the result with rounded f32 adds
// (the tensor cores' own f32 sums are not rounded to nearest), and the bias
// is added in f32 after the sum. The partial doubles the accumulators, so
// the tiles are 128 x 128 (two consumer warpgroups of 64 rows, 64 + 64
// registers each), and a stage holds a k-slab of A's and of W's three
// pieces (96 KB, two stages). What bounds it: the passes, six times the
// bf16 GEMM's products at the bf16 peak. With one piece (kPieces 1) it is
// K7's bf16 context projection (launch_proj_gemm_grouped): one pass a
// k-slab, the partial taken over `group` k-slabs before its rounded add,
// four stages of 32 KB. On a deep context (C 3,954) the tensor cores' sum
// over all of K in one accumulator drifted from an IEEE f32 sum far enough
// to flip 0.28 of the early logits' bf16 roundings (PERF.md); a partial of
// 256 values of K (group 4) is the flagship's whole sum, unchanged.
#pragma once

#include "gru_common.cuh"
#include "hopper_common.cuh"

namespace inpaint {
namespace enc90 {

using namespace sm90;

constexpr int kRows = 64;                    // rows of a recurrence block: one wgmma m64 tile
constexpr int kUnits = 32;                   // hidden units of a recurrence chunk
constexpr int kRecN = 3 * kUnits;            // its r, z, n columns: the wgmma N (96)
constexpr int kRecConsumers = 4;             // most consumer warpgroups of a recurrence block
constexpr int kRecStageBytes = kRecN * 128;  // one W_hh k-slab: 12 KB
constexpr int kRecThreads = 128 * kRecConsumers + 128;  // + the producer warpgroup
// what a recurrence block may hold beside its barriers: the 227 KB opt-in
// less 1 KB of alignment and 1 KB
constexpr int kRecSmemBudget = 232448 - 2048;
constexpr int kGemmM = 128;
constexpr int kGemmN = 256;
constexpr int kGemmConsumers = 2;
constexpr int kGemmStages = 4;
constexpr int kGemmABytes = kGemmM * 128;
constexpr int kGemmStageBytes = kGemmABytes + kGemmN * 128;  // 48 KB
constexpr int kGemmThreads = 128 * kGemmConsumers + 32;
constexpr float kHdq = 1.0f / 127.0f;  // dequant of the int8 carry

template <typename HT> struct Enc;
// kRecStages: ring stages per consumer warpgroup, as many as shared memory
// holds beside the two h tiles at H 512 (bf16 128 KB + 4 x 2 x 12 KB; int8
// 64 KB + 4 x 3 x 12 KB)
template <> struct Enc<__nv_bfloat16> {
  using Acc = float;  // products accumulate in f32; layer 1's xw is f32 with b_ih
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int kRecStages = 2;
};
template <> struct Enc<int8_t> {
  using Acc = int;    // exact int32 sums; layer 1's xw is int32
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int kRecStages = 3;
};

// two adjacent elements in one store (the first's offset is even)
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, const __nv_bfloat16 (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(v[0], v[1]);
}
__device__ __forceinline__ void store_pair(int8_t* p, const int8_t (&v)[2]) {
  *reinterpret_cast<char2*>(p) = make_char2(v[0], v[1]);
}
__device__ __forceinline__ void store_pair(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
}

struct RecArgs {
  const int* tokens;  // (B, steps) int32: layer 0
  const float* tab;   // (2, V, 3H) layer 0's input projection table per direction,
                      // b_ih (and on the int8 route the dequantization) folded in
  const void* xw;     // (2, steps * rows, 3H) this chunk's layer-1 input projection
  const float* s_x;   // (2, 3H) int8 layer 1: scales of the input product
  const float* s_h;   // (2, 3H) int8: scales of the recurrent product
  const float* bih;   // (2, 3H) int8 layer 1 (the others have it in tab or xw)
  const float* bhh;   // (2, 3H)
  void* ys;           // (steps, rows, 2H) HT: this chunk's layer-0 outputs [fwd | bwd]
  void* hn;           // (2, B, H) OutT: this layer's final hiddens [fwd, bwd]
  int B, row0, rows, steps, H, V, Hk;  // chunk = rows [row0, row0 + rows); Hk: padded K
  int consumers;                       // consumer warpgroups: 4, or 2 (bf16 above H 512)
  // bf16 layer 0 in training (K1's training mode), else null: the inter-layer
  // dropout keep mask (B, steps, 2H) uint8 [fwd | bwd] of the GLOBAL rows, and
  // 1 - rate; the stored outputs become keep ? bf16(y / keep_div) : 0
  const uint8_t* keep;
  float keep_div;
};

template <typename HT, typename OutT, bool kLayer0>
__global__ void __launch_bounds__(kRecThreads, 1)
    encoder_rec_kernel(const __grid_constant__ CUtensorMap whh_map, const RecArgs p) {
  using Acc = typename Enc<HT>::Acc;
  constexpr bool kInt8 = sizeof(HT) == 1;
  constexpr int kStages = Enc<HT>::kRecStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kRecConsumers][kStages];
  __shared__ __align__(8) uint64_t empty_bar[kRecConsumers][kStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int H = p.H, H3 = 3 * H, rows = p.rows, steps = p.steps;
  const int row_bytes = p.Hk * (int)sizeof(HT);
  const int hbuf = kRows * row_bytes;
  unsigned char* ring = smem + 2 * hbuf;
  const int d = blockIdx.y;  // 0 forward, 1 backward
  const int tile0 = blockIdx.x * kRows;
  const int nchunks = H / kUnits, nslabs = row_bytes / 128;
  const int wg = threadIdx.x >> 7, consumers = p.consumers;

  if (threadIdx.x == 0) {
    for (int w = 0; w < consumers; ++w)
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full_bar[w][s], 1);
        mbar_init(&empty_bar[w][s], 4);  // one arrival per consumer warp
      }
    fence_barrier_init();
  }
  for (int i = threadIdx.x; i < 2 * hbuf / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);  // h0 = 0, K padding 0
  fence_proxy_async();
  __syncthreads();

  if (wg == consumers) {  // the producer warpgroup: warp w keeps consumer w's ring full
    const int w = (threadIdx.x >> 5) & 3;
    if (w < consumers && (threadIdx.x & 31) == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < steps; ++s)
        for (int c = w; c < nchunks; c += consumers)
          for (int k = 0; k < nslabs; ++k) {
            mbar_wait(&empty_bar[w][stage], phase ^ 1);
            mbar_expect_tx(&full_bar[w][stage], kRecStageBytes);
            tma_load_3d(ring + (w * kStages + stage) * kRecStageBytes, &whh_map,
                        &full_bar[w][stage], k * (128 / (int)sizeof(HT)), c * kRecN, d);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
    }
    return;
  }

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  unsigned char* my_ring = ring + wg * kStages * kRecStageBytes;
  unsigned char* h_cur = smem;
  unsigned char* h_nxt = smem + hbuf;
  const float* bih = p.bih + d * H3;
  const float* bhh = p.bhh + d * H3;
  const float* s_x = kInt8 ? p.s_x + d * H3 : nullptr;
  const float* s_h = kInt8 ? p.s_h + d * H3 : nullptr;
  const float* tab = kLayer0 ? p.tab + (size_t)d * p.V * H3 : nullptr;
  const Acc* xw = kLayer0 ? nullptr : static_cast<const Acc*>(p.xw) + (size_t)d * steps * rows * H3;
  HT* ys = static_cast<HT*>(p.ys);
  OutT* hn = static_cast<OutT*>(p.hn);
  int stage = 0;
  uint32_t phase = 0;

  for (int s = 0; s < steps; ++s) {
    const int t = d ? steps - 1 - s : s;
    const bool last = s == steps - 1;
    // the thread's two rows (g and g + 8 of its warp's 16) and their input
    // projection rows (f32, or int32 sums on the int8 route's layer 1)
    const void* in[2];
    bool valid[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lrow = tile0 + 16 * warp + g + 8 * half;
      valid[half] = lrow < rows;
      if constexpr (kLayer0) {
        int tok = valid[half] ? p.tokens[(size_t)(p.row0 + lrow) * steps + t] : 0;
        tok = min(max(tok, 0), p.V - 1);  // never read outside the table
        in[half] = tab + (size_t)tok * H3;
      } else {
        in[half] = xw + ((size_t)t * rows + (valid[half] ? lrow : 0)) * H3;
      }
    }
    for (int c = wg; c < nchunks; c += consumers) {
      if constexpr (!kLayer0) {  // layer 1: pull this chunk's projection into L2
#pragma unroll                   // while the products run
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int gate = 0; gate < 3; ++gate)
            if (valid[half] && q == 0)  // one 128-byte line: the row's 32 units
              prefetch_l2(static_cast<const Acc*>(in[half]) + gate * H + c * kUnits);
      }
      Acc acc[48];
#pragma unroll
      for (int i = 0; i < 48; ++i) acc[i] = Acc(0);
      int prev = 0;
      for (int k = 0; k < nslabs; ++k) {
        mbar_wait(&full_bar[wg][stage], phase);
        wgmma_fence();
        mma_slab(acc, desc_sw128(h_cur + k * kRows * 128),
                 desc_sw128(my_ring + stage * kRecStageBytes), k > 0);
        wgmma_commit();
        if (k > 0) {  // the previous slab's products are done: free its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty_bar[wg][prev]);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(&empty_bar[wg][prev]);

      // the gates of 64 rows x 32 units: acc[a] is r, acc[16 + a] z and
      // acc[32 + a] n of the same (row, unit); a thread holds pairs of
      // adjacent units of its two rows
      const int j0 = c * kUnits;
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * warp + g + 8 * half;
          const int jp = j0 + 8 * n8 + 2 * q;  // the pair's first unit
          const int off = sw128_offset(r, jp * (int)sizeof(HT), kRows);
          uint2 xv[3];
#pragma unroll
          for (int gate = 0; gate < 3; ++gate) {
            const int col = gate * H + jp;
            if constexpr (kLayer0) {
              xv[gate] = *reinterpret_cast<const uint2*>(static_cast<const float*>(in[half]) + col);
            } else {
              xv[gate] = valid[half]
                  ? *reinterpret_cast<const uint2*>(static_cast<const Acc*>(in[half]) + col)
                  : make_uint2(0, 0);
            }
          }
          HT h_store[2];
          float h_new[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = jp + e;
            const int a = 4 * n8 + 2 * half + e;
            float x[3];
#pragma unroll
            for (int gate = 0; gate < 3; ++gate) {
              const uint32_t v = e ? xv[gate].y : xv[gate].x;
              if constexpr (!kLayer0 && kInt8) {
                x[gate] = dequant((int)v, s_x[gate * H + j], bih[gate * H + j]);
              } else {  // b_ih (and the int8 table's dequantization) already in
                x[gate] = __uint_as_float(v);
              }
            }
            float hr, hz, hn_, h;
            if constexpr (kInt8) {
              hr = dequant(acc[a], s_h[j], bhh[j]);
              hz = dequant(acc[16 + a], s_h[H + j], bhh[H + j]);
              hn_ = dequant(acc[32 + a], s_h[2 * H + j], bhh[2 * H + j]);
              h = __fmul_rn((float)*reinterpret_cast<const int8_t*>(h_cur + off + e), kHdq);
            } else {
              hr = acc[a] + bhh[j];
              hz = acc[16 + a] + bhh[H + j];
              hn_ = acc[32 + a] + bhh[2 * H + j];
              h = __bfloat162float(
                  *reinterpret_cast<const __nv_bfloat16*>(h_cur + off + 2 * e));
            }
            h_new[e] = gru_gate(x[0], hr, x[1], hz, x[2], hn_, h);
            if constexpr (kInt8) {
              h_store[e] = quant_h(h_new[e], 127.0f);
            } else {
              h_store[e] = __float2bfloat16_rn(h_new[e]);
            }
          }
          store_pair(reinterpret_cast<HT*>(h_nxt + off), h_store);
          if (valid[half]) {
            const size_t lrow = (size_t)tile0 + r;
            if constexpr (kLayer0) {
              HT* y = ys + (t * rows + lrow) * 2 * H + d * H + jp;
              if constexpr (!kInt8) {
                if (p.keep != nullptr) {  // the dropped outputs; the carry keeps h_store
                  // the mask's row is the global row0 + lrow, its step t
                  const uint8_t* kp =
                      p.keep + ((size_t)(p.row0 + lrow) * steps + t) * 2 * H + d * H + jp;
                  HT dropped[2];
#pragma unroll
                  for (int e = 0; e < 2; ++e)  // a true division, rounded to bf16 once
                    dropped[e] = __float2bfloat16_rn(
                        kp[e] ? __fdiv_rn(__bfloat162float(h_store[e]), p.keep_div) : 0.0f);
                  store_pair(y, dropped);
                } else {
                  store_pair(y, h_store);
                }
              } else {
                store_pair(y, h_store);
              }
            }
            if (last) {
              OutT* o = hn + ((size_t)d * p.B + p.row0 + lrow) * H + jp;
              if constexpr (kInt8) {
                store_pair(o, h_new);  // the unquantized f32 state, rounded once
              } else {
                store_pair(o, h_store);
              }
            }
          }
        }
      }
    }
    // every new h of this step is written: hand them to the next step's
    // wgmma (async proxy), then swap the buffers
    fence_proxy_async();
    named_barrier(1, 128 * consumers);
    unsigned char* tmp = h_cur;
    h_cur = h_nxt;
    h_nxt = tmp;
  }
}

template <typename HT>
__global__ void __launch_bounds__(kGemmThreads, 1)
    encoder_xw_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                           const __grid_constant__ CUtensorMap b_map, const float* bias,
                           typename Enc<HT>::Acc* out, int M, int N3, int K, int dirs) {
  using Acc = typename Enc<HT>::Acc;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kGemmStages];
  __shared__ __align__(8) uint64_t empty_bar[kGemmStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int nslabs = K * (int)sizeof(HT) / 128;
  const int n_per_dir = (N3 + kGemmN - 1) / kGemmN;
  const int n_tiles = dirs * n_per_dir;  // every direction; n fastest, so that
  const int tiles = (M + kGemmM - 1) / kGemmM * n_tiles;  // concurrent tiles share A
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4 * kGemmConsumers);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kGemmConsumers) {  // the producer warp, running ahead across tiles
    if (threadIdx.x == 128 * kGemmConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kGemmM, nt = tile % n_tiles;
        const int d = nt / n_per_dir, n0 = nt % n_per_dir * kGemmN;
        for (int k = 0; k < nslabs; ++k) {
          unsigned char* st = smem + stage * kGemmStageBytes;
          const int kc = k * (128 / (int)sizeof(HT));
          mbar_wait(&empty_bar[stage], phase ^ 1);
          mbar_expect_tx(&full_bar[stage], kGemmStageBytes);
          tma_load_2d(st, &a_map, &full_bar[stage], kc, m0);
          tma_load_3d(st + kGemmABytes, &b_map, &full_bar[stage], kc, n0, d);
          if (++stage == kGemmStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * kGemmM, nt = tile % n_tiles;
    const int d = nt / n_per_dir, n0 = nt % n_per_dir * kGemmN;
    Acc acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = Acc(0);
    int prev = 0;
    for (int k = 0; k < nslabs; ++k) {
      unsigned char* st = smem + stage * kGemmStageBytes;
      mbar_wait(&full_bar[stage], phase);
      wgmma_fence();
      mma_slab(acc, desc_sw128(st + wg * kRows * 128), desc_sw128(st + kGemmABytes), k > 0);
      wgmma_commit();
      if (k > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty_bar[prev]);
      }
      prev = stage;
      if (++stage == kGemmStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(&empty_bar[prev]);

#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int row = m0 + kRows * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
      const int col = n0 + 8 * (i >> 2) + 2 * q;
      if (row < M && col < N3) {  // B's rows past N3 load as zeros
        Acc* o = out + ((size_t)d * M + row) * N3 + col;
        if constexpr (sizeof(HT) == 1) {
          *reinterpret_cast<int2*>(o) = make_int2(acc[i], acc[i + 1]);
        } else if (bias != nullptr) {  // the bias added in f32 after the sum
          const float* b = bias + d * N3 + col;
          *reinterpret_cast<float2*>(o) = make_float2(__fadd_rn(acc[i], b[0]),
                                                      __fadd_rn(acc[i + 1], b[1]));
        } else {
          *reinterpret_cast<float2*>(o) = make_float2(acc[i], acc[i + 1]);
        }
      }
    }
  }
}

constexpr int kSplitM = 128;
constexpr int kSplitN = 128;
// a stage holds a k-slab of A's pieces (3: 48 KB, 1: 16 KB) and of W's
template <int kPieces>
constexpr int kSplitABytes = kPieces * kSplitM * 128;
template <int kPieces>
constexpr int kSplitStageBytes = kSplitABytes<kPieces> + kPieces * kSplitN * 128;
template <int kPieces>
constexpr int kSplitStages = kPieces == 3 ? 2 : 4;
// two consumer warpgroups and a producer warpgroup that hands its registers
// to them (setmaxnreg 40 / 232): at the launch's 168 the kernel spilled 84
// bytes and took 3% longer (PERF.md)
constexpr int kSplitThreads = 128 * kGemmConsumers + 128;

// out (dirs, M, N3) f32 = A @ W[d]^T [+ bias[d]] from their bf16 pieces
// (see the note at the top); a_map boxes a k-slab of the kPieces pieces of
// 128 rows of A, b_map one of the pieces of 128 rows of W[d]^T; each
// partial spans `group` k-slabs (static: this header is compiled into
// several sources)
template <int kPieces>
static __global__ void __launch_bounds__(kSplitThreads, 1)
    encoder_xw_gemm_split_kernel(const __grid_constant__ CUtensorMap a_map,
                                 const __grid_constant__ CUtensorMap b_map, const float* bias,
                                 float* out, int M, int N3, int K, int dirs, int group) {
  static_assert(kPieces == 1 || kPieces == 3, "three pieces (f32) or one (bf16)");
  constexpr int kStages = kSplitStages<kPieces>, kStageBytes = kSplitStageBytes<kPieces>;
  constexpr int kABytes = kSplitABytes<kPieces>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int nslabs = K / 64;
  const int n_per_dir = (N3 + kSplitN - 1) / kSplitN;
  const int n_tiles = dirs * n_per_dir;
  const int tiles = (M + kSplitM - 1) / kSplitM * n_tiles;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4 * kGemmConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kGemmConsumers) {  // the producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * kGemmConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kSplitM, nt = tile % n_tiles;
        const int d = nt / n_per_dir, n0 = nt % n_per_dir * kSplitN;
        for (int k = 0; k < nslabs; ++k) {
          unsigned char* st = smem + stage * kStageBytes;
          mbar_wait(&empty_bar[stage], phase ^ 1);
          mbar_expect_tx(&full_bar[stage], kStageBytes);
          tma_load_3d(st, &a_map, &full_bar[stage], k * 64, m0, 0);
          tma_load_4d(st + kABytes, &b_map, &full_bar[stage], k * 64, n0, 0, d);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * kSplitM, nt = tile % n_tiles;
    const int d = nt / n_per_dir, n0 = nt % n_per_dir * kSplitN;
    float acc[64], part[64];
    int held = -1;  // the stage of a k-slab whose wgmma may still run
    for (int k = 0; k < nslabs; ++k) {
      unsigned char* st = smem + stage * kStageBytes;
      mbar_wait(&full_bar[stage], phase);
      wgmma_fence();
      const bool fresh = k % group == 0;  // a new partial starts at this k-slab
#pragma unroll
      for (int pass = kPieces == 3 ? 0 : 5; pass < 6; ++pass) {
        // (A piece, W piece), smallest terms first: lh, hl, mm, mh, hm, hh
        const int ap = (0x001102 >> (4 * pass)) & 0xF;
        const int bp = (0x010120 >> (4 * pass)) & 0xF;
        const uint64_t da = desc_sw128(st + ap * kSplitM * 128 + wg * kRows * 128);
        const uint64_t db = desc_sw128(st + kABytes + bp * kSplitN * 128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_n128(part, da + 2 * kk, db + 2 * kk,
                          (!fresh || pass > (kPieces == 3 ? 0 : 5) || kk > 0) ? 1 : 0);
      }
      wgmma_commit();
      if ((k + 1) % group == 0 || k + 1 == nslabs) {  // the partial's rounded add
        wgmma_wait<0>();
        fence_operands(part);
        if (lane == 0) {
          if (held >= 0) mbar_arrive(&empty_bar[held]);
          mbar_arrive(&empty_bar[stage]);
        }
        held = -1;
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = k < group ? part[i] : __fadd_rn(acc[i], part[i]);
      } else {  // the slab before is multiplied: hand its stage back
        wgmma_wait<1>();
        if (lane == 0 && held >= 0) mbar_arrive(&empty_bar[held]);
        held = stage;
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = m0 + kRows * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
      const int col = n0 + 8 * (i >> 2) + 2 * q;
      if (row < M && col < N3) {  // W's rows past N3 load as zeros
        float* o = out + ((size_t)d * M + row) * N3 + col;
        if (bias != nullptr) {  // the bias added in f32 after the sum
          const float* b = bias + d * N3 + col;
          *reinterpret_cast<float2*>(o) = make_float2(__fadd_rn(acc[i], b[0]),
                                                      __fadd_rn(acc[i + 1], b[1]));
        } else {
          *reinterpret_cast<float2*>(o) = make_float2(acc[i], acc[i + 1]);
        }
      }
    }
  }
}

// H padded to whole 128-byte k-slabs
template <typename HT>
inline int padded_k(int H) {
  const int e = 128 / (int)sizeof(HT);
  return (H + e - 1) / e * e;
}

// a recurrence block's dynamic shared memory: the two h tiles and the rings
template <typename HT>
inline size_t rec_smem_bytes(int Hk, int consumers) {
  return 2ull * kRows * Hk * sizeof(HT) +
         (size_t)consumers * Enc<HT>::kRecStages * kRecStageBytes + 1024;
}

template <typename HT, typename OutT, bool kLayer0>
static cudaError_t launch_rec(const void* whh, RecArgs a, cudaStream_t stream) {
  a.Hk = padded_k<HT>(a.H);
  if (a.H <= 0 || a.H % 64 != 0 || (a.consumers != 2 && a.consumers != kRecConsumers) ||
      rec_smem_bytes<HT>(a.Hk, a.consumers) > (size_t)kRecSmemBudget)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  const uint64_t dims[3] = {(uint64_t)a.Hk, 3ull * a.H, 2};
  const uint64_t strides[2] = {(uint64_t)a.Hk * sizeof(HT),
                               3ull * a.H * a.Hk * sizeof(HT)};
  const uint32_t box[3] = {128 / (uint32_t)sizeof(HT), (uint32_t)kRecN, 1};
  cudaError_t err = make_map(&map, Enc<HT>::kMap, 3, whh, dims, strides, box);
  if (err != cudaSuccess) return err;
  const size_t smem = rec_smem_bytes<HT>(a.Hk, a.consumers);
  err = cudaFuncSetAttribute(encoder_rec_kernel<HT, OutT, kLayer0>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.rows + kRows - 1) / kRows, 2);
  encoder_rec_kernel<HT, OutT, kLayer0><<<grid, 128 * a.consumers + 128, smem, stream>>>(map, a);
  return cudaGetLastError();
}

// out (dirs, M, N3) = a (M, K) @ w[d]^T for w (dirs, N3, K) K-major
// [+ bias (dirs, N3)]; K a multiple of 128 / sizeof(HT), N3 of 2
template <typename HT>
static cudaError_t launch_proj_gemm(const void* a, const void* w, const float* bias, void* out,
                                    int M, int K, int N3, int dirs, cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  const uint64_t a_dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t a_strides[1] = {(uint64_t)K * sizeof(HT)};
  const uint32_t a_box[2] = {128 / (uint32_t)sizeof(HT), (uint32_t)kGemmM};
  cudaError_t err = make_map(&a_map, Enc<HT>::kMap, 2, a, a_dims, a_strides, a_box);
  if (err != cudaSuccess) return err;
  const uint64_t b_dims[3] = {(uint64_t)K, (uint64_t)N3, (uint64_t)dirs};
  const uint64_t b_strides[2] = {(uint64_t)K * sizeof(HT), (uint64_t)N3 * K * sizeof(HT)};
  const uint32_t b_box[3] = {128 / (uint32_t)sizeof(HT), (uint32_t)kGemmN, 1};
  err = make_map(&b_map, Enc<HT>::kMap, 3, w, b_dims, b_strides, b_box);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)kGemmStages * kGemmStageBytes + 1024;
  err = cudaFuncSetAttribute(encoder_xw_gemm_kernel<HT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kGemmM - 1) / kGemmM * dirs * ((N3 + kGemmN - 1) / kGemmN);
  encoder_xw_gemm_kernel<HT><<<tiles < sms ? tiles : sms, kGemmThreads, smem, stream>>>(
      a_map, b_map, bias, static_cast<typename Enc<HT>::Acc*>(out), M, N3, K, dirs);
  return cudaGetLastError();
}

// out (dirs, M, N3) f32 = a @ w[d]^T [+ bias (dirs, N3)] from their bf16
// pieces: a (kPieces, M, K), w (dirs, kPieces, N3, K) K-major; K a multiple
// of 64, N3 of 2; partials of `group` k-slabs
template <int kPieces>
static cudaError_t launch_pieces_gemm(const void* a, const void* w, const float* bias,
                                      float* out, int M, int K, int N3, int dirs, int group,
                                      cudaStream_t stream) {
  if (M < 1 || K < 64 || K % 64 != 0 || N3 < 2 || N3 % 2 != 0 || dirs < 1 || group < 1)
    return cudaErrorInvalidValue;
  CUtensorMap a_map, b_map;
  const uint64_t a_dims[3] = {(uint64_t)K, (uint64_t)M, kPieces};
  const uint64_t a_strides[2] = {(uint64_t)K * 2, (uint64_t)M * K * 2};
  const uint32_t a_box[3] = {64, (uint32_t)kSplitM, kPieces};
  cudaError_t err = make_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a, a_dims, a_strides,
                             a_box);
  if (err != cudaSuccess) return err;
  const uint64_t b_dims[4] = {(uint64_t)K, (uint64_t)N3, kPieces, (uint64_t)dirs};
  const uint64_t b_strides[3] = {(uint64_t)K * 2, (uint64_t)N3 * K * 2,
                                 (uint64_t)kPieces * N3 * K * 2};
  const uint32_t b_box[4] = {64, (uint32_t)kSplitN, kPieces, 1};
  err = make_map(&b_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, w, b_dims, b_strides, b_box);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)kSplitStages<kPieces> * kSplitStageBytes<kPieces> + 1024;
  err = cudaFuncSetAttribute(encoder_xw_gemm_split_kernel<kPieces>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kSplitM - 1) / kSplitM * dirs * ((N3 + kSplitN - 1) / kSplitN);
  encoder_xw_gemm_split_kernel<kPieces><<<tiles < sms ? tiles : sms, kSplitThreads, smem,
                                           stream>>>(a_map, b_map, bias, out, M, N3, K, dirs,
                                                     group);
  return cudaGetLastError();
}

// out (dirs, M, N3) f32 = a @ w[d]^T [+ bias (dirs, N3)] from their bf16
// pieces: a (3, M, K), w (dirs, 3, N3, K) K-major; K a multiple of 64, N3
// of 2
static cudaError_t launch_proj_gemm_split(const void* a, const void* w, const float* bias,
                                          float* out, int M, int K, int N3, int dirs,
                                          cudaStream_t stream) {
  return launch_pieces_gemm<3>(a, w, bias, out, M, K, N3, dirs, 1, stream);
}

// out (M, N) f32 = a (M, K) bf16 @ w (N, K)^T, K-major, in partials of
// `group` k-slabs added in rounded f32; K a multiple of 64, N of 2
static cudaError_t launch_proj_gemm_grouped(const void* a, const void* w, float* out, int M,
                                            int K, int N, int group, cudaStream_t stream) {
  return launch_pieces_gemm<1>(a, w, nullptr, out, M, K, N, 1, group, stream);
}

// out (2, M, 3H) = a (M, 2H) @ w[d]^T for w (2, 3H, 2H) K-major [+ bias (2, 3H)]
template <typename HT>
static cudaError_t launch_xw_gemm(const void* a, const void* w, const float* bias, void* out,
                                  int M, int H, cudaStream_t stream) {
  return launch_proj_gemm<HT>(a, w, bias, out, M, 2 * H, 3 * H, 2, stream);
}

}  // namespace enc90
}  // namespace inpaint
