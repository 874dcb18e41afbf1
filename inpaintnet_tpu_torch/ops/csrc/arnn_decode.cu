// K7: the AnticipationRNN's argmax decode over all ticks of a row: per tick
// the 2-layer generation LSTM on [previous token, constraint context], the
// Linear -> ReLU -> Linear head, a first-index argmax over the V real
// columns, and the force mask: where force[row, t] > 0 the ground-truth
// token replaces the sampled one, as the output and as the feedback.
//
// Replaces the TPU kernel inpaintnet_tpu/ops/arnn_pallas.py
// arnn_sampled_decode_pallas (_arnn_kernel). Both routes are the Hopper
// designs of arnn_hopper.cuh (entry points at the end of this file:
// arnn_kernel in bf16, the split arnn_f32_kernel in f32), at every
// geometry the wrapper's gate takes. The kernel below, the port's first,
// runs on no route of the wrapper any more: chip_smoke.py and the card
// tests call it directly as the accuracy yardstick of the Hopper routes at
// noisy weights (arnn_kernel.first_kernel_decode). Same numerics: layer 0's
// input projection is prev_xw + ctx_t @ W_ctx + b_ih0 with prev_xw a row of
// the parameter-dtype token table (start_xw at t = 0) and the context
// product inside the loop; products accumulate in f32, biases and gates
// are f32, both layers' h and c are rounded to the parameter dtype after
// every tick; the head's hidden is rounded to the parameter dtype before
// the output product; the logits are unbounded (no ReLU) and written in
// the parameter dtype.
//
// What bounds it on an H100: each tick multiplies the row tile by four
// (K, 4H) matrices (W_ctx, W_hh0, W_ih1, W_hh1) and the two head matrices:
// about 2.2 MB of bf16 weights at the flagship's H = C = 256, streamed from
// L2 every tick, behind a serial chain (layer 0 -> layer 1 -> head -> argmax
// -> feedback) over 384 ticks. As in K2 one block owns a tile of rows and
// loops over the ticks with both layers' h and c in shared memory; the
// feedback is a row lookup, so only the token index is kept between ticks.
// The tick's context rows and the head's tiles share one region of shared
// memory (they are live in different phases of a tick). Occupancy is low
// by design of this first version: batch 512 makes 16 bf16 blocks for 132
// SMs, and batch 1 one block.
#include <string.h>

#include "arnn_hopper.cuh"
#include "encoder_hopper.cuh"
#include "gru_common.cuh"

namespace inpaint {

template <typename T>
struct ArnnArgs {
  const T* ctx;        // (B, S, C) constraint-LSTM outputs
  const int* score;    // (B, S) ground-truth tokens
  const int* force;    // (B, S) 1 where the token is forced
  const T* tok_tab;    // (n_tok, 4H): emb @ W_ih0[:E]
  const T* start_xw;   // (4H,): start_emb @ W_ih0[:E], the tick-0 input
  const void* w_ctx;   // (C, 4H) = W_ih0[E:], packed for bf16
  const void* whh0;    // (H, 4H), packed for bf16
  const void* wih1;    // (H, 4H), packed for bf16
  const void* whh1;    // (H, 4H), packed for bf16
  const T* bias;       // (4, 4H): b_ih0, b_hh0, b_ih1, b_hh1
  const void* w_l1;    // (H, LP), zero columns past the head's width, packed for bf16
  const T* b_l1;       // (LP,)
  const void* w_out;   // (LP, VP), zero rows and columns past the real ones, packed
  const T* b_out;      // (VP,)
  T* logits;           // (B, S, V)
  int* tokens;         // (B, S)
  int B, S, H, C, LP, V, VP;
};

// Bytes of the region that holds the tick's context rows (layer 0) and then
// the head's hidden tile and f32 logits (after layer 1).
template <typename T>
__host__ __device__ inline size_t arnn_region_bytes(int C, int LP, int VP) {
  constexpr int TM = 16 * Traits<T>::MT, pad = Traits<T>::kPad;
  const size_t ctx_bytes = (size_t)TM * (C + pad) * sizeof(T);
  const size_t head_bytes = (size_t)TM * (LP + pad) * sizeof(T) + (size_t)TM * VP * sizeof(float);
  return ctx_bytes > head_bytes ? ctx_bytes : head_bytes;
}

// rows [row0, row0 + tile_m) of a matrix whose rows lie src_stride elements
// apart, into smem (row stride lds), zero-filling rows past rows_total;
// width * sizeof(T) and src_stride * sizeof(T) are multiples of 16.
template <typename T>
__device__ __forceinline__ void load_rows_strided(T* dst, int lds, const T* src,
                                                  size_t src_stride, int width, int row0,
                                                  int tile_m, int rows_total) {
  const int vec = 16 / sizeof(T);
  const int per_row = width / vec;
  for (int idx = threadIdx.x; idx < tile_m * per_row; idx += blockDim.x) {
    const int r = idx / per_row, c = (idx % per_row) * vec;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows_total)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * src_stride + c);
    *reinterpret_cast<uint4*>(dst + r * lds + c) = v;
  }
}

// One LSTM layer for the block's rows: gates = (x-side) + (h @ W_hh + b_hh),
// where the x-side is xin @ W_x + b_x, plus the fed-back token's row for
// layer 0. Writes h_next (padded tile) and updates c in place (each element
// is read and written by the same thread).
template <typename T, bool kLayer0>
__device__ __forceinline__ void lstm_layer(const ArnnArgs<T>& p, const T* xin, int ldx, int K,
                                           const void* w_x, const T* b_x, const T* h_cur,
                                           const void* w_h, const T* b_h, T* h_next, T* c,
                                           int ldh, const int* prev) {
  using Tr = Traits<T>;
  constexpr int MT = Tr::MT;
  const int H = p.H, H4 = 4 * H;
  const int warp = threadIdx.x >> 5;
  for (int ch = 0; ch < H / kChunk; ++ch) {
    const int j0 = ch * kChunk + warp * 8;
    const int nt[4] = {j0 / 8, (H + j0) / 8, (2 * H + j0) / 8, (3 * H + j0) / 8};
    float ax[4][MT][4], ah[4][MT][4];
    zero_acc(ax);
    zero_acc(ah);
    Gemm<T, MT, 4>::run(ax, xin, ldx, K, w_x, H4, nt);
    Gemm<T, MT, 4>::run(ah, h_cur, ldh, H, w_h, H4, nt);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(m, i);
        const int j = j0 + acc_col(i);
        const T* fb = nullptr;
        if (kLayer0) fb = prev[r] < 0 ? p.start_xw : p.tok_tab + (size_t)prev[r] * H4;
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int col = g * H + j;
          float xw = ax[g][m][i];
          if (kLayer0) xw = __fadd_rn(Tr::to_f(fb[col]), xw);
          xw = __fadd_rn(xw, Tr::to_f(b_x[col]));
          const float hw = __fadd_rn(ah[g][m][i], Tr::to_f(b_h[col]));
          gate[g] = __fadd_rn(xw, hw);
        }
        float h_new, c_new;
        lstm_gate(gate, Tr::to_f(c[r * H + j]), h_new, c_new);
        h_next[r * ldh + j] = Tr::from_f(h_new);
        c[r * H + j] = Tr::from_f(c_new);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) arnn_decode_kernel(const ArnnArgs<T> p) {
  using Tr = Traits<T>;
  constexpr int MT = Tr::MT, TM = 16 * MT;
  const int row0 = blockIdx.x * TM;
  const int H = p.H, H4 = 4 * H, B = p.B, S = p.S, VP = p.VP;
  const int ldh = H + Tr::kPad, ldc = p.C + Tr::kPad, ldl = p.LP + Tr::kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h0c = reinterpret_cast<T*>(smem_raw);
  T* h0n = h0c + TM * ldh;
  T* h1c = h0n + TM * ldh;
  T* h1n = h1c + TM * ldh;
  T* c0 = h1n + TM * ldh;
  T* c1 = c0 + TM * H;
  unsigned char* region = reinterpret_cast<unsigned char*>(c1 + TM * H);
  T* cx = reinterpret_cast<T*>(region);    // layer 0: the tick's context rows
  T* hid = reinterpret_cast<T*>(region);   // head: relu(h1 @ W_l1 + b_l1)
  float* lg = reinterpret_cast<float*>(region + (size_t)TM * ldl * sizeof(T));  // f32 logits
  int* prev = reinterpret_cast<int*>(region + arnn_region_bytes<T>(p.C, p.LP, VP));

  for (int idx = threadIdx.x; idx < TM * ldh; idx += blockDim.x) {
    h0c[idx] = Tr::from_f(0.0f);
    h1c[idx] = Tr::from_f(0.0f);
  }
  for (int idx = threadIdx.x; idx < TM * H; idx += blockDim.x) {
    c0[idx] = Tr::from_f(0.0f);
    c1[idx] = Tr::from_f(0.0f);
  }
  for (int r = threadIdx.x; r < TM; r += blockDim.x) prev[r] = -1;
  const int warp = threadIdx.x >> 5;

  for (int t = 0; t < S; ++t) {
    load_rows_strided(cx, ldc, p.ctx + (size_t)t * p.C, (size_t)S * p.C, p.C, row0, TM, B);
    __syncthreads();

    lstm_layer<T, true>(p, cx, ldc, p.C, p.w_ctx, p.bias, h0c, p.whh0, p.bias + H4, h0n, c0,
                        ldh, prev);
    __syncthreads();
    lstm_layer<T, false>(p, h0n, ldh, H, p.wih1, p.bias + 2 * H4, h1c, p.whh1, p.bias + 3 * H4,
                         h1n, c1, ldh, prev);
    __syncthreads();

    // head, first linear: relu in f32, rounded to the parameter dtype
    for (int ntile = warp; ntile < p.LP / 8; ntile += kWarps) {
      const int nt[1] = {ntile};
      float acc[1][MT][4];
      zero_acc(acc);
      Gemm<T, MT, 1>::run(acc, h1n, ldh, H, p.w_l1, p.LP, nt);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = ntile * 8 + acc_col(i);
          const float v = __fadd_rn(acc[0][m][i], Tr::to_f(p.b_l1[col]));
          hid[acc_row(m, i) * ldl + col] = Tr::from_f(fmaxf(v, 0.0f));
        }
      }
    }
    __syncthreads();

    // head, output linear: unbounded f32 logits
    for (int ntile = warp; ntile < VP / 8; ntile += kWarps) {
      const int nt[1] = {ntile};
      float acc[1][MT][4];
      zero_acc(acc);
      Gemm<T, MT, 1>::run(acc, hid, ldl, p.LP, p.w_out, VP, nt);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = ntile * 8 + acc_col(i);
          lg[acc_row(m, i) * VP + col] = __fadd_rn(acc[0][m][i], Tr::to_f(p.b_out[col]));
        }
      }
    }
    __syncthreads();

    // first-index argmax over the V real columns, the force mask, outputs
    for (int r = threadIdx.x; r < TM; r += blockDim.x) {
      const float* row = lg + r * VP;
      float best = row[0];
      int tok = 0;
      for (int v = 1; v < p.V; ++v) {
        if (row[v] > best) {
          best = row[v];
          tok = v;
        }
      }
      if (row0 + r < B) {
        const size_t o = (size_t)(row0 + r) * S + t;
        if (p.force[o] > 0) tok = p.score[o];
        p.tokens[o] = tok;
      }
      prev[r] = tok;
    }
    for (int idx = threadIdx.x; idx < TM * p.V; idx += blockDim.x) {
      const int r = idx / p.V, v = idx % p.V;
      if (row0 + r < B)
        p.logits[((size_t)(row0 + r) * S + t) * p.V + v] = Tr::from_f(lg[r * VP + v]);
    }
    __syncthreads();
    T* tmp = h0c;
    h0c = h0n;
    h0n = tmp;
    tmp = h1c;
    h1c = h1n;
    h1n = tmp;
  }
}

template <typename T>
static cudaError_t arnn_decode(const ArnnArgs<T>& a, cudaStream_t stream) {
  using Tr = Traits<T>;
  constexpr int TM = 16 * Tr::MT;
  if (a.H % kChunk || a.C % kChunk || a.LP % 16 || a.VP % 8 || a.V > a.VP || a.V < 1)
    return cudaErrorInvalidValue;
  const size_t smem = (4ull * TM * (a.H + Tr::kPad) + 2ull * TM * a.H) * sizeof(T) +
                      arnn_region_bytes<T>(a.C, a.LP, a.VP) + TM * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(arnn_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  arnn_decode_kernel<T><<<(a.B + TM - 1) / TM, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

namespace rec90 {

// the half-box instantiations arnn_kernel<1, kChunks, true>, built in a
// source of their own (arnn_decode_half.cu), in parallel with this one
cudaError_t launch_arnn_half(const CUtensorMap& map, const ArnnArgs& a, int C, int clusters,
                             size_t smem, cudaStream_t stream);
int arnn_half_slots(int C, size_t smem);

inline int arnn_slots(int H, int C, int HT, int stages, int halves) {
  if (!arnn_plan_fits(H, C, HT, HT, 1, stages, halves)) return -1;
  const size_t smem = arnn_smem_bytes(H, C, HT, stages, halves);
  if (halves == 1) return arnn_half_slots(C, smem);
  switch (chunks_per_warpgroup(H, C)) {
    case 1: return arnn_kernel_slots(arnn_kernel<1, false>, C, smem);
    case 2: return arnn_kernel_slots(arnn_kernel<2, false>, C, smem);
    default: return arnn_kernel_slots(arnn_kernel<4, false>, C, smem);
  }
}

inline cudaError_t launch_arnn(const CUtensorMap& map, const ArnnArgs& a, int C, int halves,
                               cudaStream_t stream) {
  if (!arnn_plan_fits(a.H, C, a.LP, a.HT, a.V, a.stages, halves) || a.B < 1 || a.S < 1 ||
      !(a.OK == 2 || (a.OK == 4 && (a.HT == a.LP || a.HT % 256 == 0))))
    return cudaErrorInvalidValue;
  const int clusters = (a.B + kRows - 1) / kRows;
  const size_t smem = arnn_smem_bytes(a.H, C, a.HT, a.stages, halves);
  if (halves == 1) return launch_arnn_half(map, a, C, clusters, smem, stream);
  const bool one = out_chunks(a.V) == 1 && a.HT == a.LP && a.OK == 4;
  return one ? launch_arnn_as<false>(map, a, C, clusters, smem, stream)
             : launch_arnn_as<true>(map, a, C, clusters, smem, stream);
}

inline int arnn_f32_slots(int H, int C, int LP) {
  if (!arnn_f32_plan_fits(H, C, LP, 1)) return -1;
  return max_clusters(arnn_f32_kernel<false>, C, arnn_f32_smem_bytes(H, C), kF32Threads);
}

inline cudaError_t launch_arnn_f32(const CUtensorMap& w_map, const ArnnF32Args& a, int C,
                                   cudaStream_t stream) {
  if (!arnn_f32_plan_fits(a.H, C, a.LP, a.V) || a.B < 1 || a.S < 1 || a.scratch == nullptr)
    return cudaErrorInvalidValue;
  const int tiles = (a.B + kRows - 1) / kRows, wd = a.H > a.LP ? a.H : a.LP;
  CUtensorMap a_map;  // the scratch's planes of (64 rows, wd), three pieces a box
  const uint64_t dims[3] = {(uint64_t)wd, (uint64_t)kRows, (uint64_t)tiles * 18};
  const uint64_t strides[2] = {(uint64_t)wd * 2, (uint64_t)kRows * wd * 2};
  const uint32_t box[3] = {64, (uint32_t)kRows, 3};
  cudaError_t err = make_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.scratch, dims,
                             strides, box);
  if (err != cudaSuccess) return err;
  const size_t smem = arnn_f32_smem_bytes(a.H, C);
  const auto kernel = out_chunks(a.V) > 1 ? arnn_f32_kernel<true> : arnn_f32_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C, 1, 1);
  cfg.blockDim = dim3(kF32Threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, w_map, a_map, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace rec90
}  // namespace inpaint

// The first kernel (arnn_kernel.first_kernel_decode, a yardstick): dtype 0
// = float32, 1 = bfloat16. Tensors as documented on ArnnArgs. Returns the
// cudaError_t of the launch (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int inpaint_arnn_decode(int dtype, const void* ctx, const void* score,
                                   const void* force, const void* tok_tab, const void* start_xw,
                                   const void* w_ctx, const void* whh0, const void* wih1,
                                   const void* whh1, const void* bias, const void* w_l1,
                                   const void* b_l1, const void* w_out, const void* b_out,
                                   void* logits, void* tokens, int B, int S, int H, int C,
                                   int LP, int V, int VP, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define INPAINT_ARNN_ARGS(T)                                                                   \
  inpaint::ArnnArgs<T> a{static_cast<const T*>(ctx),      static_cast<const int*>(score),     \
                         static_cast<const int*>(force),  static_cast<const T*>(tok_tab),     \
                         static_cast<const T*>(start_xw), w_ctx,                              \
                         whh0,                            wih1,                               \
                         whh1,                            static_cast<const T*>(bias),        \
                         w_l1,                            static_cast<const T*>(b_l1),        \
                         w_out,                           static_cast<const T*>(b_out),       \
                         static_cast<T*>(logits),         static_cast<int*>(tokens),          \
                         B, S, H, C, LP, V, VP};                                              \
  return (int)inpaint::arnn_decode<T>(a, s);
  if (dtype == 0) {
    INPAINT_ARNN_ARGS(float)
  }
  if (dtype == 1) {
    INPAINT_ARNN_ARGS(__nv_bfloat16)
  }
#undef INPAINT_ARNN_ARGS
  return (int)cudaErrorInvalidValue;
}

// The bf16 route (arnn_hopper.cuh): `map` is inpaint_arnn_map's over
// arnn_kernel.pack_arnn_weights; `xwc` (B, S, 4H) f32 is ctx @ W_ctx
// (inpaint_arnn_ctx_gemm); `cluster` CTAs share each 64-row tile and
// `stages` is the depth of each consumer warpgroup's ring, HT the hidden
// tile's width, `out_kslabs` the k-slabs of a W_out^T block and `halves`
// the half k-slabs of a box, the map's (arnn_kernel.arnn_plan,
// arnn_hid_cols, arnn_out_kslabs, arnn_box_halves). bias (4, 4H),
// b_l1 (LP,), b_out (64 NOC,) bf16; score, force (B, S) int32; logits (B,
// S, V) bf16; tokens (B, S) int32; `ties` 0 (1: the planted fault of
// gru_layer_hopper.cuh head_beats).
extern "C" int inpaint_arnn_decode_bf16(const void* map, const void* xwc, const void* score,
                                        const void* force, const void* tok_tab,
                                        const void* start_xw, const void* bias, const void* b_l1,
                                        const void* b_out, void* logits, void* tokens, int B,
                                        int S, int H, int LP, int HT, int V, int cluster,
                                        int stages, int ties, int out_kslabs, int halves,
                                        void* stream) {
  if (map == nullptr) return (int)cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  CUtensorMap m;
  memcpy(&m, map, sizeof(m));
  const inpaint::rec90::ArnnArgs a{static_cast<const float*>(xwc), static_cast<const int*>(score),
                                   static_cast<const int*>(force), static_cast<const T*>(tok_tab),
                                   static_cast<const T*>(start_xw), static_cast<const T*>(bias),
                                   static_cast<const T*>(b_l1), static_cast<const T*>(b_out),
                                   static_cast<T*>(logits), static_cast<int*>(tokens),
                                   B, S, H, LP, HT, V, stages, ties, out_kslabs};
  return (int)inpaint::rec90::launch_arnn(m, a, cluster, halves,
                                          static_cast<cudaStream_t>(stream));
}

// Encode into `map_out` (128 bytes, 64-byte aligned) the tensor map of
// `blocks` packed 128 x 64 bf16 blocks (arnn_kernel.pack_arnn_weights),
// boxes of `halves` halves of a block (arnn_kernel.arnn_box_halves).
extern "C" int inpaint_arnn_map(const void* packed, int blocks, int halves, void* map_out) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  return (int)inpaint::rec90::make_lstm_map(static_cast<CUtensorMap*>(map_out), packed, blocks,
                                            halves);
}

// Clusters of `cluster` CTAs of the bf16 route at width H with a hidden
// tile of HT columns and `stages` ring stages of boxes of `halves` half
// k-slabs that the card runs at once; -1 where the plan does not fit.
extern "C" int inpaint_arnn_slots(int H, int cluster, int HT, int stages, int halves) {
  return inpaint::rec90::arnn_slots(H, cluster, HT, stages, halves);
}

// The bf16 route's context projection: out (M, N) f32 = ctx (M, K) bf16 @
// w_t (N, K)^T, w_t = W_ctx^T K-major; K a multiple of 64, N of 2. The
// tensor cores sum `group` k-slabs of 64 into a partial, and the partials
// are added in rounded f32 (arnn_kernel.ARNN_CTX_GROUP); group 0 takes the
// whole of K in one accumulator (encoder_xw_gemm_kernel), the checks'
// yardstick of what that does on a deep context.
extern "C" int inpaint_arnn_ctx_gemm(const void* ctx, const void* w_t, void* out, int M, int K,
                                     int N, int group, void* stream) {
  if (K % 64 != 0 || N % 2 != 0 || M < 1 || group < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 0)
    return (int)inpaint::enc90::launch_proj_gemm<__nv_bfloat16>(ctx, w_t, nullptr, out, M, K,
                                                                N, 1, s);
  return (int)inpaint::enc90::launch_proj_gemm_grouped(ctx, w_t, static_cast<float*>(out), M, K,
                                                       N, group, s);
}

// The f32 route (arnn_hopper.cuh arnn_f32_kernel): `map` is
// inpaint_arnn_f32_map's over arnn_kernel.pack_arnn_f32_weights; `xwc` (B,
// S, 4H) f32 is ctx @ W_ctx (inpaint_arnn_ctx_gemm_f32); `scratch` (tiles,
// 3, 2, 3, 64, max(H, LP)) bf16, zero; `cluster` CTAs share each 64-row
// tile (arnn_kernel.arnn_f32_plan). tok_tab (n_tok, 4H), start_xw (4H,),
// bias (4, 4H), b_l1 (LP,), b_out (128 pairs,) f32; score, force (B, S)
// int32; logits (B, S, V) f32; tokens (B, S) int32; `ties` 0 (1: the
// planted fault of head_beats).
extern "C" int inpaint_arnn_decode_f32(const void* map, const void* xwc, const void* score,
                                       const void* force, const void* tok_tab,
                                       const void* start_xw, const void* bias, const void* b_l1,
                                       const void* b_out, void* logits, void* tokens,
                                       void* scratch, int B, int S, int H, int LP, int V,
                                       int cluster, int ties, void* stream) {
  if (map == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memcpy(&m, map, sizeof(m));
  const inpaint::rec90::ArnnF32Args a{
      static_cast<const float*>(xwc),     static_cast<const int*>(score),
      static_cast<const int*>(force),     static_cast<const float*>(tok_tab),
      static_cast<const float*>(start_xw), static_cast<const float*>(bias),
      static_cast<const float*>(b_l1),    static_cast<const float*>(b_out),
      static_cast<float*>(logits),        static_cast<int*>(tokens),
      static_cast<__nv_bfloat16*>(scratch), B, S, H, LP, V, ties};
  return (int)inpaint::rec90::launch_arnn_f32(m, a, cluster, static_cast<cudaStream_t>(stream));
}

// Encode into `map_out` (128 bytes, 64-byte aligned) the tensor map of
// `blocks` packed 64 x 64 bf16 blocks (arnn_kernel.pack_arnn_f32_weights).
extern "C" int inpaint_arnn_f32_map(const void* packed, int blocks, void* map_out) {
  if (blocks < 6) return (int)cudaErrorInvalidValue;
  return (int)inpaint::rec90::make_arnn_f32_map(static_cast<CUtensorMap*>(map_out), packed,
                                                blocks);
}

// Clusters of `cluster` CTAs of the f32 route at widths H and LP that the
// card runs at once; -1 where the plan does not fit.
extern "C" int inpaint_arnn_f32_slots(int H, int cluster, int LP) {
  return inpaint::rec90::arnn_f32_slots(H, cluster, LP);
}

// The f32 route's context projection: out (M, N) f32 = ctx @ W_ctx from the
// pieces ctx (3, M, K) and w (3, N, K) (W_ctx^T's, K-major) bf16; K a
// multiple of 64, N of 2.
extern "C" int inpaint_arnn_ctx_gemm_f32(const void* ctx, const void* w, void* out, int M, int K,
                                         int N, void* stream) {
  return (int)inpaint::enc90::launch_proj_gemm_split(ctx, w, nullptr, static_cast<float*>(out), M,
                                                     K, N, 1, static_cast<cudaStream_t>(stream));
}
