// K2: the hierarchical decoder's 24-tick argmax decode of one measure per
// row: per tick, the 2-layer tick GRU, the ReLU head, a first-index argmax,
// and the sampled token's row of the fused token table fed back as the next
// tick's layer-0 input projection. At t % 6 == 0 both hiddens reset to the
// beat's init hiddens.
//
// Replaces the TPU kernel inpaintnet_tpu/ops/decode_pallas.py
// decode_sampling_pallas (_decode_kernel). Same numerics: products
// accumulate in f32, biases and gates in f32, both carries rounded to the
// parameter dtype after every tick, the feedback row is a row of the
// parameter-dtype table, logits are written in the parameter dtype, and the
// argmax runs on the f32 logits and takes the first index among equal
// maxima. It scans only the V real columns, so the TPU kernel's -1 padding
// trick is not needed.
//
// What bounds it on an H100: each tick multiplies the row tile by three
// (H, 3H) matrices and the (H, V) head: about 4.6 MB of bf16 weights at
// H = 512, streamed from L2 every tick, behind a serial chain (layer 0 ->
// layer 1 -> head -> argmax -> feedback) that allows no overlap across
// ticks.
//
// bf16 route (every serving default): decode_hopper.cuh, TMA-fed wgmma
// products with the units of each 64-row tile split across a thread-block
// cluster (its note gives the design).
//
// f32 route: decode_f32_kernel below, decode_hopper.cuh's tick chain as a
// cluster recurrence with every product split into six bf16 wgmma passes
// over exact pieces (its note gives the design).
#include <string.h>

#include "decode_hopper.cuh"

namespace inpaint {
namespace rec90 {

// The bf16 route's launchers (here, not in decode_hopper.cuh, so that
// decode_sampling_int8.cu does not compile its kernels again). Two sources
// of their own, built beside this one in parallel, hold the instantiations
// of a head of more than one chunk (decode_sampling_chunks.cu) and those of
// half-slab boxes (decode_box_halves 1, H 768: decode_sampling_half.cu).
cudaError_t launch_decode_chunks(const CUtensorMap& map, const DecodeArgs& a, int C, int clusters,
                                 size_t smem, cudaStream_t stream);
cudaError_t launch_decode_half(const CUtensorMap& map, const DecodeArgs& a, int C, int clusters,
                               size_t smem, cudaStream_t stream);
int decode_half_slots(int H, int C, size_t smem);

inline int decode_slots(int H, int C, int stages) {
  if (!decode_plan_fits(H, C, stages, 2, 128)) return -1;
  const size_t smem = decode_smem_bytes(H, 2, stages, 128);
  if (decode_box_halves(H, 2, 128) == 1) return decode_half_slots(H, C, smem);
  switch (chunks_per_warpgroup(H, C)) {
    case 1: return max_clusters(decode_kernel<1, false>, C, smem, kDecodeThreads);
    case 2: return max_clusters(decode_kernel<2, false>, C, smem, kDecodeThreads);
    case 3:
    case 4: return max_clusters(decode_kernel<4, false>, C, smem, kDecodeThreads);
    default: return max_clusters(decode_kernel<8, false>, C, smem, kDecodeThreads);
  }
}

inline cudaError_t launch_decode(const CUtensorMap& map, const DecodeArgs& a, int C,
                                 cudaStream_t stream) {
  if (!decode_plan_fits(a.H, C, a.stages, 2, 128) || a.B < 1 || a.V < 1)
    return cudaErrorInvalidValue;
  const int clusters = (a.B + kRows - 1) / kRows;
  const size_t smem = decode_smem_bytes(a.H, 2, a.stages, 128);
  if (decode_box_halves(a.H, 2, 128) == 1)
    return launch_decode_half(map, a, C, clusters, smem, stream);
  return head_chunks(a.V) > 1 ? launch_decode_chunks(map, a, C, clusters, smem, stream)
                              : launch_decode_as<false>(map, a, C, clusters, smem, stream);
}

// ---------------------------------------------------------------------------
// K2's f32 route: the same tick chain with every product split
// ---------------------------------------------------------------------------
// It replaces, in f32, the TPU kernel decode_sampling_pallas
// (_decode_kernel), and the first port's kernel (one 16-row block a tile,
// scalar FMA products: 200 ms at 12,288 rows on an H100).
// What bounds it: the f32 products, 2 x 12,288 x 24 x 2.41M operations at
// the flagship's batch-2048 call (1.42 TFLOP: 21.2 ms of f32 FMA), on the
// tensor cores six bf16 passes (8.6 ms at the bf16 peak), behind the
// 24-tick serial chain of each tile.
//
// Design (decode_kernel.f32_plan picks the cluster size C), arnn_f32_kernel's
// (arnn_hopper.cuh) carried to the GRU:
// - Every product (W_hh0, W_ih1, W_hh1 and the head) is split: operand and
//   weight each as three exact bf16 pieces (split3), six wgmma passes a
//   64-wide k-slab into a partial of its own, added into the sum with
//   rounded f32 adds (gru_layer_hopper.cuh f32_product, n48 tiles).
// - Three-piece f32 h tiles of H 512 do not fit a CTA's shared memory
//   beside a ring (2 x 3 x 64 x 512 x 2 B = 384 KB), so h0's and h1's
//   pieces go through an L2 scratch, (tile, layer, tick parity, piece, 64
//   rows, H): after each layer every CTA writes its units' pieces there and
//   arrives on every peer's `ready` mbarrier of that layer; the producer
//   warp streams each k-slab of the operand's pieces (one TMA box, 24 KB)
//   with the k-slab of two chunks' weight pieces (one box of six 6 KB
//   blocks) through the ring. The parity keeps a layer's tick t + 2 pieces
//   from landing before every CTA has read its tick t ones.
// - At t % 6 == 0 the products on h take the beat's init hiddens: their
//   pieces come from a second map, over the wrapper's split of h_inits
//   (decode_kernel.decode_f32_data), not from the scratch of tick t - 1,
//   and the gates' old h is the init hidden (f32, from hi0 / hi1).
// - Registers: layer 1's x- and h-products keep accumulators of their own,
//   summed (x + b_ih1) + (h + b_hh1) as the plain version, each beside the
//   slab's partial: so a chunk is 16 units (its r, z, n rows are a 64 x 48
//   tile, 24 registers an accumulator), a warpgroup takes one chunk a round,
//   and a CTA owns U = H / C units in U / 32 rounds. Its f32 carries (both
//   layers) stay in shared memory.
// - Every CTA computes the head on the same h1 pieces, chunk by chunk of 96
//   columns (V zero-padded to whole chunks; 48 a warpgroup), and takes the
//   same argmax (decode_hopper.cuh head_argmax for one chunk, head_chunk and
//   head_finish over more), so no
//   token is exchanged; CTA 0 writes the logits (f32) and the tokens.
//   Every cluster size sums in the same order, so all give
//   bit-equal outputs: the check for a race in the exchange.
// - Rows past B compute on zeros (and the tokens they feed back) and are
//   never stored; x_0 is the fed-back input at tick 0 only.
constexpr int kDecF32Units = 16;                        // units of a chunk: r, z, n rows = 48
constexpr int kDecF32Block = 3 * kDecF32Units * 128;    // a 48 x 64 bf16 block of weights: 6 KB
constexpr int kDecF32StageBytes = kF32ABytes + 6 * kDecF32Block;  // + two chunks' pieces: 60 KB
constexpr int kDecF32MaxStages = 4;
constexpr int kDecF32CarryPad = 8;                      // f32 padding of the carries' rows

struct DecodeF32Args {
  const float* ctx_xw;   // (4, B, 3H): beat-context part of x @ W_ih0, b_ih0 folded in
  const float* hi0;      // (4, B, H) per-beat layer-0 init hiddens
  const float* hi1;      // (4, B, H) per-beat layer-1 init hiddens
  const float* tok_tab;  // (V, 3H): emb @ W_ih0[:E]
  const float* x0_xw;    // (3H,): x_0 @ W_ih0[:E], the tick-0 input
  const float* bias;     // (3, 3H): b_hh0, b_ih1, b_hh1
  const float* head_b;   // (96 NHC,), zero past V
  float* logits;         // (B, 24, V)
  int* samples;          // (B, 24)
  __nv_bfloat16* scratch;  // (tiles, 2, 2, 3, 64, H): h0's and h1's pieces by tick parity
  int B, H, V, stages, ties;
};

// The GRU cells of a round's chunk: units j0 + 8 n8 + 2q + e of rows r =
// 16 warp + g + 8 half, gate gi's (x, h) pre-activations xh(gi, r, gi H +
// unit, a), a = 8 gi + 4 n8 + 2 half + e their accumulator index; the old
// h from the carry `c` (rows of ldc, the chunk's first unit at jl0), or at
// a reset tick from the init hiddens `hi` (B, H) (zeros past B); the new h
// into the carry and its pieces into the scratch plane `pl`.
template <typename XH>
__device__ __forceinline__ void decode_f32_cells(XH xh, float* c, int ldc, const float* hi,
                                                 bool reset, int jl0, int j0, int tile0, int B,
                                                 int H, __nv_bfloat16* scratch, int pl) {
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
#pragma unroll
  for (int n8 = 0; n8 < 2; ++n8) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + g + 8 * half, row = tile0 + r, unit = j0 + 8 * n8 + 2 * q;
      float* cp = c + r * ldc + jl0 + 8 * n8 + 2 * q;
      const float2 old = !reset  ? *reinterpret_cast<const float2*>(cp)
                         : row < B ? ldg_f2(hi + (size_t)row * H + unit)
                                   : make_float2(0.0f, 0.0f);
      float hv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x[3], h[3];
#pragma unroll
        for (int gi = 0; gi < 3; ++gi) {
          const float2 v = xh(gi, r, gi * H + unit + e, 8 * gi + 4 * n8 + 2 * half + e);
          x[gi] = v.x;
          h[gi] = v.y;
        }
        hv[e] = gru_gate(x[0], h[0], x[1], h[1], x[2], h[2], e ? old.y : old.x);
      }
      *reinterpret_cast<float2*>(cp) = make_float2(hv[0], hv[1]);
      f32_put(scratch, pl, H, r, unit, hv[0], hv[1]);
    }
  }
}

// The packed weights (decode_kernel.pack_decode_f32_weights): 6 KB blocks
// of 48 rows x 64 of K, six a k-slab of two chunks ([piece][chunk]): W_hh0,
// W_ih1 and W_hh1 by pairs of 16-unit chunks (row 16 g + u of chunk c the
// weight's column g H + 16 c + u), then the head's W^T by chunks of 96
// columns (zero past V), each chunk one pair, by k-slab. `i_map` is over the pieces of the init
// hiddens, (layer, beat, piece, rows padded to tiles, H). kChunks: the head
// over more than one chunk (decode_hopper.cuh decode_kernel's).
template <bool kChunks>
__global__ void __launch_bounds__(kDecodeThreads, 1)
    decode_f32_kernel(const __grid_constant__ CUtensorMap w_map,
                      const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap i_map,
                      const __grid_constant__ DecodeF32Args p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kDecF32MaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kDecF32MaxStages];
  __shared__ __align__(8) uint64_t ready[2];  // every CTA's h0 / h1 pieces of a tick
  __shared__ int prev_tok[kRows];
  __shared__ float head_best[kConsumers][kRows];
  __shared__ int head_arg[kConsumers][kRows];
  unsigned char* ring = align1024(smem_raw);
  const int H = p.H, H3 = 3 * H, KB = H / 64, B = p.B, nhc = head_chunks(p.V);
  const int C = (int)cluster_nctarank();
  const uint32_t rank = cluster_ctarank();
  const int U = H / C, rounds = U / 32, pair0 = (int)rank * rounds;
  const int tile = (int)(blockIdx.x / C), tile0 = tile * kRows;
  const int wg = threadIdx.x >> 7;
  const int ldc = U + kDecF32CarryPad;
  float* c0 = reinterpret_cast<float*>(ring + p.stages * kDecF32StageBytes);
  float* c1 = c0 + kRows * ldc;
  const int pairs = H / 32;  // chunk pairs of one weight
  const int blk_ih1 = pairs * KB * 6, blk_hh1 = 2 * blk_ih1, blk_head = 3 * blk_ih1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) mbar_init(&ready[i], C);
    fence_barrier_init();
  }
  if (threadIdx.x < kRows) prev_tok[threadIdx.x] = -1;
  __syncthreads();
  cluster_sync();

  // the first scratch plane (of three pieces) of `layer` at tick parity `par`
  const auto plane = [&](int layer, int par) { return ((tile * 2 + layer) * 2 + par) * 3; };
  if (wg == kConsumers) {  // the producer, in the consumers' order of use
    setmaxnreg_dec<kDecodeProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      int stage = 0;
      uint32_t phase = 0;
      // a stage: the operand's k-slab k (from the scratch, or at a reset
      // tick from the init hiddens' pieces) and the weights' blocks
      const auto load = [&](const CUtensorMap* map, int row, int pl, int k, int block) {
        unsigned char* st = ring + stage * kDecF32StageBytes;
        mbar_wait_bounded<false>(&empty_bar[stage], phase ^ 1);
        mbar_expect_tx(&full_bar[stage], kDecF32StageBytes);
        tma_load_3d(st, map, &full_bar[stage], k * 64, row, pl);
        tma_load_3d(st + kF32ABytes, &w_map, &full_bar[stage], 0, 0, block);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      };
      // every CTA's pieces of this tick's layer are written
      const auto wait_ready = [&](int i, int t) {
        mbar_wait_bounded<true>(&ready[i], t & 1);
        fence_proxy_async_global();
      };
      for (int t = 0; t < kTicks; ++t) {
        const int cur = t & 1, prev = cur ^ 1, beat = t / kTicksPerBeat;
        const bool reset = t % kTicksPerBeat == 0;
        // the h operand of `layer`: the init hiddens' pieces, or tick t - 1's
        const auto h_load = [&](int layer, int k, int block) {
          if (reset)
            load(&i_map, tile0, (layer * 4 + beat) * 3, k, block);
          else
            load(&a_map, 0, plane(layer, prev), k, block);
        };
        for (int r = 0; r < rounds; ++r)
          for (int k = 0; k < KB; ++k) h_load(0, k, ((pair0 + r) * KB + k) * 6);
        wait_ready(0, t);
        for (int r = 0; r < rounds; ++r) {
          for (int k = 0; k < KB; ++k)
            load(&a_map, 0, plane(0, cur), k, blk_ih1 + ((pair0 + r) * KB + k) * 6);
          for (int k = 0; k < KB; ++k) h_load(1, k, blk_hh1 + ((pair0 + r) * KB + k) * 6);
        }
        wait_ready(1, t);
        for (int j = 0; j < nhc; ++j)
          for (int k = 0; k < KB; ++k)
            load(&a_map, 0, plane(1, cur), k, blk_head + (chunk_at(j, nhc, p.ties) * KB + k) * 6);
      }
    }
    cluster_sync();
    return;
  }

  const int tid = threadIdx.x, lane = tid & 31, q = lane & 3;
  setmaxnreg_inc<kDecodeConsumerRegs>();
  F32Ring rg{ring, full_bar, empty_bar, p.stages, kDecF32StageBytes, kDecF32Block, 0, 0};
  const DecodeCta cta{nullptr, nullptr, prev_tok, nullptr, nullptr, H, KB, tile0, 0, 0, wg};
  // the pieces are written: make them visible to the peers' TMA loads, then
  // tell every CTA of the cluster (thread c tells CTA c)
  const auto publish = [&](int i) {
    __threadfence();
    fence_proxy_async_global();
    named_barrier(kBar, kConsumerThreads);
    if (tid < C) mbar_arrive_cluster(mapa(smem_u32(&ready[i]), tid));
  };
  for (int t = 0; t < kTicks; ++t) {
    const int cur = t & 1, beat = t / kTicksPerBeat;
    const bool reset = t % kTicksPerBeat == 0;
    // the last tick's head is done: prev_tok is set
    named_barrier(kBar, kConsumerThreads);
    // layer 0: (the fed-back row + the beat context), (acc + b_hh0)
    for (int r = 0; r < rounds; ++r) {
      const int jl0 = 32 * r + kDecF32Units * wg, j0 = (int)rank * U + jl0;
      float acc[24];
      f32_product(rg, acc, KB, true, wg, lane);
      decode_f32_cells(
          [&](int gi, int rr, int col, int a) {
            const int row = tile0 + rr, prev = prev_tok[rr];
            const float f = (prev < 0 ? p.x0_xw : p.tok_tab + (size_t)prev * H3)[col];
            const float x =
                row < B ? __fadd_rn(f, p.ctx_xw[((size_t)beat * B + row) * H3 + col]) : f;
            return make_float2(x, __fadd_rn(acc[a], p.bias[col]));
          },
          c0, ldc, p.hi0 + (size_t)beat * B * H, reset, jl0, j0, tile0, B, H, p.scratch,
          plane(0, cur));
    }
    publish(0);
    // layer 1: (h0' @ W_ih1 + b_ih1), (h1 @ W_hh1 + b_hh1)
    for (int r = 0; r < rounds; ++r) {
      const int jl0 = 32 * r + kDecF32Units * wg, j0 = (int)rank * U + jl0;
      float ax[24], ah[24];
      f32_product(rg, ax, KB, true, wg, lane);
      f32_product(rg, ah, KB, true, wg, lane);
      decode_f32_cells(
          [&](int gi, int rr, int col, int a) {
            return make_float2(__fadd_rn(ax[a], p.bias[H3 + col]),
                               __fadd_rn(ah[a], p.bias[2 * H3 + col]));
          },
          c1, ldc, p.hi1 + (size_t)beat * B * H, reset, jl0, j0, tile0, B, H, p.scratch,
          plane(1, cur));
    }
    publish(1);
    // the head on every CTA, chunk hc: relu(h1 @ W + b), columns 96 hc + 48 wg + [0, 48)
    if constexpr (!kChunks) {
      float lg[24];
      f32_product(rg, lg, KB, true, wg, lane);
#pragma unroll
      for (int i = 0; i < 24; ++i) {
        const int col = 48 * wg + 8 * (i >> 2) + 2 * q + (i & 1);
        lg[i] = fmaxf(__fadd_rn(lg[i], p.head_b[col]), 0.0f);
      }
      head_argmax(lg, p.logits, p.samples, B, p.V, cta, rank, t, head_best, head_arg);
    } else {
      float best[2] = {-INFINITY, -INFINITY};
      int arg[2] = {INT_MAX, INT_MAX};
      for (int j = 0; j < nhc; ++j) {
        const int c0 = kHeadCols * chunk_at(j, nhc, p.ties) + 48 * wg;
        float lg[24];
        f32_product(rg, lg, KB, true, wg, lane);
#pragma unroll
        for (int i = 0; i < 24; ++i) {
          const int col = c0 + 8 * (i >> 2) + 2 * q + (i & 1);
          lg[i] = fmaxf(__fadd_rn(lg[i], p.head_b[col]), 0.0f);
        }
        head_chunk(lg, c0, p.logits, B, p.V, cta, rank, t, best, arg);
      }
      head_finish(best, arg, p.samples, B, cta, rank, t, p.ties, head_best, head_arg);
    }
  }
  cluster_sync();
}

// dynamic shared memory of an f32 K2 block: the ring and the two f32
// carries of its H / C units (and 1 KB of alignment)
inline size_t decode_f32_smem_bytes(int H, int C, int stages) {
  return (size_t)stages * kDecF32StageBytes + 2ull * kRows * (H / C + kDecF32CarryPad) * 4 + 1024;
}

// the launch's checks: C in 1..8 owning whole 32-unit pairs of chunks, a
// ring of 2..kDecF32MaxStages stages that fits
inline bool decode_f32_plan_fits(int H, int C, int stages) {
  if (H % 64 != 0 || H <= 0 || C < 1 || C > kMaxCluster || H % C != 0) return false;
  if ((H / C) % 32 != 0 || stages < 2 || stages > kDecF32MaxStages) return false;
  return decode_f32_smem_bytes(H, C, stages) <= (size_t)kSmemBudget;
}

inline int decode_f32_slots(int H, int C, int stages) {
  if (!decode_f32_plan_fits(H, C, stages)) return -1;
  return max_clusters(decode_f32_kernel<false>, C, decode_f32_smem_bytes(H, C, stages),
                      kDecodeThreads);
}

// A 3D tensor map over the f32 route's packed 6 KB blocks, six a box.
inline cudaError_t make_decode_f32_map(CUtensorMap* map, const void* packed, int blocks) {
  const uint64_t dims[3] = {64, (uint64_t)(3 * kDecF32Units), (uint64_t)blocks};
  const uint64_t strides[2] = {128, (uint64_t)kDecF32Block};
  const uint32_t box[3] = {64, (uint32_t)(3 * kDecF32Units), 6};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, packed, dims, strides, box);
}

// `init` holds the init hiddens' pieces (2, 4, 3, tiles * 64, H) bf16
inline cudaError_t launch_decode_f32(const CUtensorMap& w_map, const DecodeF32Args& a,
                                     const void* init, int C, cudaStream_t stream) {
  if (!decode_f32_plan_fits(a.H, C, a.stages) || a.B < 1 || a.V < 1 ||
      a.scratch == nullptr || init == nullptr)
    return cudaErrorInvalidValue;
  const int tiles = (a.B + kRows - 1) / kRows;
  CUtensorMap a_map, i_map;  // planes of (64 rows, H), three pieces a box
  const uint64_t a_dims[3] = {(uint64_t)a.H, (uint64_t)kRows, (uint64_t)tiles * 12};
  const uint64_t i_dims[3] = {(uint64_t)a.H, (uint64_t)tiles * kRows, 24};
  const uint64_t a_strides[2] = {(uint64_t)a.H * 2, (uint64_t)kRows * a.H * 2};
  const uint64_t i_strides[2] = {(uint64_t)a.H * 2, (uint64_t)tiles * kRows * a.H * 2};
  const uint32_t box[3] = {64, (uint32_t)kRows, 3};
  cudaError_t err = make_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.scratch, a_dims,
                             a_strides, box);
  if (err != cudaSuccess) return err;
  err = make_map(&i_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, init, i_dims, i_strides, box);
  if (err != cudaSuccess) return err;
  const size_t smem = decode_f32_smem_bytes(a.H, C, a.stages);
  const auto kernel = head_chunks(a.V) > 1 ? decode_f32_kernel<true> : decode_f32_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C, 1, 1);
  cfg.blockDim = dim3(kDecodeThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, w_map, a_map, i_map, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace rec90
}  // namespace inpaint

// The f32 route: `map` is inpaint_decode_f32_map's over the packed weight
// pieces (decode_kernel.pack_decode_f32_weights); `init` (2, 4, 3, tiles *
// 64, H) bf16 the pieces of the init hiddens (decode_kernel.
// decode_f32_data), `scratch` (tiles, 2, 2, 3, 64, H) bf16; `cluster` CTAs
// share each 64-row tile and `stages` is the ring's depth
// (decode_kernel.f32_plan). ctx_xw (4, B, 3H), hi0 and hi1 (4, B, H),
// tok_tab (V, 3H), x0_xw (3H,), bias (3, 3H) = b_hh0, b_ih1, b_hh1, head_b
// (96 NHC,) zero past V, logits (B, 24, V), all f32; samples (B, 24) int32;
// `ties` 0 (1: the planted fault of decode_hopper.cuh head_beats). Returns
// the cudaError_t of the launch (0 on success); launches on `stream` and
// does not synchronise.
extern "C" int inpaint_decode_sampling_f32(const void* map, const void* ctx_xw, const void* hi0,
                                           const void* hi1, const void* tok_tab,
                                           const void* x0_xw, const void* bias,
                                           const void* head_b, void* logits, void* samples,
                                           const void* init, void* scratch, int B, int H, int V,
                                           int cluster, int stages, int ties, void* stream) {
  if (map == nullptr) return (int)cudaErrorInvalidValue;
  using T = float;
  CUtensorMap m;
  memcpy(&m, map, sizeof(m));
  const inpaint::rec90::DecodeF32Args a{
      static_cast<const T*>(ctx_xw), static_cast<const T*>(hi0),   static_cast<const T*>(hi1),
      static_cast<const T*>(tok_tab), static_cast<const T*>(x0_xw), static_cast<const T*>(bias),
      static_cast<const T*>(head_b),  static_cast<T*>(logits),      static_cast<int*>(samples),
      static_cast<__nv_bfloat16*>(scratch), B, H, V, stages, ties};
  return (int)inpaint::rec90::launch_decode_f32(m, a, init, cluster,
                                                static_cast<cudaStream_t>(stream));
}

// Encode into `map_out` (128 bytes, 64-byte aligned) the tensor map of
// `blocks` packed 48 x 64 bf16 blocks (decode_kernel.pack_decode_f32_weights).
extern "C" int inpaint_decode_f32_map(const void* packed, int blocks, void* map_out) {
  if (blocks < 6) return (int)cudaErrorInvalidValue;
  return (int)inpaint::rec90::make_decode_f32_map(static_cast<CUtensorMap*>(map_out), packed,
                                                  blocks);
}

// Clusters of `cluster` CTAs of the f32 route at hidden width H with
// `stages` ring stages that the card runs at once; -1 where the plan does
// not fit.
extern "C" int inpaint_decode_f32_slots(int H, int cluster, int stages) {
  return inpaint::rec90::decode_f32_slots(H, cluster, stages);
}

// The bf16 route (decode_hopper.cuh): `map` is inpaint_decode_map's over the
// packed weights (decode_kernel.pack_decode_weights); `cluster`
// CTAs share each 64-row tile and `stages` is the depth of each consumer
// warpgroup's ring (decode_kernel.launch_plan); bias (3, 3H) holds b_hh0,
// b_ih1, b_hh1 and head_b (96 NHC,) the head's bias zero-padded; `ties` 0
// (1: the planted fault of head_beats).
extern "C" int inpaint_decode_sampling_bf16(const void* map, const void* ctx_xw, const void* hi0,
                                            const void* hi1, const void* tok_tab,
                                            const void* x0_xw, const void* bias,
                                            const void* head_b, void* logits, void* samples,
                                            int B, int H, int V, int cluster, int stages,
                                            int ties, void* stream) {
  if (map == nullptr) return (int)cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  CUtensorMap m;
  memcpy(&m, map, sizeof(m));
  const inpaint::rec90::DecodeArgs a{
      static_cast<const T*>(ctx_xw), static_cast<const T*>(hi0),   static_cast<const T*>(hi1),
      static_cast<const T*>(tok_tab), static_cast<const T*>(x0_xw), static_cast<const T*>(bias),
      static_cast<const T*>(head_b),  static_cast<T*>(logits),      static_cast<int*>(samples),
      B, H, V, stages, ties};
  return (int)inpaint::rec90::launch_decode(m, a, cluster, static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` CTAs of the bf16 route's kernel for hidden width H
// and `stages` ring stages that the card runs at once (the launch plan's
// wave size); -1 where the plan does not fit.
extern "C" int inpaint_decode_slots(int H, int cluster, int stages) {
  return inpaint::rec90::decode_slots(H, cluster, stages);
}

// Encode into `map_out` (128 bytes, 64-byte aligned) the tensor map of K2's
// packed bf16 weights (int8 0) or K4's packed int8 ones (int8 1): `blocks`
// 96 x 64 k-slabs, decode_box_halves of a slab a box (decode_hopper.cuh
// make_decode_map).
extern "C" int inpaint_decode_map(const void* packed, int blocks, int H, int int8,
                                  void* map_out) {
  return (int)inpaint::rec90::make_decode_map(static_cast<CUtensorMap*>(map_out), packed, blocks,
                                              H, int8 != 0);
}
