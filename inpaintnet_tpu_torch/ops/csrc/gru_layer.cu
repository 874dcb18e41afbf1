// K8: one direction of a GRU layer over a precomputed input projection
// xw = x @ W_ih + b_ih, with an optional hold mask: the generic layer that
// serves every GRU without a kernel of its own (the LatentRNN's context and
// generation GRUs, the decoder's beat GRU) under the "pallas" GRU route.
//
// Replaces the TPU kernel inpaintnet_tpu/ops/gru_pallas.py
// gru_layer_pallas_stream (_gru_stream_kernel), and with it
// gru_layer_pallas (K9) and gru_layer_pallas_dma (K10), which compute the
// same function. Same numerics as K8: the carry h is held in the parameter
// dtype and rounded to it after every step (unlike K5, whose carry is f32);
// hw = h @ W_hh takes h in the parameter dtype and accumulates in f32 (bf16:
// wgmma; f32: scalar FMAs, no TF32); b_hh, xw and the gates run in f32,
// every multiply and add rounded on its own (gru_common.cuh gru_gate); a
// step whose mask is 0 keeps h and emits the held h, so an all-zero row
// returns h0; reverse runs t = steps-1 .. 0 and the outputs stay in time
// order.
//
// What bounds it on an H100: each step multiplies every row by the whole
// (H, 3H) W_hh. At the context GRUs' shape (2,048 rows, 16 steps, H 512)
// that is 51.5 GFLOP, at the generation GRU's (2,048 rows, 6 steps, H 1024)
// 77.3 GFLOP: 0.05-0.08 ms on bf16 tensor cores, 0.8-1.2 ms at the f32
// peak; the bytes (xw once, ys once) take less in bf16. W_hh is 1.5 MB
// (H 512) or 6 MB (H 1024) in bf16, far over a block's 227 KB of shared
// memory, so every block streams all of it from the 50 MB L2 on every step,
// and the L2 bytes per row fall as the row tile grows.
//
// bf16 route (every serving default), the Hopper design of
// gru_layer_hopper.cuh: a cluster of CTAs splits the units of a 64-row
// tile, each streaming its own W_hh^T gate slabs through TMA rings into
// wgmma and pushing its share of the new h into its peers' shared memory
// every step (the source's note says why).
//
// f32 route (no serving default runs it; tensor cores have no exact f32
// product), the first port's kernel: rows are independent, so one block owns 16 rows
// and loops over all steps itself. Each thread owns whole units j
// (j = thread + 256 c, up to four at H 1024) for all 16 rows and keeps their
// carry in registers; the carry of all units sits k-major in shared memory,
// (H, 20), double-buffered, as the product's operand (160 KB at H 1024). A
// mask-held row computes its products but not its gates.
#include "gru_common.cuh"
#include "gru_layer_hopper.cuh"

#include <string.h>

namespace inpaint {

template <typename T>
struct LayerArgs {
  const T* xw;            // (B, steps, 3H)
  const void* whh;        // (H, 3H)
  const T* bhh;           // (3H,)
  const T* h0;            // (B, H)
  const uint8_t* keep;    // (B, steps): 0 holds h at that step; null: every step runs
  T* ys;                  // (B, steps, H) outputs, or null (h_n only)
  T* hn;                  // (B, H)
  int B, steps, H, reverse;
};

constexpr int kLayerMaxHidden = 1024;
constexpr int kF32Rows = 16;
constexpr int kLdT = kF32Rows + 4;  // k-major f32 carry: 16 rows + 4 floats (16-byte rows)

__device__ __forceinline__ bool runs_step(const uint8_t* keep, int row, int steps, int t) {
  return keep == nullptr || keep[(size_t)row * steps + t] != 0;
}

// f32: one thread per unit, all 16 rows, the carry in registers (see the
// design note). NCOL: units per thread, ceil(H / kThreads).
template <int NCOL>
__global__ void __launch_bounds__(kThreads) gru_layer_f32_kernel(const LayerArgs<float> p) {
  const int row0 = blockIdx.x * kF32Rows;
  const int H = p.H, H3 = 3 * H, B = p.B;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cur = reinterpret_cast<float*>(smem_raw);  // (H, kLdT): the carry, k-major
  float* nxt = cur + H * kLdT;

  float h[NCOL][kF32Rows];
#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const int j = threadIdx.x + c * kThreads;
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      h[c][r] = j < H && row0 + r < B ? p.h0[(size_t)(row0 + r) * H + j] : 0.0f;
      if (j < H) cur[j * kLdT + r] = h[c][r];
    }
  }
  __syncthreads();

  const float* W = static_cast<const float*>(p.whh);
  for (int s = 0; s < p.steps; ++s) {
    const int t = p.reverse ? p.steps - 1 - s : s;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int j = threadIdx.x + c * kThreads;
      if (j >= H) continue;
      float acc[3][kF32Rows];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) acc[g][r] = 0.0f;
      const float* w = W + j;
#pragma unroll 2
      for (int k = 0; k < H; ++k) {
        const float wr = __ldg(w + (size_t)k * H3);
        const float wz = __ldg(w + (size_t)k * H3 + H);
        const float wn = __ldg(w + (size_t)k * H3 + 2 * H);
        const float4* a = reinterpret_cast<const float4*>(cur + k * kLdT);
#pragma unroll
        for (int q = 0; q < kF32Rows / 4; ++q) {
          const float4 v = a[q];
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[0][4 * q + e] = fmaf(vs[e], wr, acc[0][4 * q + e]);
            acc[1][4 * q + e] = fmaf(vs[e], wz, acc[1][4 * q + e]);
            acc[2][4 * q + e] = fmaf(vs[e], wn, acc[2][4 * q + e]);
          }
        }
      }
      const float br = p.bhh[j], bz = p.bhh[H + j], bn = p.bhh[2 * H + j];
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        const int row = row0 + r;
        if (row < B && runs_step(p.keep, row, p.steps, t)) {
          const float* x = p.xw + ((size_t)row * p.steps + t) * H3;
          h[c][r] = gru_gate(x[j], __fadd_rn(acc[0][r], br), x[H + j], __fadd_rn(acc[1][r], bz),
                             x[2 * H + j], __fadd_rn(acc[2][r], bn), h[c][r]);
        }
        nxt[j * kLdT + r] = h[c][r];
        if (row < B && p.ys != nullptr) p.ys[((size_t)row * p.steps + t) * H + j] = h[c][r];
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const int j = threadIdx.x + c * kThreads;
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r)
      if (j < H && row0 + r < B) p.hn[(size_t)(row0 + r) * H + j] = h[c][r];
  }
}

template <int NCOL>
static cudaError_t launch_f32(const LayerArgs<float>& a, cudaStream_t stream) {
  const size_t smem = 2ull * a.H * kLdT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gru_layer_f32_kernel<NCOL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gru_layer_f32_kernel<NCOL><<<(a.B + kF32Rows - 1) / kF32Rows, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

static cudaError_t launch(const LayerArgs<float>& a, cudaStream_t stream) {
  switch ((a.H + kThreads - 1) / kThreads) {
    case 1: return launch_f32<1>(a, stream);
    case 2: return launch_f32<2>(a, stream);
    case 3: return launch_f32<3>(a, stream);
    default: return launch_f32<4>(a, stream);
  }
}

}  // namespace inpaint

// The f32 route. Tensors as documented on LayerArgs (keep and ys may be
// null); H a multiple of 64 up to 1024, B and steps at least 1; reverse != 0
// runs t = steps-1 .. 0. Returns the cudaError_t of the launch (0 on
// success); launches on `stream` and does not synchronise.
extern "C" int inpaint_gru_layer_f32(const void* xw, const void* whh, const void* bhh,
                                     const void* h0, const void* keep, void* ys, void* hn,
                                     int B, int steps, int H, int reverse, void* stream) {
  if (H % inpaint::kChunk != 0 || H > inpaint::kLayerMaxHidden || B < 1 || steps < 1)
    return (int)cudaErrorInvalidValue;
  inpaint::LayerArgs<float> a{static_cast<const float*>(xw), whh,
                              static_cast<const float*>(bhh), static_cast<const float*>(h0),
                              static_cast<const uint8_t*>(keep), static_cast<float*>(ys),
                              static_cast<float*>(hn), B, steps, H, reverse};
  return (int)inpaint::launch(a, static_cast<cudaStream_t>(stream));
}

// Encode into `map_out` (128 bytes, 64-byte aligned) the tensor map of
// `blocks` packed 96 x 64 bf16 k-slabs of a hidden width H
// (gru_kernel.pack_gate_blocks; decode_kernel.pack_decode_weights) that the
// bf16 routes of K8 and K2 stream.
extern "C" int inpaint_slab_map(const void* packed, int blocks, int H, void* map_out) {
  if (H % 64 != 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  return (int)inpaint::rec90::make_slab_map(static_cast<CUtensorMap*>(map_out), packed, blocks,
                                            H);
}

// The bf16 route (gru_layer_hopper.cuh): `map` is inpaint_slab_map's over
// pack_gate_blocks(w_hh); `cluster` CTAs share each 64-row tile
// and `stages` is the depth of each consumer warpgroup's ring
// (gru_kernel.launch_plan). Other tensors as the f32 route's, in bf16.
extern "C" int inpaint_gru_layer_bf16(const void* map, const void* xw, const void* bhh,
                                      const void* h0, const void* keep, void* ys, void* hn,
                                      int B, int steps, int H, int reverse, int cluster,
                                      int stages, void* stream) {
  if (map == nullptr || H > inpaint::kLayerMaxHidden) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memcpy(&m, map, sizeof(m));
  const inpaint::rec90::LayerArgs a{static_cast<const __nv_bfloat16*>(xw),
                                    static_cast<const __nv_bfloat16*>(bhh),
                                    static_cast<const __nv_bfloat16*>(h0),
                                    static_cast<const uint8_t*>(keep),
                                    static_cast<__nv_bfloat16*>(ys),
                                    static_cast<__nv_bfloat16*>(hn),
                                    B, steps, H, reverse, stages};
  return (int)inpaint::rec90::launch_gru_layer(m, a, cluster, static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` CTAs of the bf16 route's kernel for hidden width H
// and `stages` ring stages that the card runs at once (the launch plan's
// wave size); -1 where the plan does not fit.
extern "C" int inpaint_gru_layer_slots(int H, int cluster, int stages) {
  return inpaint::rec90::gru_layer_slots(H, cluster, stages);
}
