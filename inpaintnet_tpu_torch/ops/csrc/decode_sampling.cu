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
// f32 route (the first port's kernel): one block owns a 16-row tile and
// loops over the 24 ticks with its hiddens in shared memory, scalar FMA
// products (gru_common.cuh); the feedback is a row lookup (only the token
// index is kept between ticks, not a (rows, 3H) slab).
#include "decode_hopper.cuh"
#include "gru_common.cuh"

#include <string.h>

namespace inpaint {

constexpr int kTicks = 24;
constexpr int kTicksPerBeat = 6;

template <typename T>
struct DecodeArgs {
  const T* ctx_xw;     // (4, B, 3H): beat-context part of x @ W_ih0, b_ih0 folded in
  const T* hi0;        // (4, B, H) per-beat layer-0 init hiddens
  const T* hi1;        // (4, B, H) per-beat layer-1 init hiddens
  const T* tok_tab;    // (V, 3H): emb @ W_ih0[:E]
  const T* x0_xw;      // (3H,): x_0 @ W_ih0[:E], the tick-0 input
  const void* whh0;    // (H, 3H)
  const void* wih1;    // (H, 3H)
  const void* whh1;    // (H, 3H)
  const T* bias;       // (3, 3H): b_hh0, b_ih1, b_hh1
  const void* head_w;  // (H, VP), zero columns past V
  const T* head_b;     // (VP,), zero past V
  T* logits;           // (B, 24, V)
  int* samples;        // (B, 24)
  int B, H, V, VP;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_sampling_kernel(const DecodeArgs<T> p) {
  using Tr = Traits<T>;
  constexpr int MT = Tr::MT, TM = 16 * MT;
  const int row0 = blockIdx.x * TM;
  const int H = p.H, H3 = 3 * H, B = p.B, VP = p.VP;
  const int ldh = H + Tr::kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h0c = reinterpret_cast<T*>(smem_raw);
  T* h0n = h0c + TM * ldh;
  T* h1c = h0n + TM * ldh;
  T* h1n = h1c + TM * ldh;
  float* lg = reinterpret_cast<float*>(h1n + TM * ldh);  // (TM, VP) f32 logits
  int* prev = reinterpret_cast<int*>(lg + TM * VP);      // (TM,) fed-back token, -1 = x_0

  for (int r = threadIdx.x; r < TM; r += blockDim.x) prev[r] = -1;
  const int warp = threadIdx.x >> 5;
  const T* b_hh0 = p.bias;
  const T* b_ih1 = p.bias + H3;
  const T* b_hh1 = p.bias + 2 * H3;

  for (int t = 0; t < kTicks; ++t) {
    const int beat = t / kTicksPerBeat;
    if (t % kTicksPerBeat == 0) {
      load_rows(h0c, ldh, p.hi0 + (size_t)beat * B * H, H, row0, TM, B);
      load_rows(h1c, ldh, p.hi1 + (size_t)beat * B * H, H, row0, TM, B);
    }
    __syncthreads();

    // layer 0: xw = fed-back token row + beat context; hw = h0 @ W_hh0 + b_hh0
    for (int c = 0; c < H / kChunk; ++c) {
      const int j0 = c * kChunk + warp * 8;
      const int nt[3] = {j0 / 8, (H + j0) / 8, (2 * H + j0) / 8};
      float ah[3][MT][4];
      zero_acc(ah);
      Gemm<T, MT, 3>::run(ah, h0c, ldh, H, p.whh0, H3, nt);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = acc_row(m, i);
          const int j = j0 + acc_col(i);
          const T* fb = prev[r] < 0 ? p.x0_xw : p.tok_tab + (size_t)prev[r] * H3;
          float xr = Tr::to_f(fb[j]), xz = Tr::to_f(fb[H + j]), xn = Tr::to_f(fb[2 * H + j]);
          if (row0 + r < B) {
            const T* ctx = p.ctx_xw + ((size_t)beat * B + row0 + r) * H3;
            xr += Tr::to_f(ctx[j]);
            xz += Tr::to_f(ctx[H + j]);
            xn += Tr::to_f(ctx[2 * H + j]);
          }
          const float hr = ah[0][m][i] + Tr::to_f(b_hh0[j]);
          const float hz = ah[1][m][i] + Tr::to_f(b_hh0[H + j]);
          const float hn = ah[2][m][i] + Tr::to_f(b_hh0[2 * H + j]);
          const float h = Tr::to_f(h0c[r * ldh + j]);
          h0n[r * ldh + j] = Tr::from_f(gru_gate(xr, hr, xz, hz, xn, hn, h));
        }
      }
    }
    __syncthreads();

    // layer 1: xw = h0' @ W_ih1 + b_ih1; hw = h1 @ W_hh1 + b_hh1
    for (int c = 0; c < H / kChunk; ++c) {
      const int j0 = c * kChunk + warp * 8;
      const int nt[3] = {j0 / 8, (H + j0) / 8, (2 * H + j0) / 8};
      float ax[3][MT][4], ah[3][MT][4];
      zero_acc(ax);
      zero_acc(ah);
      Gemm<T, MT, 3>::run(ax, h0n, ldh, H, p.wih1, H3, nt);
      Gemm<T, MT, 3>::run(ah, h1c, ldh, H, p.whh1, H3, nt);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = acc_row(m, i);
          const int j = j0 + acc_col(i);
          const float xr = ax[0][m][i] + Tr::to_f(b_ih1[j]);
          const float xz = ax[1][m][i] + Tr::to_f(b_ih1[H + j]);
          const float xn = ax[2][m][i] + Tr::to_f(b_ih1[2 * H + j]);
          const float hr = ah[0][m][i] + Tr::to_f(b_hh1[j]);
          const float hz = ah[1][m][i] + Tr::to_f(b_hh1[H + j]);
          const float hn = ah[2][m][i] + Tr::to_f(b_hh1[2 * H + j]);
          const float h = Tr::to_f(h1c[r * ldh + j]);
          h1n[r * ldh + j] = Tr::from_f(gru_gate(xr, hr, xz, hz, xn, hn, h));
        }
      }
    }
    __syncthreads();

    // ReLU head into f32 smem (the reference's non-negative logits)
    for (int ntile = warp; ntile < VP / 8; ntile += kWarps) {
      const int nt[1] = {ntile};
      float acc[1][MT][4];
      zero_acc(acc);
      Gemm<T, MT, 1>::run(acc, h1n, ldh, H, p.head_w, VP, nt);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = ntile * 8 + acc_col(i);
          lg[acc_row(m, i) * VP + col] = fmaxf(acc[0][m][i] + Tr::to_f(p.head_b[col]), 0.0f);
        }
      }
    }
    __syncthreads();

    // first-index argmax over the V real columns, and the outputs
    for (int r = threadIdx.x; r < TM; r += blockDim.x) {
      const float* row = lg + r * VP;
      float best = row[0];
      int arg = 0;
      for (int v = 1; v < p.V; ++v) {
        if (row[v] > best) {
          best = row[v];
          arg = v;
        }
      }
      prev[r] = arg;
      if (row0 + r < B) p.samples[(size_t)(row0 + r) * kTicks + t] = arg;
    }
    for (int idx = threadIdx.x; idx < TM * p.V; idx += blockDim.x) {
      const int r = idx / p.V, v = idx % p.V;
      if (row0 + r < B)
        p.logits[((size_t)(row0 + r) * kTicks + t) * p.V + v] = Tr::from_f(lg[r * VP + v]);
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
static cudaError_t decode_sampling(const DecodeArgs<T>& a, cudaStream_t stream) {
  using Tr = Traits<T>;
  constexpr int TM = 16 * Tr::MT;
  const size_t smem = 4ull * TM * (a.H + Tr::kPad) * sizeof(T) +
                      (size_t)TM * a.VP * sizeof(float) + TM * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(decode_sampling_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  decode_sampling_kernel<T><<<(a.B + TM - 1) / TM, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace inpaint

// The f32 route. Tensors as documented on DecodeArgs. Returns the
// cudaError_t of the launch (0 on success); launches on `stream` and does
// not synchronise.
extern "C" int inpaint_decode_sampling_f32(const void* ctx_xw, const void* hi0, const void* hi1,
                                           const void* tok_tab, const void* x0_xw,
                                           const void* whh0, const void* wih1, const void* whh1,
                                           const void* bias, const void* head_w,
                                           const void* head_b, void* logits, void* samples,
                                           int B, int H, int V, int VP, void* stream) {
  using T = float;
  inpaint::DecodeArgs<T> a{static_cast<const T*>(ctx_xw), static_cast<const T*>(hi0),
                           static_cast<const T*>(hi1),    static_cast<const T*>(tok_tab),
                           static_cast<const T*>(x0_xw),  whh0, wih1, whh1,
                           static_cast<const T*>(bias),   head_w,
                           static_cast<const T*>(head_b), static_cast<T*>(logits),
                           static_cast<int*>(samples),    B, H, V, VP};
  return (int)inpaint::decode_sampling<T>(a, static_cast<cudaStream_t>(stream));
}

// The bf16 route (decode_hopper.cuh): `map` is inpaint_slab_map's over the
// packed weights (decode_kernel.pack_decode_weights); `cluster`
// CTAs share each 64-row tile and `stages` is the depth of each consumer
// warpgroup's ring (decode_kernel.launch_plan); bias (3, 3H) holds b_hh0,
// b_ih1, b_hh1 and head_b (96,) the head's bias zero-padded; V at most 96.
extern "C" int inpaint_decode_sampling_bf16(const void* map, const void* ctx_xw, const void* hi0,
                                            const void* hi1, const void* tok_tab,
                                            const void* x0_xw, const void* bias,
                                            const void* head_b, void* logits, void* samples,
                                            int B, int H, int V, int cluster, int stages,
                                            void* stream) {
  if (map == nullptr) return (int)cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  CUtensorMap m;
  memcpy(&m, map, sizeof(m));
  const inpaint::rec90::DecodeArgs a{
      static_cast<const T*>(ctx_xw), static_cast<const T*>(hi0),   static_cast<const T*>(hi1),
      static_cast<const T*>(tok_tab), static_cast<const T*>(x0_xw), static_cast<const T*>(bias),
      static_cast<const T*>(head_b),  static_cast<T*>(logits),      static_cast<int*>(samples),
      B, H, V, stages};
  return (int)inpaint::rec90::launch_decode(m, a, cluster, static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` CTAs of the bf16 route's kernel for hidden width H
// and `stages` ring stages that the card runs at once (the launch plan's
// wave size); -1 where the plan does not fit.
extern "C" int inpaint_decode_slots(int H, int cluster, int stages) {
  return inpaint::rec90::decode_slots(H, cluster, stages);
}
