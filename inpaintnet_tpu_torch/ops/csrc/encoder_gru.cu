// K1: final hidden states h_n (4, B, H) of the MeasureVAE encoder's 2-layer
// bidirectional GRU, straight from int32 tokens.
//
// Replaces the TPU kernel inpaintnet_tpu/ops/encoder_pallas.py
// encoder_hn_pallas (_l0_kernel, _l1_kernel). Same function, same numerics:
// products accumulate in f32, biases and gates in f32, the carry and the
// layer-0 outputs are rounded to the parameter dtype after every step.
//
// What bounds it on an H100: every step multiplies a tile of rows by the
// whole (H, 3H) W_hh (layer 1 also by the (2H, 3H) W_ih). At H = 512 in bf16
// that is 1.5 MB + 3 MB of weights per step, far over a block's 227 KB of
// shared memory, so the weights stream from the 50 MB L2 (all of them fit
// there) on every step, and the weight bytes read per row fall as the row
// tile grows.
//
// Design: rows are independent, so one block owns a tile of rows of ONE
// direction and loops over all 24 ticks itself (the TPU's sequential grid
// axis becomes that loop; no grid-wide sync). The hidden tile stays in
// shared memory, double-buffered old/new. The gates run in 64-unit chunks
// that hold r, z and n of the same hidden units (gru_common.cuh), with
// mma.sync bf16 products (f32: scalar FMAs). Layer 0 reads its input
// projection as a row of the fused (V, 3H) table emb @ W_ih (computed
// outside, like the TPU kernel's table); layer 1 computes [ys_f | ys_b] @ W_ih
// in its body, as the TPU kernel does, and writes h_n only.
#include "gru_common.cuh"

namespace inpaint {

template <typename T>
struct EncLayerArgs {
  const int* tokens;     // (B, steps), layer 0 only
  const T* tab[2];       // (V, 3H) fused emb @ W_ih per direction, layer 0
  const void* wih[2];    // (2H, 3H) per direction, layer 1 (packed for bf16)
  const void* whh[2];    // (H, 3H) per direction (packed for bf16)
  const T* bih;          // (2, 3H): [fwd, bwd]
  const T* bhh;          // (2, 3H)
  T* ys[2];              // (steps, B, H) layer-0 outputs per direction
  T* hn;                 // (2, B, H): this layer's final hiddens [fwd, bwd]
  int B, steps, H, V;  // steps: sequence length
};

template <typename T, bool kLayer0>
__global__ void __launch_bounds__(kThreads)
encoder_layer_kernel(const EncLayerArgs<T> p) {
  using Tr = Traits<T>;
  constexpr int MT = Tr::MT, TM = 16 * MT;
  const int d = blockIdx.y;  // 0 forward, 1 backward
  const int row0 = blockIdx.x * TM;
  const int H = p.H, H3 = 3 * H, B = p.B;
  const int ldh = H + Tr::kPad, ldx = 2 * H + Tr::kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h_cur = reinterpret_cast<T*>(smem_raw);
  T* h_nxt = h_cur + TM * ldh;
  T* xs = h_nxt + TM * ldh;  // layer 1: (TM, 2H) input tile
  int* toks = reinterpret_cast<int*>(xs);  // layer 0: (TM,) tokens

  for (int i = threadIdx.x; i < TM * ldh; i += blockDim.x) h_cur[i] = Tr::from_f(0.0f);

  const int warp = threadIdx.x >> 5;
  const T* bih = p.bih + d * H3;
  const T* bhh = p.bhh + d * H3;

  for (int s = 0; s < p.steps; ++s) {
    const int t = d ? p.steps - 1 - s : s;
    if constexpr (kLayer0) {
      for (int r = threadIdx.x; r < TM; r += blockDim.x) {
        int tok = row0 + r < B ? p.tokens[(size_t)(row0 + r) * p.steps + t] : 0;
        toks[r] = min(max(tok, 0), p.V - 1);  // never read outside the table
      }
    } else {
      load_rows(xs, ldx, p.ys[0] + (size_t)t * B * H, H, row0, TM, B);
      load_rows(xs + H, ldx, p.ys[1] + (size_t)t * B * H, H, row0, TM, B);
    }
    __syncthreads();

    for (int c = 0; c < H / kChunk; ++c) {
      const int j0 = c * kChunk + warp * 8;
      const int nt[3] = {j0 / 8, (H + j0) / 8, (2 * H + j0) / 8};
      float ah[3][MT][4];
      zero_acc(ah);
      Gemm<T, MT, 3>::run(ah, h_cur, ldh, H, p.whh[d], H3, nt);
      float ax[3][MT][4];
      zero_acc(ax);
      if constexpr (!kLayer0) Gemm<T, MT, 3>::run(ax, xs, ldx, 2 * H, p.wih[d], H3, nt);

#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = acc_row(m, i);
          const int j = j0 + acc_col(i);
          float xr, xz, xn;
          if constexpr (kLayer0) {
            const T* row = p.tab[d] + (size_t)toks[r] * H3;
            xr = Tr::to_f(row[j]);
            xz = Tr::to_f(row[H + j]);
            xn = Tr::to_f(row[2 * H + j]);
          } else {
            xr = ax[0][m][i];
            xz = ax[1][m][i];
            xn = ax[2][m][i];
          }
          xr += Tr::to_f(bih[j]);
          xz += Tr::to_f(bih[H + j]);
          xn += Tr::to_f(bih[2 * H + j]);
          const float hr = ah[0][m][i] + Tr::to_f(bhh[j]);
          const float hz = ah[1][m][i] + Tr::to_f(bhh[H + j]);
          const float hn = ah[2][m][i] + Tr::to_f(bhh[2 * H + j]);
          const float h = Tr::to_f(h_cur[r * ldh + j]);
          const T h_store = Tr::from_f(gru_gate(xr, hr, xz, hz, xn, hn, h));
          h_nxt[r * ldh + j] = h_store;
          if constexpr (kLayer0) {
            if (row0 + r < B) p.ys[d][((size_t)t * B + row0 + r) * H + j] = h_store;
          }
        }
      }
    }
    __syncthreads();
    T* tmp = h_cur;
    h_cur = h_nxt;
    h_nxt = tmp;
  }

  for (int idx = threadIdx.x; idx < TM * H; idx += blockDim.x) {
    const int r = idx / H, j = idx % H;
    if (row0 + r < B) p.hn[((size_t)d * B + row0 + r) * H + j] = h_cur[r * ldh + j];
  }
}

template <typename T, bool kLayer0>
static cudaError_t launch_layer(const EncLayerArgs<T>& a, cudaStream_t stream) {
  using Tr = Traits<T>;
  constexpr int TM = 16 * Tr::MT;
  const size_t h_bytes = 2ull * TM * (a.H + Tr::kPad) * sizeof(T);
  const size_t smem = kLayer0 ? h_bytes + TM * sizeof(int)
                              : h_bytes + (size_t)TM * (2 * a.H + Tr::kPad) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(encoder_layer_kernel<T, kLayer0>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + TM - 1) / TM, 2);
  encoder_layer_kernel<T, kLayer0><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t encoder_hn(const int* tokens, const void* tab_f, const void* tab_b,
                              const void* whh0_f, const void* whh0_b, const void* wih1_f,
                              const void* wih1_b, const void* whh1_f, const void* whh1_b,
                              const void* bih0, const void* bhh0, const void* bih1,
                              const void* bhh1, void* ys, void* hn, int B, int steps,
                              int H, int V, cudaStream_t stream) {
  T* ys_t = static_cast<T*>(ys);
  T* hn_t = static_cast<T*>(hn);
  EncLayerArgs<T> l0{};
  l0.tokens = tokens;
  l0.tab[0] = static_cast<const T*>(tab_f);
  l0.tab[1] = static_cast<const T*>(tab_b);
  l0.whh[0] = whh0_f;
  l0.whh[1] = whh0_b;
  l0.bih = static_cast<const T*>(bih0);
  l0.bhh = static_cast<const T*>(bhh0);
  l0.ys[0] = ys_t;
  l0.ys[1] = ys_t + (size_t)steps * B * H;
  l0.hn = hn_t;
  l0.B = B;
  l0.steps = steps;
  l0.H = H;
  l0.V = V;
  cudaError_t err = launch_layer<T, true>(l0, stream);
  if (err != cudaSuccess) return err;

  EncLayerArgs<T> l1 = l0;
  l1.tokens = nullptr;
  l1.tab[0] = l1.tab[1] = nullptr;
  l1.wih[0] = wih1_f;
  l1.wih[1] = wih1_b;
  l1.whh[0] = whh1_f;
  l1.whh[1] = whh1_b;
  l1.bih = static_cast<const T*>(bih1);
  l1.bhh = static_cast<const T*>(bhh1);
  l1.hn = hn_t + 2ull * B * H;
  return launch_layer<T, false>(l1, stream);
}

}  // namespace inpaint

// dtype: 0 = float32, 1 = bfloat16. Tensors as documented on EncLayerArgs;
// ys is a (2, steps, B, H) scratch, hn the (4, B, H) output [l0f, l0b, l1f, l1b].
// Returns the cudaError_t of the launches (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int inpaint_encoder_hn(int dtype, const void* tokens, const void* tab_f,
                                  const void* tab_b, const void* whh0_f, const void* whh0_b,
                                  const void* wih1_f, const void* wih1_b,
                                  const void* whh1_f, const void* whh1_b, const void* bih0,
                                  const void* bhh0, const void* bih1, const void* bhh1,
                                  void* ys, void* hn, int B, int steps, int H,
                                  int V, void* stream) {
  const int* tok = static_cast<const int*>(tokens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return inpaint::encoder_hn<float>(tok, tab_f, tab_b, whh0_f, whh0_b, wih1_f, wih1_b,
                                      whh1_f, whh1_b, bih0, bhh0, bih1, bhh1, ys, hn, B, steps,
                                      H, V, s);
  if (dtype == 1)
    return inpaint::encoder_hn<__nv_bfloat16>(tok, tab_f, tab_b, whh0_f, whh0_b, wih1_f,
                                              wih1_b, whh1_f, whh1_b, bih0, bhh0, bih1,
                                              bhh1, ys, hn, B, steps, H, V, s);
  return (int)cudaErrorInvalidValue;
}
