// K1: final hidden states h_n (4, B, H) of the MeasureVAE encoder's 2-layer
// bidirectional GRU, straight from int32 tokens.
//
// Replaces the TPU kernel inpaintnet_tpu/ops/encoder_pallas.py
// encoder_hn_pallas (_l0_kernel, _l1_kernel). Same function, same numerics:
// products accumulate in f32, biases and gates in f32, the carry and the
// layer-0 outputs are rounded to the parameter dtype after every step.
//
// What bounds it on an H100: every step multiplies a tile of rows by the
// whole (H, 3H) W_hh, and layer 1 also by the (2H, 3H) W_ih. At H = 512 in
// bf16 that is 1.5 MB + 3 MB of weights a step, far over a block's 227 KB of
// shared memory, so the weights stream from the 50 MB L2 on every step: the
// L2 bytes read per row fall as the row tile grows, and the serving shape
// (65,536 rows) is bound by L2 traffic and by how well the loads overlap
// the products, not by the tensor cores.
//
// bf16 route (the serving default), the Hopper design of encoder_hopper.cuh:
// - layer 1's input projection [ys_f | ys_b] @ W_ih has no recurrence, so
//   it leaves the step loop: one TMA + wgmma GEMM (f32 sums, b_ih added in
//   f32) over every step of a chunk of rows at once, at full tensor-core
//   tiles, into an f32 scratch that the wrapper caps by chunking the rows;
// - each layer's recurrence keeps a 64-row h tile in shared memory and
//   streams only W_hh, through a TMA ring of k-slabs (the r, z, n columns
//   of 64 units each) into wgmma, instead of chains of dependent fragment
//   loads: 3 MB less L2 traffic per layer-1 step and tile, twice the rows
//   per weight byte of the 32-row mma.sync kernel it replaces.
// The wrapper launches, per chunk: layer 0, the GEMM, layer 1.
//
// f32 route (no serving default runs it; tensor cores have no exact f32
// product): the first port's kernel below, kept as it was. Rows are
// independent, so one block owns a 16-row tile of ONE direction and loops
// over all 24 steps itself; the hidden tile stays in shared memory,
// double-buffered; the gates run in 64-unit chunks holding r, z and n of
// the same units (gru_common.cuh) with scalar FMA products; layer 1
// computes [ys_f | ys_b] @ W_ih in its body, as the TPU kernel does.
#include "encoder_hopper.cuh"
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

// f32: tensors as documented on EncLayerArgs; tab_* the (V, 3H) fused
// tables, weights (in, 3H) as they are; ys a (2, steps, B, H) scratch, hn
// the (4, B, H) output [l0f, l0b, l1f, l1b]. Returns the cudaError_t of the
// launches (0 on success); launches on `stream` and does not synchronise.
extern "C" int inpaint_encoder_hn_f32(const void* tokens, const void* tab_f, const void* tab_b,
                                      const void* whh0_f, const void* whh0_b,
                                      const void* wih1_f, const void* wih1_b,
                                      const void* whh1_f, const void* whh1_b, const void* bih0,
                                      const void* bhh0, const void* bih1, const void* bhh1,
                                      void* ys, void* hn, int B, int steps, int H, int V,
                                      void* stream) {
  return inpaint::encoder_hn<float>(static_cast<const int*>(tokens), tab_f, tab_b, whh0_f,
                                    whh0_b, wih1_f, wih1_b, whh1_f, whh1_b, bih0, bhh0, bih1,
                                    bhh1, ys, hn, B, steps, H, V,
                                    static_cast<cudaStream_t>(stream));
}

// bf16, one layer's recurrence over the rows [row0, row0 + rows) of B:
// whh (2, 3H, H) bf16, W_hh^T per direction with each 32-unit chunk's rows
// grouped [r, z, n] (ops/encoder_kernel.pack_gate_slabs); layer 0 reads
// tokens (B, steps) int32 and tab (2, V, 3H) f32 (the fused bf16 table
// plus b_ih) and writes ys (steps, rows, 2H) bf16; layer 1 reads xw (2,
// steps * rows, 3H) f32 (b_ih included); bhh (2, 3H) f32 (bih unused);
// hn the layer's (2, B, H) bf16 h_n.
extern "C" int inpaint_encoder_rec_bf16(int layer, const void* whh, const void* tokens,
                                        const void* tab, const void* xw, const void* bih,
                                        const void* bhh, void* ys, void* hn, int B, int row0,
                                        int rows, int steps, int H, int V, void* stream) {
  using namespace inpaint::enc90;
  RecArgs a{static_cast<const int*>(tokens), static_cast<const float*>(tab), xw, nullptr, nullptr,
            static_cast<const float*>(bih), static_cast<const float*>(bhh), ys, hn,
            B, row0, rows, steps, H, V, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layer == 0) return (int)launch_rec<__nv_bfloat16, __nv_bfloat16, true>(whh, a, s);
  if (layer == 1) return (int)launch_rec<__nv_bfloat16, __nv_bfloat16, false>(whh, a, s);
  return (int)cudaErrorInvalidValue;
}

// bf16 layer-1 input projection: out (2, M, 3H) f32 = a (M, 2H) bf16 @
// w[d]^T + bias[d] for w (2, 3H, 2H) bf16 (W_ih^T per direction) and bias
// (2, 3H) f32.
extern "C" int inpaint_encoder_gemm_bf16(const void* a, const void* w, const void* bias,
                                         void* out, int M, int H, void* stream) {
  return (int)inpaint::enc90::launch_xw_gemm<__nv_bfloat16>(
      a, w, static_cast<const float*>(bias), out, M, H, static_cast<cudaStream_t>(stream));
}
