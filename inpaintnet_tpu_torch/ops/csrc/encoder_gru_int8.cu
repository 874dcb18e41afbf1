// K3: the int8 twin of K1 (encoder_gru.cu): final hidden states h_n (4, B, H)
// of the MeasureVAE encoder's 2-layer bidirectional GRU from int32 tokens,
// with int8 x int8 -> int32 products.
//
// Replaces the TPU kernel inpaintnet_tpu/ops/encoder_pallas.py
// encoder_hn_pallas_int8 (_l0_kernel_int8, _l1_kernel_int8). Same numerics
// (ops/encoder_kernel.py encoder_hn_int8_reference): weights quantized per
// output column by the host; the carry stored as round(h * 127) in int8
// (tanh-bounded, |h| < 1) with its dequant 1/127 folded into the scales;
// every product dequantized as acc * scale + bias in f32; gates in f32;
// the layer-0 -> layer-1 slab ys in int8. h_n is the last step's
// UNQUANTIZED f32 state rounded to the output dtype, not the int8 carry.
// Layer 0's input projection is a row of the quantized (V, 3H) table
// emb @ W_ih: the TPU kernel's one-hot int8 product is that row lookup.
//
// What bounds it on an H100: as K1, every step multiplies a row tile by
// the whole (H, 3H) W_hh (layer 1 also by the (2H, 3H) W_ih), streamed from
// L2: at H = 512 that is 0.75 MB + 1.5 MB of int8 per step, half of K1's
// bf16 bytes, through the int8 tensor cores (mma.sync m16n8k32, twice the
// bf16 rate).
//
// Design: K1's. One block owns a 32-row tile of ONE direction and loops
// over all the steps; the int8 hidden tile stays in shared memory, double
// buffered; 8 warps each take r, z and n of 8 hidden units per 64-unit
// chunk, so the gates run in registers. Every multiply and add of the
// dequantization and the gates is rounded on its own (gru_common.cuh), in
// the plain version's order, so the kernel and its plain version differ
// only where the f32 exp/tanh of the two differ.
#include "gru_common.cuh"

namespace inpaint {

constexpr int kMTs8 = 2;  // 32-row tiles
constexpr int kTMs8 = 16 * kMTs8;
constexpr float kHdq = 1.0f / 127.0f;  // dequant of the int8 carry

template <typename OutT>
struct EncI8Args {
  const int* tokens;     // (B, steps), layer 0 only
  const int8_t* tab;     // (2, V, 3H) quantized emb @ W_ih per direction, layer 0
  const int8_t* wih;     // (2, 2H, 3H) per direction, packed, layer 1
  const int8_t* whh;     // (2, H, 3H) per direction, packed
  const float* s_x;      // (2, 3H) scales of the input product (table or W_ih)
  const float* s_h;      // (2, 3H) scales of the recurrent product
  const float* bih;      // (2, 3H) f32
  const float* bhh;      // (2, 3H) f32
  int8_t* ys;            // (2, steps, B, H) layer-0 outputs [fwd, bwd]
  OutT* hn;              // (2, B, H): this layer's final hiddens [fwd, bwd]
  int B, steps, H, V;
};

template <typename OutT, bool kLayer0>
__global__ void __launch_bounds__(kThreads) encoder_int8_kernel(const EncI8Args<OutT> p) {
  using Tr = Traits<OutT>;
  constexpr int MT = kMTs8, TM = kTMs8;
  const int d = blockIdx.y;  // 0 forward, 1 backward
  const int row0 = blockIdx.x * TM;
  const int H = p.H, H3 = 3 * H, B = p.B, steps = p.steps;
  const int ldh = H + kPadS8, ldx = 2 * H + kPadS8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* h_cur = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* h_nxt = h_cur + TM * ldh;
  int8_t* xs = h_nxt + TM * ldh;  // layer 1: (TM, 2H) input tile [ys_f | ys_b]
  int* toks = reinterpret_cast<int*>(xs);  // layer 0: (TM,) tokens

  for (int i = threadIdx.x; i < TM * ldh; i += blockDim.x) h_cur[i] = 0;

  const int warp = threadIdx.x >> 5;
  const int8_t* whh = p.whh + (size_t)d * H * H3;
  const int8_t* wih = kLayer0 ? nullptr : p.wih + (size_t)d * 2 * H * H3;
  const int8_t* tab = kLayer0 ? p.tab + (size_t)d * p.V * H3 : nullptr;
  const float* s_x = p.s_x + d * H3;
  const float* s_h = p.s_h + d * H3;
  const float* bih = p.bih + d * H3;
  const float* bhh = p.bhh + d * H3;
  const size_t slab = (size_t)steps * B * H;

  for (int s = 0; s < steps; ++s) {
    const int t = d ? steps - 1 - s : s;
    const bool last = s == steps - 1;
    if constexpr (kLayer0) {
      for (int r = threadIdx.x; r < TM; r += blockDim.x) {
        int tok = row0 + r < B ? p.tokens[(size_t)(row0 + r) * steps + t] : 0;
        toks[r] = min(max(tok, 0), p.V - 1);  // never read outside the table
      }
    } else {
      load_rows(xs, ldx, p.ys + (size_t)t * B * H, H, row0, TM, B);
      load_rows(xs + H, ldx, p.ys + slab + (size_t)t * B * H, H, row0, TM, B);
    }
    __syncthreads();

    for (int c = 0; c < H / kChunk; ++c) {
      const int j0 = c * kChunk + warp * 8;
      const int nt[3] = {j0 / 8, (H + j0) / 8, (2 * H + j0) / 8};
      int ah[3][MT][4];
      zero_acc(ah);
      gemm_s8<MT, 3>(ah, h_cur, ldh, H, whh, nt);
      int ax[3][MT][4];
      zero_acc(ax);
      if constexpr (!kLayer0) gemm_s8<MT, 3>(ax, xs, ldx, 2 * H, wih, nt);

#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = acc_row(m, i);
          const int j = j0 + acc_col(i);
          int x0, x1, x2;
          if constexpr (kLayer0) {
            const int8_t* row = tab + (size_t)toks[r] * H3;
            x0 = row[j];
            x1 = row[H + j];
            x2 = row[2 * H + j];
          } else {
            x0 = ax[0][m][i];
            x1 = ax[1][m][i];
            x2 = ax[2][m][i];
          }
          const float xr = dequant(x0, s_x[j], bih[j]);
          const float xz = dequant(x1, s_x[H + j], bih[H + j]);
          const float xn = dequant(x2, s_x[2 * H + j], bih[2 * H + j]);
          const float hr = dequant(ah[0][m][i], s_h[j], bhh[j]);
          const float hz = dequant(ah[1][m][i], s_h[H + j], bhh[H + j]);
          const float hn = dequant(ah[2][m][i], s_h[2 * H + j], bhh[2 * H + j]);
          const float h = __fmul_rn((float)h_cur[r * ldh + j], kHdq);
          const float h_new = gru_gate(xr, hr, xz, hz, xn, hn, h);
          const int8_t q = quant_h(h_new, 127.0f);
          h_nxt[r * ldh + j] = q;
          if (row0 + r < B) {
            if constexpr (kLayer0) p.ys[(size_t)d * slab + ((size_t)t * B + row0 + r) * H + j] = q;
            if (last) p.hn[((size_t)d * B + row0 + r) * H + j] = Tr::from_f(h_new);
          }
        }
      }
    }
    __syncthreads();
    int8_t* tmp = h_cur;
    h_cur = h_nxt;
    h_nxt = tmp;
  }
}

template <typename OutT, bool kLayer0>
static cudaError_t launch_int8_layer(const EncI8Args<OutT>& a, cudaStream_t stream) {
  const size_t h_bytes = 2ull * kTMs8 * (a.H + kPadS8);
  const size_t smem = kLayer0 ? h_bytes + kTMs8 * sizeof(int)
                              : h_bytes + (size_t)kTMs8 * (2 * a.H + kPadS8);
  cudaError_t err = cudaFuncSetAttribute(encoder_int8_kernel<OutT, kLayer0>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + kTMs8 - 1) / kTMs8, 2);
  encoder_int8_kernel<OutT, kLayer0><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename OutT>
static cudaError_t encoder_hn_int8(const EncI8Args<OutT>& base, const int8_t* wih1,
                                   const int8_t* whh1, const float* s_x1, const float* s_h1,
                                   const float* bih1, const float* bhh1, cudaStream_t stream) {
  cudaError_t err = launch_int8_layer<OutT, true>(base, stream);
  if (err != cudaSuccess) return err;
  EncI8Args<OutT> l1 = base;
  l1.tokens = nullptr;
  l1.tab = nullptr;
  l1.wih = wih1;
  l1.whh = whh1;
  l1.s_x = s_x1;
  l1.s_h = s_h1;
  l1.bih = bih1;
  l1.bhh = bhh1;
  l1.hn = base.hn + 2ull * base.B * base.H;
  return launch_int8_layer<OutT, false>(l1, stream);
}

}  // namespace inpaint

// dtype (of h_n): 0 = float32, 1 = bfloat16. tab (2, V, 3H) int8; whh0 /
// whh1 (2, H, 3H) and wih1 (2, 2H, 3H) int8, each direction packed by
// kernel_common.pack_mma_b_s8; s_* and b* (2, 3H) f32 [fwd, bwd]; ys a
// (2, steps, B, H) int8 scratch; hn the (4, B, H) output [l0f, l0b, l1f, l1b].
// Returns the cudaError_t of the launches (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int inpaint_encoder_hn_int8(int dtype, const void* tokens, const void* tab,
                                       const void* whh0, const void* wih1, const void* whh1,
                                       const void* s_x0, const void* s_h0, const void* s_x1,
                                       const void* s_h1, const void* bih0, const void* bhh0,
                                       const void* bih1, const void* bhh1, void* ys, void* hn,
                                       int B, int steps, int H, int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define INPAINT_ENC_I8(OutT)                                                               \
  inpaint::EncI8Args<OutT> a{static_cast<const int*>(tokens),                              \
                             static_cast<const int8_t*>(tab),                              \
                             nullptr,                                                      \
                             static_cast<const int8_t*>(whh0),                             \
                             static_cast<const float*>(s_x0),                              \
                             static_cast<const float*>(s_h0),                              \
                             static_cast<const float*>(bih0),                              \
                             static_cast<const float*>(bhh0),                              \
                             static_cast<int8_t*>(ys),                                     \
                             static_cast<OutT*>(hn),                                       \
                             B, steps, H, V};                                              \
  return (int)inpaint::encoder_hn_int8<OutT>(                                              \
      a, static_cast<const int8_t*>(wih1), static_cast<const int8_t*>(whh1),               \
      static_cast<const float*>(s_x1), static_cast<const float*>(s_h1),                    \
      static_cast<const float*>(bih1), static_cast<const float*>(bhh1), s);
  if (dtype == 0) {
    INPAINT_ENC_I8(float)
  }
  if (dtype == 1) {
    INPAINT_ENC_I8(__nv_bfloat16)
  }
#undef INPAINT_ENC_I8
  return (int)cudaErrorInvalidValue;
}
