// K4: the int8 twin of K2 (decode_sampling.cu): the hierarchical decoder's
// 24-tick argmax decode of one measure per row, with int8 x int8 -> int32
// products.
//
// Replaces the TPU kernel inpaintnet_tpu/ops/decode_pallas.py
// decode_sampling_pallas_int8 (_decode_kernel_int8). Same numerics
// (ops/decode_kernel.py decode_sampling_int8_reference):
// - the tick-GRU hiddens are not tanh-bounded (the per-beat inits are
//   selu outputs), so each ROW has its own scale q[r] = 127 / bound[r]
//   (host-computed from that row's init hiddens alone, which keeps a
//   row's tokens independent of its co-batched rows); both carries are
//   stored as round(h * q[r]) in int8 and dequantized by dq = 1 / q[r];
// - every product is dequantized as (acc * column scale) * dq + bias in f32;
//   gates in f32;
// - logits = relu(acc * head_s * dq + head_b) in f32; the argmax takes the
//   first index among equal maxima over the V real columns (so the TPU
//   kernel's -1 padding is not needed); logits are stored in T;
// - the fed-back token's layer-0 projection is tok_q[token] * s_tok rounded
//   to T (the TPU kernel's scratch dtype) before ctx_xw is added; it is
//   recomputed from the token index, so no (rows, 3H) slab is kept.
//
// What bounds it on an H100: as K2, each tick multiplies a row tile by three
// (H, 3H) int8 matrices and the (H, V) head (about 2.3 MB at H = 512, half
// of K2's bf16 bytes), streamed from L2 behind a serial chain (layer 0 ->
// layer 1 -> head -> argmax -> feedback) that allows no overlap across
// ticks. Design: K2's, on int8 tiles (mma.sync m16n8k32); every multiply
// and add rounded on its own, in the plain version's order.
#include "gru_common.cuh"

namespace inpaint {

constexpr int kTicksI8 = 24;
constexpr int kTicksPerBeatI8 = 6;
constexpr int kMTd8 = 2;  // 32-row tiles
constexpr int kTMd8 = 16 * kMTd8;

template <typename T>
struct DecodeI8Args {
  const T* ctx_xw;        // (4, B, 3H): beat-context part of x @ W_ih0, b_ih0 folded in
  const int8_t* hi0;      // (4, B, H) per-beat layer-0 init hiddens, quantized at q
  const int8_t* hi1;      // (4, B, H) per-beat layer-1 init hiddens, quantized at q
  const float* q;         // (B,) per-row hidden scale 127 / bound
  const int8_t* tok_tab;  // (V, 3H) quantized emb @ W_ih0[:E]
  const T* x0_xw;         // (3H,): x_0 @ W_ih0[:E], the tick-0 input
  const void* whh0;       // (H, 3H) int8, packed
  const void* wih1;       // (H, 3H) int8, packed
  const void* whh1;       // (H, 3H) int8, packed
  const float* scales;    // (4, 3H): column scales of W_hh0, W_ih1, W_hh1, tok_tab
  const float* bias;      // (3, 3H) f32: b_hh0, b_ih1, b_hh1
  const void* head_w;     // (H, VP) int8, zero columns past V, packed
  const float* head_s;    // (VP,) column scales of the head
  const float* head_b;    // (VP,) f32
  T* logits;              // (B, 24, V)
  int* samples;           // (B, 24)
  int B, H, V, VP;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_int8_kernel(const DecodeI8Args<T> p) {
  using Tr = Traits<T>;
  constexpr int MT = kMTd8, TM = kTMd8;
  const int row0 = blockIdx.x * TM;
  const int H = p.H, H3 = 3 * H, B = p.B, VP = p.VP;
  const int ldh = H + kPadS8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* lg = reinterpret_cast<float*>(smem_raw);      // (TM, VP) f32 logits
  float* qs = lg + TM * VP;                            // (TM,) q per row
  float* dqs = qs + TM;                                // (TM,) 1 / q per row
  int* prev = reinterpret_cast<int*>(dqs + TM);        // (TM,) fed-back token, -1 = x_0
  int8_t* h0c = reinterpret_cast<int8_t*>(prev + TM);  // four (TM, H) int8 tiles
  int8_t* h0n = h0c + TM * ldh;
  int8_t* h1c = h0n + TM * ldh;
  int8_t* h1n = h1c + TM * ldh;

  for (int r = threadIdx.x; r < TM; r += blockDim.x) {
    const float q = row0 + r < B ? p.q[row0 + r] : 127.0f;  // padding rows: 127
    qs[r] = q;
    dqs[r] = 1.0f / q;
    prev[r] = -1;
  }
  const int warp = threadIdx.x >> 5;
  const float* s_whh0 = p.scales;
  const float* s_wih1 = p.scales + H3;
  const float* s_whh1 = p.scales + 2 * H3;
  const float* s_tok = p.scales + 3 * H3;
  const float* b_hh0 = p.bias;
  const float* b_ih1 = p.bias + H3;
  const float* b_hh1 = p.bias + 2 * H3;

  for (int t = 0; t < kTicksI8; ++t) {
    const int beat = t / kTicksPerBeatI8;
    if (t % kTicksPerBeatI8 == 0) {
      load_rows(h0c, ldh, p.hi0 + (size_t)beat * B * H, H, row0, TM, B);
      load_rows(h1c, ldh, p.hi1 + (size_t)beat * B * H, H, row0, TM, B);
    }
    __syncthreads();

    // layer 0: xw = fed-back token projection (rounded to T) + beat context
    for (int c = 0; c < H / kChunk; ++c) {
      const int j0 = c * kChunk + warp * 8;
      const int nt[3] = {j0 / 8, (H + j0) / 8, (2 * H + j0) / 8};
      int ah[3][MT][4];
      zero_acc(ah);
      gemm_s8<MT, 3>(ah, h0c, ldh, H, p.whh0, nt);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = acc_row(m, i);
          const int j = j0 + acc_col(i);
          const float dq = dqs[r];
          float xw[3];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const int col = g * H + j;
            const float fb =
                prev[r] < 0
                    ? Tr::to_f(p.x0_xw[col])
                    : Tr::to_f(Tr::from_f(__fmul_rn(
                          (float)p.tok_tab[(size_t)prev[r] * H3 + col], s_tok[col])));
            const float ctx = row0 + r < B
                                  ? Tr::to_f(p.ctx_xw[((size_t)beat * B + row0 + r) * H3 + col])
                                  : 0.0f;
            xw[g] = __fadd_rn(fb, ctx);
          }
          const float hr = dequant(ah[0][m][i], s_whh0[j], dq, b_hh0[j]);
          const float hz = dequant(ah[1][m][i], s_whh0[H + j], dq, b_hh0[H + j]);
          const float hn = dequant(ah[2][m][i], s_whh0[2 * H + j], dq, b_hh0[2 * H + j]);
          const float h = __fmul_rn((float)h0c[r * ldh + j], dq);
          h0n[r * ldh + j] = quant_h(gru_gate(xw[0], hr, xw[1], hz, xw[2], hn, h), qs[r]);
        }
      }
    }
    __syncthreads();

    // layer 1: xw = h0' @ W_ih1; hw = h1 @ W_hh1
    for (int c = 0; c < H / kChunk; ++c) {
      const int j0 = c * kChunk + warp * 8;
      const int nt[3] = {j0 / 8, (H + j0) / 8, (2 * H + j0) / 8};
      int ax[3][MT][4], ah[3][MT][4];
      zero_acc(ax);
      zero_acc(ah);
      gemm_s8<MT, 3>(ax, h0n, ldh, H, p.wih1, nt);
      gemm_s8<MT, 3>(ah, h1c, ldh, H, p.whh1, nt);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = acc_row(m, i);
          const int j = j0 + acc_col(i);
          const float dq = dqs[r];
          const float xr = dequant(ax[0][m][i], s_wih1[j], dq, b_ih1[j]);
          const float xz = dequant(ax[1][m][i], s_wih1[H + j], dq, b_ih1[H + j]);
          const float xn = dequant(ax[2][m][i], s_wih1[2 * H + j], dq, b_ih1[2 * H + j]);
          const float hr = dequant(ah[0][m][i], s_whh1[j], dq, b_hh1[j]);
          const float hz = dequant(ah[1][m][i], s_whh1[H + j], dq, b_hh1[H + j]);
          const float hn = dequant(ah[2][m][i], s_whh1[2 * H + j], dq, b_hh1[2 * H + j]);
          const float h = __fmul_rn((float)h1c[r * ldh + j], dq);
          h1n[r * ldh + j] = quant_h(gru_gate(xr, hr, xz, hz, xn, hn, h), qs[r]);
        }
      }
    }
    __syncthreads();

    // ReLU head into f32 smem
    for (int ntile = warp; ntile < VP / 8; ntile += kWarps) {
      const int nt[1] = {ntile};
      int acc[1][MT][4];
      zero_acc(acc);
      gemm_s8<MT, 1>(acc, h1n, ldh, H, p.head_w, nt);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = acc_row(m, i);
          const int col = ntile * 8 + acc_col(i);
          lg[r * VP + col] =
              fmaxf(dequant(acc[0][m][i], p.head_s[col], dqs[r], p.head_b[col]), 0.0f);
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
      if (row0 + r < B) p.samples[(size_t)(row0 + r) * kTicksI8 + t] = arg;
    }
    for (int idx = threadIdx.x; idx < TM * p.V; idx += blockDim.x) {
      const int r = idx / p.V, v = idx % p.V;
      if (row0 + r < B)
        p.logits[((size_t)(row0 + r) * kTicksI8 + t) * p.V + v] = Tr::from_f(lg[r * VP + v]);
    }
    __syncthreads();
    int8_t* tmp = h0c;
    h0c = h0n;
    h0n = tmp;
    tmp = h1c;
    h1c = h1n;
    h1n = tmp;
  }
}

template <typename T>
static cudaError_t decode_sampling_int8(const DecodeI8Args<T>& a, cudaStream_t stream) {
  const size_t smem = (size_t)kTMd8 * a.VP * sizeof(float) + 2ull * kTMd8 * sizeof(float) +
                      kTMd8 * sizeof(int) + 4ull * kTMd8 * (a.H + kPadS8);
  cudaError_t err = cudaFuncSetAttribute(decode_int8_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  decode_int8_kernel<T><<<(a.B + kTMd8 - 1) / kTMd8, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace inpaint

// dtype (of ctx_xw, x0_xw and logits): 0 = float32, 1 = bfloat16. Tensors
// as documented on DecodeI8Args. Returns the cudaError_t of the launch (0 on
// success); launches on `stream` and does not synchronise.
extern "C" int inpaint_decode_sampling_int8(int dtype, const void* ctx_xw, const void* hi0,
                                            const void* hi1, const void* q,
                                            const void* tok_tab, const void* x0_xw,
                                            const void* whh0, const void* wih1,
                                            const void* whh1, const void* scales,
                                            const void* bias, const void* head_w,
                                            const void* head_s, const void* head_b,
                                            void* logits, void* samples, int B, int H, int V,
                                            int VP, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define INPAINT_DECODE_I8(T)                                                             \
  inpaint::DecodeI8Args<T> a{static_cast<const T*>(ctx_xw),                              \
                             static_cast<const int8_t*>(hi0),                            \
                             static_cast<const int8_t*>(hi1),                            \
                             static_cast<const float*>(q),                               \
                             static_cast<const int8_t*>(tok_tab),                        \
                             static_cast<const T*>(x0_xw),                               \
                             whh0,                                                       \
                             wih1,                                                       \
                             whh1,                                                       \
                             static_cast<const float*>(scales),                          \
                             static_cast<const float*>(bias),                            \
                             head_w,                                                     \
                             static_cast<const float*>(head_s),                          \
                             static_cast<const float*>(head_b),                          \
                             static_cast<T*>(logits),                                    \
                             static_cast<int*>(samples),                                 \
                             B, H, V, VP};                                               \
  return (int)inpaint::decode_sampling_int8<T>(a, s);
  if (dtype == 0) {
    INPAINT_DECODE_I8(float)
  }
  if (dtype == 1) {
    INPAINT_DECODE_I8(__nv_bfloat16)
  }
#undef INPAINT_DECODE_I8
  return (int)cudaErrorInvalidValue;
}
