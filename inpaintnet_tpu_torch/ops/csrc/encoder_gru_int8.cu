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
// emb @ W_ih: the TPU kernel's one-hot int8 product is that row lookup
// (dequantized by the host, as the plain version does it).
//
// What bounds it on an H100: as K1, every step multiplies a row tile by
// the whole (H, 3H) W_hh (layer 1 also by the (2H, 3H) W_ih), streamed from
// L2: at H = 512 that is 0.75 MB + 1.5 MB of int8 a step, half of K1's bf16
// bytes; at the serving shape L2 traffic and load latency bound it, not
// the int8 tensor cores.
//
// Design: K1's bf16 Hopper design (encoder_hopper.cuh) in int8. Layer 1's
// input projection leaves the step loop as one TMA + s8 wgmma GEMM over
// every step of a chunk of rows, storing the exact int32 sums, which the
// recurrence dequantizes as dequant(acc, s_x1, b_ih1): sums of integers are
// exact in any order, so the kernel stays bit-equal to its plain version.
// Each layer's recurrence keeps a 64-row int8 h tile in shared memory and
// streams W_hh's k-slabs (128 bytes deep, K padded to whole slabs) through
// a TMA ring into s8 wgmma. Every multiply and add of the dequantization
// and the gates is rounded on its own (gru_common.cuh), in the plain
// version's order.
#include "encoder_hopper.cuh"

// one layer's recurrence over the rows [row0, row0 + rows) of B. out_dtype
// (of h_n): 0 = float32, 1 = bfloat16. whh (2, 3H, Hk) int8, W_hh^T per
// direction with each 32-unit chunk's rows grouped [r, z, n] and K zero-
// padded to Hk, a multiple of 128 (ops/encoder_kernel.pack_gate_slabs);
// layer 0 reads tokens (B, steps) int32 and tab (2, V, 3H) f32 (the int8
// table dequantized and biased, tab_q * s_x0 + b_ih0) and writes ys (steps,
// rows, 2H) int8; layer 1 reads xw (2, steps * rows, 3H) int32 and
// dequantizes it with s_x, bih; s_h, bhh (2, 3H) f32 of the layer; hn the
// layer's (2, B, H); `consumers` consumer warpgroups
// (encoder_kernel.encoder_consumers: 4 at every K3 width).
extern "C" int inpaint_encoder_rec_int8(int out_dtype, int layer, const void* whh,
                                        const void* tokens, const void* tab, const void* xw,
                                        const void* s_x, const void* s_h, const void* bih,
                                        const void* bhh, void* ys, void* hn, int B, int row0,
                                        int rows, int steps, int H, int V, int consumers,
                                        void* stream) {
  using namespace inpaint::enc90;
  RecArgs a{static_cast<const int*>(tokens), static_cast<const float*>(tab), xw,
            static_cast<const float*>(s_x), static_cast<const float*>(s_h),
            static_cast<const float*>(bih), static_cast<const float*>(bhh), ys, hn,
            B, row0, rows, steps, H, V, 0, consumers};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0 && layer == 0) return (int)launch_rec<int8_t, float, true>(whh, a, s);
  if (out_dtype == 0 && layer == 1) return (int)launch_rec<int8_t, float, false>(whh, a, s);
  if (out_dtype == 1 && layer == 0)
    return (int)launch_rec<int8_t, __nv_bfloat16, true>(whh, a, s);
  if (out_dtype == 1 && layer == 1)
    return (int)launch_rec<int8_t, __nv_bfloat16, false>(whh, a, s);
  return (int)cudaErrorInvalidValue;
}

// int8 layer-1 input projection: out (2, M, 3H) int32 = a (M, 2H) int8 @
// w[d]^T for w (2, 3H, 2H) int8 (the quantized W_ih^T per direction).
extern "C" int inpaint_encoder_gemm_int8(const void* a, const void* w, void* out, int M, int H,
                                         void* stream) {
  return (int)inpaint::enc90::launch_xw_gemm<int8_t>(a, w, nullptr, out, M, H,
                                                     static_cast<cudaStream_t>(stream));
}
