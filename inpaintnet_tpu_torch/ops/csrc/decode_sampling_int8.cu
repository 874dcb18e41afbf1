// K4: the int8 twin of K2 (decode_sampling.cu): the hierarchical decoder's
// 24-tick argmax decode of one measure per row, with int8 x int8 -> int32
// products.
//
// Replaces the TPU kernel inpaintnet_tpu/ops/decode_pallas.py
// decode_sampling_pallas_int8 (_decode_kernel_int8). Same numerics, bit for
// bit (ops/decode_kernel.py decode_sampling_int8_reference):
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
// What bounds it on an H100, and the design: decode_hopper.cuh (K2's
// cluster recurrence on s8 wgmma, int8 tiles and slabs with the 64-byte
// swizzle), for bf16 and f32 masters alike.
#include <string.h>

#include "decode_hopper.cuh"

// `map` is inpaint_decode_map's over the packed int8 weights
// (decode_kernel.pack_decode_weights of the quantized W_hh0, W_ih1, W_hh1
// and head); `cluster` CTAs share each 64-row tile and `stages` is the
// depth of each consumer warpgroup's ring (decode_kernel.int8_plan). dtype
// (of ctx_xw, x0_xw and logits): 0 = float32, 1 = bfloat16. Tensors as
// documented on DecodeI8Args; `ties` 0 (1: the planted fault of
// decode_hopper.cuh head_beats). Returns the cudaError_t of the launch (0
// on success); launches on `stream` and does not synchronise.
extern "C" int inpaint_decode_sampling_int8(int dtype, const void* map, const void* ctx_xw,
                                            const void* hi0, const void* hi1, const void* q,
                                            const void* tok_q, const void* x0_xw,
                                            const void* scales, const void* bias,
                                            const void* head_s, const void* head_b,
                                            void* logits, void* samples, int B, int H, int V,
                                            int cluster, int stages, int ties, void* stream) {
  if (map == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memcpy(&m, map, sizeof(m));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define INPAINT_DECODE_I8(T)                                                                \
  {                                                                                         \
    const inpaint::rec90::DecodeI8Args<T> a{                                                \
        static_cast<const T*>(ctx_xw),     static_cast<const int8_t*>(hi0),                 \
        static_cast<const int8_t*>(hi1),   static_cast<const float*>(q),                    \
        static_cast<const int8_t*>(tok_q), static_cast<const T*>(x0_xw),                    \
        static_cast<const float*>(scales), static_cast<const float*>(bias),                 \
        static_cast<const float*>(head_s), static_cast<const float*>(head_b),               \
        static_cast<T*>(logits),           static_cast<int*>(samples),                      \
        B,                                 H,                                               \
        V,                                 stages,                                          \
        ties};                                                                              \
    return (int)inpaint::rec90::launch_decode_i8(m, a, cluster, s);                         \
  }
  if (dtype == 0) INPAINT_DECODE_I8(float)
  if (dtype == 1) INPAINT_DECODE_I8(__nv_bfloat16)
#undef INPAINT_DECODE_I8
  return (int)cudaErrorInvalidValue;
}
