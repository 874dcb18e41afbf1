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
// f32 route (tensor cores have no f32 product): the same staging, per
// chunk of rows, with two kernels shared with K5 and the bf16 GEMM:
// - each layer's recurrence is K5's f32 cluster recurrence
//   (gru_fwd_hopper.cuh, modes kEnc0 and kEnc1, both directions in one
//   launch): C CTAs share a 64-row tile, each owning 64 units of all three
//   gates; the product on h runs as six bf16 wgmma passes over exact bf16
//   pieces of h and W_hh, each 64-wide k-slab's partial added with rounded
//   f32 adds; the new h's pieces go to the peers through an L2 scratch.
//   Layer 0 writes its outputs as those three pieces (the GEMM's A operand,
//   no separate split), layer 1 nothing per step, both h_n;
// - layer 1's input projection is encoder_hopper.cuh's split GEMM (six
//   passes over W_ih1's pieces, b_ih1 added in f32 after the sum).
// What bounds it: the products at the bf16 peak x 6 passes (about 120 ms
// at 65,536 rows x 24 steps x H 512), against 295 ms of f32 FMA.
#include <string.h>

#include "encoder_hopper.cuh"
#include "gru_fwd_hopper.cuh"

namespace inpaint {
namespace fwd90 {

// K1's f32 layer `layer` (0 or 1) over the rows [a.row0, a.row0 + a.rows)
// of a.B, both directions: `w_map` is make_w_map's over both directions'
// packed W_hh pieces for U = H / C; the scratch holds (2, tiles, 2, 3, 64,
// H) bf16. (Here, not in gru_fwd_hopper.cuh, so that the other sources
// that include it do not compile K1's layers again.)
inline cudaError_t launch_encoder_layer(const CUtensorMap& w_map, const FwdArgs& a, int layer,
                                        int C, cudaStream_t stream) {
  if (!plan_fits<float>(a.H, C, a.stages) || a.H / C != 64 || a.rows < 1 || a.steps < 1 ||
      a.row0 < 0 || a.row0 + a.rows > a.B || a.scratch == nullptr || a.hn == nullptr)
    return cudaErrorInvalidValue;
  if (layer == 0) {
    if (a.tokens == nullptr || a.tab == nullptr || a.ys == nullptr || a.V < 1)
      return cudaErrorInvalidValue;
    return run_k5<float, 1, kEnc0>(w_map, a, C, stream);
  }
  if (layer == 1 && a.xw != nullptr) return run_k5<float, 1, kEnc1>(w_map, a, C, stream);
  return cudaErrorInvalidValue;
}

}  // namespace fwd90
}  // namespace inpaint

// Training mode (K1 in Encoder.apply(train=True) under
// INPAINTNET_TRAIN_ENCODER_IMPL=pallas; the TPU kernel applies the mask
// between its two pallas_calls): layer 0's stored outputs are dropped by a
// (B, steps, 2H) uint8 keep mask, keep ? y / (1 - rate) : 0 with a true
// division, in layer 0's own store (bf16: the rounded output divided in
// f32, rounded to bf16 once; f32: the f32 output divided before the split
// into the GEMM's pieces), so no pass over the scratch is added. The mask
// is indexed by global row (row0 + the chunk's row), step and unit; the
// carry and h_n stay undropped.
//
// bf16, one layer's recurrence over the rows [row0, row0 + rows) of B:
// whh (2, 3H, H) bf16, W_hh^T per direction with each 32-unit chunk's rows
// grouped [r, z, n] (ops/encoder_kernel.pack_gate_slabs); layer 0 reads
// tokens (B, steps) int32 and tab (2, V, 3H) f32 (the fused bf16 table
// plus b_ih) and writes ys (steps, rows, 2H) bf16; layer 1 reads xw (2,
// steps * rows, 3H) f32 (b_ih included); bhh (2, 3H) f32 (bih unused);
// hn the layer's (2, B, H) bf16 h_n; keep (B, steps, 2H) uint8 or null,
// layer 0 only, with keep_div = 1 - rate (the training mode); `consumers`
// consumer warpgroups (encoder_kernel.encoder_consumers: 4, or 2 above H 512).
extern "C" int inpaint_encoder_rec_bf16(int layer, const void* whh, const void* tokens,
                                        const void* tab, const void* xw, const void* bih,
                                        const void* bhh, void* ys, void* hn, const void* keep,
                                        int B, int row0, int rows, int steps, int H, int V,
                                        int consumers, float keep_div, void* stream) {
  using namespace inpaint::enc90;
  if (keep != nullptr && (layer != 0 || !(keep_div > 0.0f))) return (int)cudaErrorInvalidValue;
  RecArgs a{static_cast<const int*>(tokens), static_cast<const float*>(tab), xw, nullptr, nullptr,
            static_cast<const float*>(bih), static_cast<const float*>(bhh), ys, hn,
            B, row0, rows, steps, H, V, 0, consumers, static_cast<const uint8_t*>(keep),
            keep_div};
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

// f32, one layer's recurrence over the rows [row0, row0 + rows) of B, both
// directions: `w_map` is inpaint_encoder_w_map_f32's for U = H / cluster
// (64 units a CTA); scratch (2, tiles, 2, 3, 64, H) bf16, tiles = ceil(rows
// / 64); bhh (2, 3H) f32. Layer 0 reads tokens (B, steps) int32 and tab (2,
// V, 3H) f32 (the fused table plus b_ih) and writes ys (3, steps * rows,
// 2H) bf16, the pieces of its outputs; layer 1 reads xw (2, steps * rows,
// 3H) f32 (b_ih included); both write the layer's h_n to hn (2, B, H) f32.
// keep (B, steps, 2H) uint8 or null, layer 0 only, with keep_div = 1 - rate
// (the training mode).
extern "C" int inpaint_encoder_rec_f32(int layer, const void* w_map, const void* tokens,
                                       const void* tab, const void* xw, const void* bhh,
                                       void* ys, void* hn, void* scratch, const void* keep,
                                       int B, int row0, int rows, int steps, int H, int V,
                                       int cluster, int stages, float keep_div, void* stream) {
  using namespace inpaint::fwd90;
  if (w_map == nullptr) return (int)cudaErrorInvalidValue;
  if (keep != nullptr && (layer != 0 || !(keep_div > 0.0f))) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memcpy(&m, w_map, sizeof(m));
  FwdArgs a{};
  a.xw = xw;
  a.bhh = bhh;
  a.scratch = static_cast<__nv_bfloat16*>(scratch);
  a.B = B;
  a.steps = steps;
  a.H = H;
  a.stages = stages;
  a.tokens = static_cast<const int*>(tokens);
  a.tab = static_cast<const float*>(tab);
  a.ys = static_cast<__nv_bfloat16*>(ys);
  a.hn = static_cast<float*>(hn);
  a.row0 = row0;
  a.rows = rows;
  a.V = V;
  a.keep = static_cast<const uint8_t*>(keep);
  a.keep_div = keep_div;
  return (int)launch_encoder_layer(m, a, layer, cluster, static_cast<cudaStream_t>(stream));
}

// Encode into `map_out` (128 bytes, 64-byte aligned) the tensor map of both
// directions' packed W_hh pieces ((2, 3, H / 32, H / 64, 96, 64) bf16:
// gru_train_kernel.pack_fwd_weights of each) that a CTA owning `units`
// units streams.
extern "C" int inpaint_encoder_w_map_f32(const void* packed, int H, int units, void* map_out) {
  if (H % 64 != 0 || units != 64 || H % units != 0) return (int)cudaErrorInvalidValue;
  return (int)inpaint::fwd90::make_w_map(static_cast<CUtensorMap*>(map_out), packed, H, 3, units,
                                         2);
}

// f32 layer-1 input projection: out (2, M, 3H) f32 = a @ w[d]^T + bias[d]
// from the pieces a (3, M, 2H) bf16 and w (2, 3, 3H, 2H) bf16 (W_ih^T's
// pieces per direction), bias (2, 3H) f32.
extern "C" int inpaint_encoder_gemm_f32(const void* a, const void* w, const void* bias,
                                        void* out, int M, int H, void* stream) {
  return (int)inpaint::enc90::launch_proj_gemm_split(a, w, static_cast<const float*>(bias),
                                                     static_cast<float*>(out), M, 2 * H, 3 * H,
                                                     2, static_cast<cudaStream_t>(stream));
}
