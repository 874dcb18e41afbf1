// K5: the forward of one GRU layer direction in training, over a
// precomputed input projection xw = x @ W_ih + b_ih. Besides the outputs
// ys it emits the gates the hand-written backward (K6, gru_bwd_seq.cu)
// consumes: r, z, n and hn = h @ W_hh + b_hh, all (steps, B, H) in original
// time order.
//
// Replaces the TPU kernel inpaintnet_tpu/ops/gru_bwd_pallas.py
// gru_fwd_seq_pallas (_fwd_seq_kernel), in both dtypes, through the Hopper
// design of gru_fwd_hopper.cuh. Same numerics: the carry is f32; the
// recurrent product takes h rounded to the parameter dtype and accumulates
// in f32 (the f32 route as bf16 wgmma passes over exact bf16 pieces);
// biases and gates run in f32, every multiply and add rounded on its own in
// the plain version's order (gru_train_kernel.gru_fwd_seq_reference); the
// five outputs are stored in the parameter dtype.
//
// What bounds it on an H100: the product's operations (155 GFLOP at the VAE
// encoder's 24 steps x 4,096 rows x H 512: 2.31 ms on the f32 FMA units,
// 0.16 ms on the bf16 tensor cores, six times that for the f32 route's six
// passes), then the five outputs' bytes (0.24 ms in bf16), behind each
// step's serial chain in every CTA: the product over all of H, the gates,
// the exchange of h's pieces through L2. gru_fwd_hopper.cuh says how the
// design answers.
#include <string.h>

#include "gru_fwd_hopper.cuh"

// dtype: 0 = float32, 1 = bfloat16. `w_map` is inpaint_gru_fwd_w_map's over
// the packed W pieces for this cluster size; `scratch` holds (tiles, 2, P,
// 64, H) bf16 (P = 3 in f32, 1 in bf16); `cluster` CTAs share each 64-row
// tile and `stages` is the ring's depth (gru_train_kernel.fwd_plan). xw:
// (B, steps, 3H); b_hh: (3H,); h0: (B, H); out: (5, steps, B, H) = ys, r,
// z, n, hn; all in the parameter dtype. reverse != 0 runs t = steps-1 .. 0.
// Returns the cudaError_t of the launch (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int inpaint_gru_fwd_hopper(int dtype, const void* w_map, const void* xw,
                                      const void* bhh, const void* h0, void* out, void* scratch,
                                      int B, int steps, int H, int reverse, int cluster,
                                      int stages, void* stream) {
  if (w_map == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memcpy(&m, w_map, sizeof(m));
  const inpaint::fwd90::FwdArgs a{xw, bhh, h0, out, static_cast<__nv_bfloat16*>(scratch),
                                  B,  steps, H, reverse, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)inpaint::fwd90::launch_gru_fwd<float>(m, a, cluster, s);
  if (dtype == 1) return (int)inpaint::fwd90::launch_gru_fwd<__nv_bfloat16>(m, a, cluster, s);
  return (int)cudaErrorInvalidValue;
}

// Encode into `map_out` (128 bytes, 64-byte aligned) the tensor map of the
// packed W pieces (gru_train_kernel.pack_fwd_weights: (pieces, H / 32,
// H / 64, 96, 64) bf16) that a CTA owning `units` units streams.
extern "C" int inpaint_gru_fwd_w_map(const void* packed, int H, int pieces, int units,
                                     void* map_out) {
  if (H % 64 != 0 || units < 64 || units > 128 || H % units != 0 ||
      (pieces != 1 && pieces != 3))
    return (int)cudaErrorInvalidValue;
  return (int)inpaint::fwd90::make_w_map(static_cast<CUtensorMap*>(map_out), packed, H, pieces,
                                         units);
}

// K5 above 1,024 units (or where a check forces it): the CTAs of a 64-row
// tile beyond one cluster (gru_fwd_hopper.cuh run_k5_tiles). dtype, w_map
// (for `group` CTAs a tile: 64 units each in f32, 128 in bf16), xw, bhh,
// h0, out and scratch as inpaint_gru_fwd_hopper's; `sync` 1 `groups`
// persistent tile groups of `group` CTAs (counters: (tiles,) uint32
// zeros), 2 one launch a step (carry: (B, H) f32, h between launches);
// `fault` a planted GroupFault (0 none).
extern "C" int inpaint_gru_fwd_tiles(int dtype, const void* w_map, const void* xw,
                                     const void* bhh, const void* h0, void* out, void* scratch,
                                     void* counters, void* carry, int B, int steps, int H,
                                     int reverse, int group, int groups, int stages, int sync,
                                     int fault, void* stream) {
  using namespace inpaint::fwd90;
  if (w_map == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memcpy(&m, w_map, sizeof(m));
  FwdArgs a{xw, bhh, h0, out, static_cast<__nv_bfloat16*>(scratch), B, steps, H, reverse, stages};
  a.counters = static_cast<unsigned int*>(counters);
  a.carry = static_cast<float*>(carry);
  a.group = group;
  a.fault = fault;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_k5_tiles<float, 1, kTrain>(m, a, sync, groups, s);
  if (dtype == 1) return (int)run_k5_tiles<__nv_bfloat16, 2, kTrain>(m, a, sync, groups, s);
  return (int)cudaErrorInvalidValue;
}

// CTAs of K5's tile-group kernel (dtype 0 f32 at 64 units a CTA, 1 bf16 at
// 128) with `stages` ring stages that the card holds at once; -1 where the
// plan does not fit.
extern "C" int inpaint_gru_fwd_resident(int dtype, int stages) {
  using namespace inpaint::fwd90;
  if (stages < 2 || stages > kMaxStages) return -1;
  if (dtype == 0)
    return inpaint::sm90::resident_ctas(gru_fwd_kernel<float, 1, kTrain, inpaint::sm90::kSyncGroup>,
                                        smem_bytes(64, 3, stages), kThreads);
  if (dtype == 1)
    return inpaint::sm90::resident_ctas(
        gru_fwd_kernel<__nv_bfloat16, 2, kTrain, inpaint::sm90::kSyncGroup>,
        smem_bytes(128, 1, stages), kThreads);
  return -1;
}
