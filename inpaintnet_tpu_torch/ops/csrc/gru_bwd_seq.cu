// K6: the sequential part of one GRU layer direction's backward, from the
// gates K5 stored: per step the cotangents da of x @ W_ih + b_ih and dhw of
// h @ W_hh + b_hh, (steps, B, 3H) in original time order, and the carried
// dh, whose value after the last processed step is dh0 (B, H). The weight
// and input gradients are batched matrix products outside
// (ops/gru_trainfast.py). A forward-direction layer is processed t =
// steps-1 .. 0, a reverse one t = 0 .. steps-1.
//
// Replaces the TPU kernel inpaintnet_tpu/ops/gru_bwd_pallas.py
// gru_bwd_seq_pallas (_bwd_seq_kernel), in both dtypes, through the Hopper
// design of gru_bwd_hopper.cuh (which says what bounds it and how the
// design answers): the f32 product as bf16 wgmma passes over exact bf16
// pieces, a cluster of CTAs sharing each 64-row tile.
#include <string.h>

#include "gru_bwd_hopper.cuh"

// The Hopper route (gru_bwd_hopper.cuh), both dtypes (0 = float32, 1 =
// bfloat16): `w_map` is inpaint_gru_bwd_w_map's over the packed W pieces
// for this cluster size; `scratch` holds (tiles, 2, 3, 64, 3H) bf16;
// `cluster` CTAs share each 64-row tile and `stages` is the ring's depth
// (gru_train_kernel.bwd_plan). dys, r, z, n, hn, hprev: (steps, B, H);
// da, dhw: (steps, B, 3H); dh0: (B, H); all in the parameter dtype, in
// original time order; reverse is the layer's direction. Returns the
// cudaError_t of the launch (0 on success); launches on `stream` and does
// not synchronise.
extern "C" int inpaint_gru_bwd_hopper(int dtype, const void* w_map, const void* dys,
                                      const void* r, const void* z, const void* n,
                                      const void* hn, const void* hprev, void* da, void* dhw,
                                      void* dh0, void* scratch, int B, int steps, int H,
                                      int reverse, int cluster, int stages, void* stream) {
  if (w_map == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memcpy(&m, w_map, sizeof(m));
  const inpaint::bwd90::BwdArgs a{dys, r, z, n, hn, hprev, da, dhw, dh0,
                                  static_cast<__nv_bfloat16*>(scratch), B, steps, H, reverse,
                                  stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)inpaint::bwd90::launch_gru_bwd<float>(m, a, cluster, s);
  if (dtype == 1) return (int)inpaint::bwd90::launch_gru_bwd<__nv_bfloat16>(m, a, cluster, s);
  return (int)cudaErrorInvalidValue;
}

// Encode into `map_out` (128 bytes, 64-byte aligned) the tensor map of the
// packed W pieces (gru_train_kernel.pack_bwd_weights: (3H / 64, pieces, H,
// 64) bf16) that a CTA owning `units` units streams.
extern "C" int inpaint_gru_bwd_w_map(const void* packed, int H, int pieces, int units,
                                     void* map_out) {
  if (H % 64 != 0 || units < 64 || units > inpaint::bwd90::kMaxUnits || H % units != 0 ||
      (pieces != 1 && pieces != 3))
    return (int)cudaErrorInvalidValue;
  return (int)inpaint::bwd90::make_w_map(static_cast<CUtensorMap*>(map_out), packed, H, pieces,
                                         units);
}

// K6 above 1,024 units (or where a check forces it): `group` CTAs of 128
// units a 64-row tile, beyond one cluster (gru_bwd_hopper.cuh
// run_k6_tiles). w_map: inpaint_gru_bwd_w_map's for 128 units; the other
// tensors as inpaint_gru_bwd_hopper's; `sync` 1 `groups` persistent tile
// groups (counters: (tiles,) uint32 zeros), 2 one launch a step and one
// more (carry: (B, H) f32); `fault` a planted GroupFault (0 none).
extern "C" int inpaint_gru_bwd_tiles(int dtype, const void* w_map, const void* dys,
                                     const void* r, const void* z, const void* n,
                                     const void* hn, const void* hprev, void* da, void* dhw,
                                     void* dh0, void* scratch, void* counters, void* carry, int B,
                                     int steps, int H, int reverse, int group, int groups,
                                     int stages, int sync, int fault, void* stream) {
  using namespace inpaint::bwd90;
  if (w_map == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memcpy(&m, w_map, sizeof(m));
  BwdArgs a{dys, r, z, n, hn, hprev, da, dhw, dh0, static_cast<__nv_bfloat16*>(scratch),
            B,   steps, H, reverse, stages};
  a.counters = static_cast<unsigned int*>(counters);
  a.carry = static_cast<float*>(carry);
  a.group = group;
  a.fault = fault;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_k6_tiles<float>(m, a, sync, groups, s);
  if (dtype == 1) return (int)run_k6_tiles<__nv_bfloat16>(m, a, sync, groups, s);
  return (int)cudaErrorInvalidValue;
}

// CTAs of K6's tile-group kernel (dtype 0 f32, 1 bf16; 128 units a CTA)
// with `stages` ring stages that the card holds at once; -1 where the plan
// does not fit.
extern "C" int inpaint_gru_bwd_resident(int dtype, int stages) {
  using namespace inpaint::bwd90;
  using inpaint::sm90::kSyncGroup;
  if (stages < 2 || stages > kMaxStages) return -1;
  if (dtype == 0)
    return inpaint::sm90::resident_ctas(gru_bwd_kernel<float, kMaxUnits / 2, kSyncGroup>,
                                        smem_bytes(kMaxUnits, 3, stages), kThreads);
  if (dtype == 1)
    return inpaint::sm90::resident_ctas(gru_bwd_kernel<__nv_bfloat16, kMaxUnits / 2, kSyncGroup>,
                                        smem_bytes(kMaxUnits, 1, stages), kThreads);
  return -1;
}
