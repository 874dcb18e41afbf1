// K8: one direction of a GRU layer over a precomputed input projection
// xw = x @ W_ih + b_ih, with an optional hold mask: the generic layer that
// serves every GRU without a kernel of its own (the LatentRNN's context and
// generation GRUs, the decoder's beat GRU) under the "pallas" GRU route.
//
// Replaces the TPU kernel inpaintnet_tpu/ops/gru_pallas.py
// gru_layer_pallas_stream (_gru_stream_kernel), and with it
// gru_layer_pallas (K9) and gru_layer_pallas_dma (K10), which compute the
// same function. Same numerics as K8: the carry h is held in the parameter
// dtype and rounded to it after every step (unlike K5, whose carry is f32);
// hw = h @ W_hh takes h in the parameter dtype and accumulates in f32 (bf16:
// wgmma; f32: six bf16 wgmma passes over exact pieces); b_hh, xw and the
// gates run in f32,
// every multiply and add rounded on its own (gru_common.cuh gru_gate); a
// step whose mask is 0 keeps h and emits the held h, so an all-zero row
// returns h0; reverse runs t = steps-1 .. 0 and the outputs stay in time
// order.
//
// What bounds it on an H100: each step multiplies every row by the whole
// (H, 3H) W_hh. At the context GRUs' shape (2,048 rows, 16 steps, H 512)
// that is 51.5 GFLOP, at the generation GRU's (2,048 rows, 6 steps, H 1024)
// 77.3 GFLOP: 0.05-0.08 ms on bf16 tensor cores, 0.8-1.2 ms at the f32
// peak; the bytes (xw once, ys once) take less in bf16. W_hh is 1.5 MB
// (H 512) or 6 MB (H 1024) in bf16, far over a block's 227 KB of shared
// memory, so every block streams all of it from the 50 MB L2 on every step,
// and the L2 bytes per row fall as the row tile grows. In f32 the tensor
// cores take the product as six bf16 passes: 0.31-0.47 ms at the bf16 peak.
//
// bf16 route (every serving default), the Hopper design of
// gru_layer_hopper.cuh: a cluster of CTAs splits the units of a 64-row
// tile, each streaming its own W_hh^T gate slabs through TMA rings into
// wgmma and pushing its share of the new h into its peers' shared memory
// every step (the source's note says why).
//
// f32 route: K5's f32 cluster recurrence (gru_fwd_hopper.cuh, mode
// kLayer). The product on h runs as six bf16 wgmma passes over exact bf16
// pieces of h and W_hh (hi, mid, lo), each 64-wide k-slab's partial added
// with rounded f32 adds; C = H / 64 CTAs share a 64-row tile, each owning
// 64 units of all three gates and exchanging its units' pieces of the new h
// through an L2 scratch (16 CTAs at H 1024: a non-portable cluster); a
// held step keeps h and passes the held h's pieces on.
//
// Above 1024 units (kLayerMaxHidden, the bf16 route's widest h tile) both
// dtypes run K5's recurrence in mode kLayer on tile groups that span
// clusters (gru_fwd_hopper.cuh kSyncGroup / kSyncStep; inpaint_gru_layer_
// tiles): 64 units a CTA in f32, 128 in bf16, the CTAs of a tile meeting
// at a counter in global memory. At the 768 LatentRNN's generation GRU (H
// 1,536 x 2,048 rows x 6 steps) the bf16 bound is 1.74e11 operations,
// 0.176 ms at the dense peak.
#include <string.h>

#include "gru_fwd_hopper.cuh"
#include "gru_layer_hopper.cuh"

namespace inpaint {
constexpr int kLayerMaxHidden = 1024;  // the bf16 route's widest h tile; wider: tile groups

// The launchers live here, not in the headers, so that the other sources
// that include those headers do not compile these kernels again.
namespace rec90 {

inline int gru_layer_slots(int H, int C, int stages) {
  if (!plan_fits(H, C, stages, 1)) return -1;
  const size_t smem = smem_bytes(H, 1, stages);
  switch (chunks_per_warpgroup(H, C)) {
    case 1: return max_clusters(gru_layer_kernel<1>, C, smem);
    case 2: return max_clusters(gru_layer_kernel<2>, C, smem);
    case 3:
    case 4: return max_clusters(gru_layer_kernel<4>, C, smem);
    default: return max_clusters(gru_layer_kernel<8>, C, smem);
  }
}

inline cudaError_t launch_gru_layer(const CUtensorMap& map, const LayerArgs& a, int C,
                                    cudaStream_t stream) {
  if (!plan_fits(a.H, C, a.stages, 1) || a.B < 1 || a.steps < 1) return cudaErrorInvalidValue;
  const int clusters = (a.B + kRows - 1) / kRows;
  const size_t smem = smem_bytes(a.H, 1, a.stages);
  switch (chunks_per_warpgroup(a.H, C)) {
    case 1: return launch_clusters(gru_layer_kernel<1>, clusters, C, smem, stream, map, a);
    case 2: return launch_clusters(gru_layer_kernel<2>, clusters, C, smem, stream, map, a);
    case 3:
    case 4: return launch_clusters(gru_layer_kernel<4>, clusters, C, smem, stream, map, a);
    case 5:
    case 6:
    case 7:
    case 8: return launch_clusters(gru_layer_kernel<8>, clusters, C, smem, stream, map, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rec90

namespace fwd90 {

// K8's f32 layer over a.B rows: `w_map` is make_w_map's over the packed
// W_hh pieces for U = 64 (C = H / 64 CTAs, up to 16); the scratch holds
// (tiles, 2, 3, 64, H) bf16; a.out (ys) may be null, a.hn not
inline cudaError_t launch_gru_layer_f32(const CUtensorMap& w_map, const FwdArgs& a, int C,
                                        cudaStream_t stream) {
  if (!plan_fits<float>(a.H, C, a.stages, kMaxLayerCluster) || a.H / C != 64 || a.B < 1 ||
      a.steps < 1 || a.scratch == nullptr || a.hn == nullptr)
    return cudaErrorInvalidValue;
  return run_k5<float, 1, kLayer>(w_map, a, C, stream);
}

}  // namespace fwd90
}  // namespace inpaint

// The f32 route: `w_map` is inpaint_gru_fwd_w_map's over the packed W_hh
// pieces (gru_train_kernel.pack_fwd_weights) for 64 units a CTA; `scratch`
// holds (tiles, 2, 3, 64, H) bf16; `cluster` is H / 64 (at most 16) and
// `stages` the ring's depth (gru_kernel.f32_plan). xw (B, steps, 3H), b_hh
// (3H,), h0 (B, H), ys (B, steps, H) or null, hn (B, H), all f32; keep (B,
// steps) uint8 or null (0 holds h at that step); reverse != 0 runs t =
// steps-1 .. 0. Returns the cudaError_t of the launch (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int inpaint_gru_layer_f32(const void* w_map, const void* xw, const void* bhh,
                                     const void* h0, const void* keep, void* ys, void* hn,
                                     void* scratch, int B, int steps, int H, int reverse,
                                     int cluster, int stages, void* stream) {
  using namespace inpaint::fwd90;
  if (w_map == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memcpy(&m, w_map, sizeof(m));
  FwdArgs a{};
  a.xw = xw;
  a.bhh = bhh;
  a.h0 = h0;
  a.out = ys;
  a.scratch = static_cast<__nv_bfloat16*>(scratch);
  a.B = B;
  a.steps = steps;
  a.H = H;
  a.reverse = reverse;
  a.stages = stages;
  a.hn = static_cast<float*>(hn);
  a.keep = static_cast<const uint8_t*>(keep);
  return (int)launch_gru_layer_f32(m, a, cluster, static_cast<cudaStream_t>(stream));
}

// K8 above 1,024 units (or where a check forces it), both dtypes (0 f32, 1
// bf16): K5's recurrence in mode kLayer on the CTAs of a tile beyond one
// cluster (gru_fwd_hopper.cuh run_k5_tiles), 64 units a CTA in f32, 128 in
// bf16 (whose h tile no longer fits gru_layer_hopper.cuh's CTAs). w_map:
// inpaint_gru_fwd_w_map's for those units; xw, bhh, h0, keep, ys (or
// null), hn in the parameter dtype as inpaint_gru_layer_f32's; scratch
// (tiles, 2, P, 64, H) bf16 (P 3 in f32, 1 in bf16); `sync` 1 `groups`
// persistent tile groups of `group` CTAs (counters: (tiles,) uint32 zeros),
// 2 one launch a step (carry: (B, H) f32); `fault` a planted GroupFault (0
// none).
extern "C" int inpaint_gru_layer_tiles(int dtype, const void* w_map, const void* xw,
                                       const void* bhh, const void* h0, const void* keep,
                                       void* ys, void* hn, void* scratch, void* counters,
                                       void* carry, int B, int steps, int H, int reverse,
                                       int group, int groups, int stages, int sync, int fault,
                                       void* stream) {
  using namespace inpaint::fwd90;
  if (w_map == nullptr || hn == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memcpy(&m, w_map, sizeof(m));
  FwdArgs a{};
  a.xw = xw;
  a.bhh = bhh;
  a.h0 = h0;
  a.out = ys;
  a.scratch = static_cast<__nv_bfloat16*>(scratch);
  a.B = B;
  a.steps = steps;
  a.H = H;
  a.reverse = reverse;
  a.stages = stages;
  a.hn = static_cast<float*>(hn);  // the kernel stores h_n in the parameter dtype
  a.keep = static_cast<const uint8_t*>(keep);
  a.counters = static_cast<unsigned int*>(counters);
  a.carry = static_cast<float*>(carry);
  a.group = group;
  a.fault = fault;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_k5_tiles<float, 1, kLayer>(m, a, sync, groups, s);
  if (dtype == 1) return (int)run_k5_tiles<__nv_bfloat16, 2, kLayer>(m, a, sync, groups, s);
  return (int)cudaErrorInvalidValue;
}

// CTAs of K8's tile-group kernel (dtype 0 f32 at 64 units a CTA, 1 bf16 at
// 128) with `stages` ring stages that the card holds at once; -1 where the
// plan does not fit.
extern "C" int inpaint_gru_layer_resident(int dtype, int stages) {
  using namespace inpaint::fwd90;
  using inpaint::sm90::kSyncGroup;
  if (stages < 2 || stages > kMaxStages) return -1;
  if (dtype == 0)
    return inpaint::sm90::resident_ctas(gru_fwd_kernel<float, 1, kLayer, kSyncGroup>,
                                        smem_bytes(64, 3, stages), kThreads);
  if (dtype == 1)
    return inpaint::sm90::resident_ctas(gru_fwd_kernel<__nv_bfloat16, 2, kLayer, kSyncGroup>,
                                        smem_bytes(128, 1, stages), kThreads);
  return -1;
}

// Clusters of `cluster` (H / 64) CTAs of the f32 route with `stages` ring
// stages that the card runs at once (16 CTAs: a non-portable cluster, so
// fewer GPCs hold one); -1 where the plan does not fit.
extern "C" int inpaint_gru_layer_f32_slots(int H, int cluster, int stages) {
  using namespace inpaint::fwd90;
  const auto kernel = gru_fwd_kernel<float, 1, kLayer>;
  if (!plan_fits<float>(H, cluster, stages, kMaxLayerCluster) || H / cluster != 64) return -1;
  if (cluster > kMaxCluster &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
          cudaSuccess)
    return -1;
  return inpaint::rec90::max_clusters(kernel, cluster, smem_bytes(64, 3, stages), kThreads);
}

// Encode into `map_out` (128 bytes, 64-byte aligned) the tensor map of
// `blocks` packed 96 x 64 bf16 k-slabs of a hidden width H
// (gru_kernel.pack_gate_blocks; decode_kernel.pack_decode_weights) that the
// bf16 routes of K8 and K2 stream.
extern "C" int inpaint_slab_map(const void* packed, int blocks, int H, void* map_out) {
  if (H % 64 != 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  return (int)inpaint::rec90::make_slab_map(static_cast<CUtensorMap*>(map_out), packed, blocks,
                                            H);
}

// The bf16 route (gru_layer_hopper.cuh): `map` is inpaint_slab_map's over
// pack_gate_blocks(w_hh); `cluster` CTAs share each 64-row tile
// and `stages` is the depth of each consumer warpgroup's ring
// (gru_kernel.launch_plan). Other tensors as the f32 route's, in bf16.
extern "C" int inpaint_gru_layer_bf16(const void* map, const void* xw, const void* bhh,
                                      const void* h0, const void* keep, void* ys, void* hn,
                                      int B, int steps, int H, int reverse, int cluster,
                                      int stages, void* stream) {
  if (map == nullptr || H > inpaint::kLayerMaxHidden) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memcpy(&m, map, sizeof(m));
  const inpaint::rec90::LayerArgs a{static_cast<const __nv_bfloat16*>(xw),
                                    static_cast<const __nv_bfloat16*>(bhh),
                                    static_cast<const __nv_bfloat16*>(h0),
                                    static_cast<const uint8_t*>(keep),
                                    static_cast<__nv_bfloat16*>(ys),
                                    static_cast<__nv_bfloat16*>(hn),
                                    B, steps, H, reverse, stages};
  return (int)inpaint::rec90::launch_gru_layer(m, a, cluster, static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` CTAs of the bf16 route's kernel for hidden width H
// and `stages` ring stages that the card runs at once (the launch plan's
// wave size); -1 where the plan does not fit.
extern "C" int inpaint_gru_layer_slots(int H, int cluster, int stages) {
  return inpaint::rec90::gru_layer_slots(H, cluster, stages);
}
