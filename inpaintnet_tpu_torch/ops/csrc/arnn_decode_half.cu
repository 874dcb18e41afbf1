// K7's bf16 route (arnn_decode.cu) with boxes of half a k-slab: the
// instantiations arnn_kernel<1, kChunks, true> of arnn_hopper.cuh, which
// the widths above 512 units take (H 576 on clusters of 9 CTAs, 640 on 10:
// 64 units a CTA, one chunk a consumer warpgroup; arnn_kernel.
// arnn_box_halves). A source of its own, so that nvcc builds them beside
// arnn_decode.cu, in parallel.
#include "arnn_hopper.cuh"

namespace inpaint {
namespace rec90 {

cudaError_t launch_arnn_half(const CUtensorMap& map, const ArnnArgs& a, int C, int clusters,
                             size_t smem, cudaStream_t stream) {
  if (chunks_per_warpgroup(a.H, C) != 1) return cudaErrorInvalidValue;
  const bool one = out_chunks(a.V) == 1 && a.HT == a.LP && a.OK == 4;
  return one ? launch_arnn_kernel(arnn_kernel<1, false, true>, map, a, C, clusters, smem, stream)
             : launch_arnn_kernel(arnn_kernel<1, true, true>, map, a, C, clusters, smem, stream);
}

int arnn_half_slots(int C, size_t smem) {
  return arnn_kernel_slots(arnn_kernel<1, false, true>, C, smem);
}

}  // namespace rec90
}  // namespace inpaint
