// K2's bf16 route (decode_sampling.cu) with boxes of half a k-slab: the
// instantiations decode_kernel<MAXC, kChunks, true> of decode_hopper.cuh,
// which a width takes where one-slab boxes leave its two bf16 h tiles fewer
// than two ring stages (H 768: decode_hopper.cuh decode_box_halves). Its
// cluster sizes there, 2 and 4 (384 and 192 units a CTA), need 8 and 4
// chunks a consumer warpgroup. A source of its own, so that nvcc builds them
// beside decode_sampling.cu, in parallel.
#include "decode_hopper.cuh"

namespace inpaint {
namespace rec90 {

cudaError_t launch_decode_half(const CUtensorMap& map, const DecodeArgs& a, int C, int clusters,
                               size_t smem, cudaStream_t stream) {
  const bool chunks = head_chunks(a.V) > 1;
  switch (chunks_per_warpgroup(a.H, C)) {
    case 3:
    case 4:
      return chunks ? launch_clusters(decode_kernel<4, true, true>, clusters, C, smem, stream, map,
                                      a, kDecodeThreads)
                    : launch_clusters(decode_kernel<4, false, true>, clusters, C, smem, stream,
                                      map, a, kDecodeThreads);
    case 5:
    case 6:
    case 7:
    case 8:
      return chunks ? launch_clusters(decode_kernel<8, true, true>, clusters, C, smem, stream, map,
                                      a, kDecodeThreads)
                    : launch_clusters(decode_kernel<8, false, true>, clusters, C, smem, stream,
                                      map, a, kDecodeThreads);
    default: return cudaErrorInvalidValue;
  }
}

int decode_half_slots(int H, int C, size_t smem) {
  switch (chunks_per_warpgroup(H, C)) {
    case 3:
    case 4: return max_clusters(decode_kernel<4, false, true>, C, smem, kDecodeThreads);
    case 5:
    case 6:
    case 7:
    case 8: return max_clusters(decode_kernel<8, false, true>, C, smem, kDecodeThreads);
    default: return -1;
  }
}

}  // namespace rec90
}  // namespace inpaint
