// K2's bf16 route (decode_sampling.cu) with a head of more than one
// 96-column chunk: the instantiations decode_kernel<MAXC, true> of
// decode_hopper.cuh, in a source of their own so that nvcc builds them
// beside decode_sampling.cu's one-chunk ones, in parallel (as K4's,
// decode_sampling_int8_chunks.cu).
#include "decode_hopper.cuh"

namespace inpaint {
namespace rec90 {

cudaError_t launch_decode_chunks(const CUtensorMap& map, const DecodeArgs& a, int C, int clusters,
                                 size_t smem, cudaStream_t stream) {
  return launch_decode_as<true>(map, a, C, clusters, smem, stream);
}

}  // namespace rec90
}  // namespace inpaint
