// K4 (decode_sampling_int8.cu) with a head of more than one 96-column
// chunk: the instantiations decode_i8_kernel<T, MAXC, true> of
// decode_hopper.cuh, for both master dtypes. They live in a source of their
// own so that nvcc builds them beside decode_sampling_int8.cu's one-chunk
// instantiations, in parallel: the sixteen in one source made it the
// build's longest (PERF.md).
#include "decode_hopper.cuh"

namespace inpaint {
namespace rec90 {

cudaError_t launch_decode_i8_chunks(const CUtensorMap& map, const DecodeI8Args<float>& a, int C,
                                    int clusters, size_t smem, cudaStream_t stream) {
  return launch_decode_i8_as<float, true>(map, a, C, clusters, smem, stream);
}

cudaError_t launch_decode_i8_chunks(const CUtensorMap& map, const DecodeI8Args<__nv_bfloat16>& a,
                                    int C, int clusters, size_t smem, cudaStream_t stream) {
  return launch_decode_i8_as<__nv_bfloat16, true>(map, a, C, clusters, smem, stream);
}

}  // namespace rec90
}  // namespace inpaint
