// Ragged chunk-prefill attention for sm_90a at head dims between the
// built ones: the masked instances (paged_attention_prefill.cuh), in a
// source of their own so that they compile beside the full-width ones.
#include "paged_attention_prefill.cuh"

namespace ptt {
namespace paged_prefill {

cudaError_t launch_masked(int dtype, const void* q, const void* kp,
                          const void* vp, const void* pt, void* o, int B,
                          int C, int nh, int hd, int ps, int pps, int q_sb,
                          int q_ss, int q_sh, const int* q_offset, float scale,
                          cudaStream_t stream) {
  return dispatch_dtype_dim(dtype, hd, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    return launch<T, decltype(dim)::value, false>(
        q, kp, vp, pt, o, B, C, nh, hd, ps, pps, q_sb, q_ss, q_sh, q_offset,
        scale, stream);
  });
}

}  // namespace paged_prefill
}  // namespace ptt
