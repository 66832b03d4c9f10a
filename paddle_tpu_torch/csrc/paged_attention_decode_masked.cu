// Ragged paged-attention decode for sm_90a at head dims between the built
// ones: the masked instances (paged_attention_decode.cuh), in a source of
// their own so that they compile beside the full-width ones.
#include "paged_attention_decode.cuh"

namespace ptt {
namespace paged_decode {

cudaError_t launch_masked(int dtype, const void* q, const void* kp,
                          const void* vp, const void* pt, const void* sl,
                          void* out, int B, int nh, int nkv, int hd,
                          int ps, int pps, int nsplit, int q_sb, int q_sh,
                          float scale, cudaStream_t stream) {
  return dispatch_dtype_dim(dtype, hd, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    return launch<T, decltype(dim)::value, false>(
        q, kp, vp, pt, sl, out, B, nh, nkv, hd, ps, pps, nsplit, q_sb,
        q_sh, scale, stream);
  });
}

}  // namespace paged_decode
}  // namespace ptt
