// FlashAttention-2 forward for sm_90a at head dims between the built ones:
// the masked instances (flash_attention_fwd.cuh), in a source of their own
// so that they compile beside the full-width ones.
#include "flash_attention_fwd.cuh"

namespace ptt {
namespace flash_fwd {

cudaError_t launch_masked(int dtype, const void* q, const void* k,
                          const void* v, void* o, void* lse, int B, int Nq,
                          int Nkv, int Sq, int Sk, int hd, const int* st,
                          int causal, int q_offset, float scale,
                          cudaStream_t stream) {
  return dispatch_dtype_dim(dtype, hd, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    return launch<T, decltype(dim)::value, false>(
        q, k, v, o, lse, B, Nq, Nkv, Sq, Sk, hd, st, causal, q_offset, scale,
        stream);
  });
}

}  // namespace flash_fwd
}  // namespace ptt
