// FlashAttention-2 backward for sm_90a at head dims between the built ones:
// the masked instances of the dQ and dK/dV kernels
// (flash_attention_bwd.cuh), in a source of their own so that they compile
// beside the full-width ones.
#include "flash_attention_bwd.cuh"

namespace ptt {
namespace flash_bwd {

cudaError_t launch_dq_masked(int dtype, const void* q, const void* k,
                             const void* v, const void* o, const void* dout,
                             const void* lse, void* delta, void* dq, int B,
                             int Nq, int Nkv, int Sq, int Sk, int hd,
                             const int* st, int causal, int q_offset,
                             float scale, cudaStream_t stream) {
  return dispatch_dtype_dim(dtype, hd, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    return launch_dq<T, decltype(dim)::value, false>(
        q, k, v, o, dout, lse, delta, dq, B, Nq, Nkv, Sq, Sk, hd, st, causal,
        q_offset, scale, stream);
  });
}

cudaError_t launch_dkv_masked(int dtype, const void* q, const void* k,
                              const void* v, const void* dout,
                              const void* lse, const void* delta, void* dk,
                              void* dv, int B, int Nq, int Nkv, int Sq,
                              int Sk, int hd, const int* st, int causal,
                              int q_offset, float scale, cudaStream_t stream) {
  return dispatch_dtype_dim(dtype, hd, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    return launch_dkv<T, decltype(dim)::value, false>(
        q, k, v, dout, lse, delta, dk, dv, B, Nq, Nkv, Sq, Sk, hd, st, causal,
        q_offset, scale, stream);
  });
}

}  // namespace flash_bwd
}  // namespace ptt
