// FlashAttention-2 forward for sm_90a: the C entry and the kernel at the
// built head dims (the kernel, its design and its bound:
// flash_attention_fwd.cuh).
#include "flash_attention_fwd.cuh"

// q/k/v/o are [B, S, N, D] views with unit stride along D; the strides of
// the batch, sequence and head dims are passed in elements. D is any head
// dim 0 < D <= 128; at 16, 32, 64 and 128 the rows are read with 16-byte
// loads and must be 16-byte aligned. lse is [B, Nq, Sq] f32, contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int ptt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int Nq, int Nkv, int Sq, int Sk, int D,
    int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
    int v_sb, int v_ss, int v_sh, int o_sb, int o_ss, int o_sh,
    int causal, int q_offset, float scale, void* stream) {
  using namespace ptt;
  if (B < 1 || Nq < 1 || Nkv < 1 || Nq % Nkv || Sq < 1 || Sk < 1 ||
      q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                      v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  auto s = static_cast<cudaStream_t>(stream);
  if (D != instance_dim(D))
    return static_cast<int>(flash_fwd::launch_masked(
        dtype, q, k, v, o, lse, B, Nq, Nkv, Sq, Sk, D, st, causal, q_offset,
        scale, s));
  return static_cast<int>(dispatch_dtype_dim(dtype, D, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    return flash_fwd::launch<T, decltype(dim)::value, true>(
        q, k, v, o, lse, B, Nq, Nkv, Sq, Sk, D, st, causal, q_offset, scale,
        s);
  }));
}
