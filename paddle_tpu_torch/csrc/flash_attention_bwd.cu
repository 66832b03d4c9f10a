// FlashAttention-2 backward for sm_90a: the C entries of the dQ and dK/dV
// passes and their kernels at the built head dims (the kernels, their
// design and their bound: flash_attention_bwd.cuh).
#include "flash_attention_bwd.cuh"

// The dQ pass. q/o/dout/dq are [B, Sq, Nq, D] and k/v [B, Sk, Nkv, D]
// views with unit stride along D; the strides of the batch, sequence and
// head dims are passed in elements. D is any head dim 0 < D <= 128; at 16,
// 32, 64 and 128 the rows are read with 16-byte loads and must be 16-byte
// aligned. lse (read) and delta (written) are [B, Nq, Sq] f32, contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int ptt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, int dtype,
    int B, int Nq, int Nkv, int Sq, int Sk, int D, int q_sb, int q_ss,
    int q_sh, int k_sb, int k_ss, int k_sh, int v_sb, int v_ss, int v_sh,
    int o_sb, int o_ss, int o_sh, int do_sb, int do_ss, int do_sh, int dq_sb,
    int dq_ss, int dq_sh, int causal, int q_offset, float scale,
    void* stream) {
  using namespace ptt;
  if (flash_bwd::bad_args(B, Nq, Nkv, Sq, Sk, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const int st[18] = {q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,
                      v_sb,  v_ss,  v_sh,  o_sb,  o_ss,  o_sh,
                      do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh};
  auto s = static_cast<cudaStream_t>(stream);
  if (D != instance_dim(D))
    return static_cast<int>(flash_bwd::launch_dq_masked(
        dtype, q, k, v, o, dout, lse, delta, dq, B, Nq, Nkv, Sq, Sk, D, st,
        causal, q_offset, scale, s));
  return static_cast<int>(dispatch_dtype_dim(dtype, D, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    return flash_bwd::launch_dq<T, decltype(dim)::value, true>(
        q, k, v, o, dout, lse, delta, dq, B, Nq, Nkv, Sq, Sk, D, st, causal,
        q_offset, scale, s);
  }));
}

// The dK/dV pass, after the dQ pass on the same stream (it reads the delta
// that pass wrote). q/dout are [B, Sq, Nq, D]; k/v/dk/dv [B, Sk, Nkv, D];
// strides as above; lse and delta [B, Nq, Sq] f32, contiguous.
extern "C" int ptt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int Nq, int Nkv, int Sq, int Sk, int D, int q_sb, int q_ss, int q_sh,
    int k_sb, int k_ss, int k_sh, int v_sb, int v_ss, int v_sh, int do_sb,
    int do_ss, int do_sh, int dk_sb, int dk_ss, int dk_sh, int dv_sb,
    int dv_ss, int dv_sh, int causal, int q_offset, float scale,
    void* stream) {
  using namespace ptt;
  if (flash_bwd::bad_args(B, Nq, Nkv, Sq, Sk, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const int st[18] = {q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,
                      v_sb,  v_ss,  v_sh,  do_sb, do_ss, do_sh,
                      dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh};
  auto s = static_cast<cudaStream_t>(stream);
  if (D != instance_dim(D))
    return static_cast<int>(flash_bwd::launch_dkv_masked(
        dtype, q, k, v, dout, lse, delta, dk, dv, B, Nq, Nkv, Sq, Sk, D, st,
        causal, q_offset, scale, s));
  return static_cast<int>(dispatch_dtype_dim(dtype, D, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    return flash_bwd::launch_dkv<T, decltype(dim)::value, true>(
        q, k, v, dout, lse, delta, dk, dv, B, Nq, Nkv, Sq, Sk, D, st, causal,
        q_offset, scale, s);
  }));
}
