// Ragged chunk-prefill attention over a paged KV cache, for sm_90a: the C
// entry and the kernels at the built head dims (the kernels, their design
// and their bound: paged_attention_prefill.cuh for f32,
// attention_fwd_tc.cuh for bf16).
#include "paged_attention_prefill.cuh"

// q is [B, C, nh, D] with unit stride along D (batch, row and head strides
// in elements); k_pages/v_pages are contiguous [num_pages, ps, nh, D];
// page_table is a contiguous int32 [B, pps]; out is a contiguous
// [B, C, nh, D]; q_offset points at one int32 on the device, the chunk's
// offset (>= 0; the kernels read it, so it is not checked here). D is any
// head dim 0 < D <= 128; at 16, 32, 64 and 128, q's rows and the pages are
// read with 16-byte loads and must be 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int ptt_paged_attention_prefill(
    const void* q, const void* kp, const void* vp, const void* pt, void* out,
    int dtype, int B, int C, int nh, int D, int ps, int pps, int q_sb,
    int q_ss, int q_sh, const void* q_offset, float scale, void* stream) {
  using namespace ptt;
  if (B < 1 || C < 1 || nh < 1 || ps < 1 || pps < 1 || !q_offset ||
      (long long)B * nh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(q_offset);
  if (D != instance_dim(D))
    return static_cast<int>(paged_prefill::launch_masked(
        dtype, q, kp, vp, pt, out, B, C, nh, D, ps, pps, q_sb, q_ss, q_sh,
        off, scale, s));
  return static_cast<int>(dispatch_dtype_dim(dtype, D, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    return paged_prefill::launch<T, decltype(dim)::value, true>(
        q, kp, vp, pt, out, B, C, nh, D, ps, pps, q_sb, q_ss, q_sh, off,
        scale, s);
  }));
}
