// Ragged paged-attention decode for sm_90a: the C entry and the kernels at
// the built head dims (the kernels, their design and their bound:
// paged_attention_decode.cuh).
#include "paged_attention_decode.cuh"

// q is [B, nh, D] with unit stride along D (batch and head strides in
// elements); k_pages/v_pages are contiguous [num_pages, ps, nkv, D];
// page_table [B, pps] and seq_lens [B] are contiguous int32; out is a
// contiguous [B, nh, D]; each walk is split over nsplit blocks (1 to
// min(pps, 8)). D is any head dim 0 < D <= 128; at 16, 32, 64 and 128 the
// pages are read with 16-byte loads and must be 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int ptt_paged_attention_decode(
    const void* q, const void* kp, const void* vp, const void* pt,
    const void* sl, void* out, int dtype, int B, int nh, int nkv, int D,
    int ps, int pps, int nsplit, int q_sb, int q_sh, float scale,
    void* stream) {
  using namespace ptt;
  if (B < 1 || B > 65535 || nkv < 1 || nh % nkv || ps < 1 || pps < 1 ||
      nsplit < 1 || nsplit > pps || nsplit > paged_decode::kMaxSplit ||
      (long long)nkv * ((nh / nkv + 7) / 8) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (D != instance_dim(D))
    return static_cast<int>(paged_decode::launch_masked(
        dtype, q, kp, vp, pt, sl, out, B, nh, nkv, D, ps, pps, nsplit,
        q_sb, q_sh, scale, s));
  return static_cast<int>(dispatch_dtype_dim(dtype, D, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    return paged_decode::launch<T, decltype(dim)::value, true>(
        q, kp, vp, pt, sl, out, B, nh, nkv, D, ps, pps, nsplit, q_sb,
        q_sh, scale, s);
  }));
}
