// Ragged paged-attention decode for sm_90a.
//
// Replaces: paddle_tpu/kernels/paged_attention.py::_decode_kernel (launched
// by _paged_call through pl.pallas_call, called from paged_attention_decode).
// Same function: one query token per sequence attends over that sequence's
// K/V stored in fixed-size pages of a pool [num_pages, page_size, nkv, d],
// through an int32 page table [B, pages_per_seq], masked to seq_lens[b]
// (which counts the token being decoded). The g = nh / nkv query heads of
// a KV head share its pages (GQA). A sequence of length 0 is an idle batch
// slot: nothing is read and its row is a finite 0, as the TPU kernel's
// l = max(l, 1e-30) gives.
//
// Numerics kept from the TPU kernel: f32 scores scaled after the product,
// -1e30 for masked keys, an f32 online softmax per page, P rounded to V's
// dtype before P.V, O = acc / max(l, 1e-30).
//
// What bounds it on an H100: the K and V bytes of the live tokens
// (2 * seq_len * d * itemsize per sequence and KV head); the arithmetic is
// 4 * g * d FLOPs per token, far below the ridge, so the kernel is
// memory-bound. This first version is not at that bound: one block of 256
// threads per (KV head, sequence) walks that sequence's pages one after the
// other (load a page's K/V into shared memory with 16-byte vector loads,
// score, softmax, accumulate), so a block keeps only one page of loads in
// flight and B * nkv blocks (64 at decode bucket 8 with 8 KV heads) leave
// half of the 132 SMs idle. Splitting the page walk across blocks and
// merging the partial softmax states (flash-decoding) is later work.
// The page table is read inside the kernel (the TPU kernel's scalar
// prefetch), and pages past seq_len are never visited.
#include "common.cuh"

namespace ptt {
namespace {

constexpr int kNT = 256;
constexpr int kWarps = kNT / 32;

template <int D>
size_t decode_smem_bytes(int g, int ps) {
  // qs[g][D] ks[ps][D+1] vs[ps][D] ss[g][ps] accs[g][D] ms[g] ls[g]
  return sizeof(float) * ((size_t)g * D + (size_t)ps * (D + 1) +
                          (size_t)ps * D + (size_t)g * ps + (size_t)g * D +
                          2 * (size_t)g);
}

template <typename T, int D>
__global__ void __launch_bounds__(kNT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ pt,
                    const int* __restrict__ sl, T* __restrict__ out, int nh,
                    int nkv, int ps, int pps, int q_sb, int q_sh,
                    float scale) {
  constexpr int DP = D + 1;
  constexpr int VEC = Vec<T>::N;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = nh / nkv;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  extern __shared__ float smem[];
  float* qs = smem;              // [g][D]
  float* ks = qs + g * D;        // [ps][DP]
  float* vs = ks + ps * DP;      // [ps][D]
  float* ss = vs + ps * D;       // [g][ps]
  float* accs = ss + g * ps;     // [g][D]
  float* ms = accs + g * D;      // [g]
  float* ls = ms + g;            // [g]

  for (int idx = tid; idx < g * D; idx += kNT) {
    const int gi = idx / D, d = idx % D;
    qs[idx] = to_float<T>(q[(long long)b * q_sb + (long long)(h * g + gi) * q_sh + d]);
    accs[idx] = 0.f;
  }
  for (int gi = tid; gi < g; gi += kNT) {
    ms[gi] = kNegInf;
    ls[gi] = 0.f;
  }

  const int len = sl[b];
  // a length past the table's reach reads only the pages the table has
  const int npages = min((len + ps - 1) / ps, pps);
  const long long tok_stride = (long long)nkv * D;  // between a page's rows
  for (int j = 0; j < npages; ++j) {
    const long long page = pt[(long long)b * pps + j];
    const T* kpage = kp + (page * ps * nkv + h) * D;
    const T* vpage = vp + (page * ps * nkv + h) * D;
    const int base = j * ps;
    __syncthreads();  // qs/accs ready; the previous page's readers are done
    for (int idx = tid; idx < ps * (D / VEC); idx += kNT) {
      const int t = idx / (D / VEC);
      const int c = (idx % (D / VEC)) * VEC;
      float tk[VEC], tv[VEC];
      if (base + t < len) {
        load16(kpage + t * tok_stride + c, tk);
        load16(vpage + t * tok_stride + c, tv);
      } else {  // zero V past seq_len: 0 * garbage could be NaN
#pragma unroll
        for (int i = 0; i < VEC; ++i) tk[i] = tv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        ks[t * DP + c + i] = tk[i];
        vs[t * D + c + i] = tv[i];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < g * ps; idx += kNT) {
      const int gi = idx / ps, t = idx % ps;
      float a = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) a = fmaf(qs[gi * D + d], ks[t * DP + d], a);
      float x = a * scale;
      if (base + t >= len) x = kNegInf;
      ss[idx] = x;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += kWarps) {
      float* srow = ss + gi * ps;
      float mx = kNegInf;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, srow[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[gi];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      float psum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float p = expf(srow[t] - m_new);
        psum += p;
        srow[t] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float a = 0.f;
        for (int t = 0; t < ps; ++t) a = fmaf(srow[t], vs[t * D + d], a);
        accs[gi * D + d] = corr * accs[gi * D + d] + a;
      }
      if (lane == 0) {
        ms[gi] = m_new;
        ls[gi] = corr * ls[gi] + psum;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * D; idx += kNT) {
    const int gi = idx / D, d = idx % D;
    const float den = fmaxf(ls[gi], 1e-30f);
    out[((long long)b * nh + h * g + gi) * D + d] = from_float<T>(accs[idx] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* pt, const void* sl, void* out, int B, int nh,
                   int nkv, int ps, int pps, int q_sb, int q_sh, float scale,
                   cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<D>(nh / nkv, ps);
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(nkv, B);
  kern<<<grid, kNT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(pt),
      static_cast<const int*>(sl), static_cast<T*>(out), nh, nkv, ps, pps,
      q_sb, q_sh, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptt

// q is [B, nh, D] with unit stride along D (batch and head strides in
// elements); k_pages/v_pages are contiguous [num_pages, ps, nkv, D];
// page_table [B, pps] and seq_lens [B] are contiguous int32; out is a
// contiguous [B, nh, D]. Returns cudaGetLastError() after the launch.
extern "C" int ptt_paged_attention_decode(
    const void* q, const void* kp, const void* vp, const void* pt,
    const void* sl, void* out, int dtype, int B, int nh, int nkv, int D,
    int ps, int pps, int q_sb, int q_sh, float scale, void* stream) {
  using namespace ptt;
  if (B < 1 || nkv < 1 || nh % nkv || ps < 1 || pps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == kF32 && D == 64)
    e = launch<float, 64>(q, kp, vp, pt, sl, out, B, nh, nkv, ps, pps, q_sb, q_sh, scale, s);
  else if (dtype == kF32 && D == 128)
    e = launch<float, 128>(q, kp, vp, pt, sl, out, B, nh, nkv, ps, pps, q_sb, q_sh, scale, s);
  else if (dtype == kBF16 && D == 64)
    e = launch<__nv_bfloat16, 64>(q, kp, vp, pt, sl, out, B, nh, nkv, ps, pps, q_sb, q_sh, scale, s);
  else if (dtype == kBF16 && D == 128)
    e = launch<__nv_bfloat16, 128>(q, kp, vp, pt, sl, out, B, nh, nkv, ps, pps, q_sb, q_sh, scale, s);
  return static_cast<int>(e);
}
