// Ragged chunk-prefill attention over a paged KV cache, for sm_90a.
//
// Replaces: paddle_tpu/kernels/paged_attention.py::_prefill_kernel
// (launched by ragged_prefill_attention through pl.pallas_call). Same
// function: a chunk of C query rows of one sequence, row i at absolute
// position q_offset + i, attends the sequence's K/V through its page table
// [B, pages_per_seq] into pages [P, ps, nh, d]; row i sees the positions
// <= q_offset + i (cached prefix pages included). q_offset is a runtime
// argument, so one build serves every chunk position and every cached
// prefix length. num_heads == num_kv_heads, as in the TPU kernel.
//
// Numerics kept from the TPU kernel: S = Q K^T accumulated in f32, then
// times the scale in f32; -1e30 for masked keys; an f32 online softmax;
// P rounded to V's dtype before P.V while l sums the unrounded P;
// O = acc / max(l, 1e-30), rounded once. Padded chunk rows give finite
// values (column 0 is never masked).
//
// What bounds it on an H100: at the serving shape (C = 256, 8 heads of 128,
// page 64, offset up to 768) ~0.9 GFLOP against the K/V the chunk reaches
// (~4 MB in bf16): near the ridge, a few microseconds. This first version
// computes on the CUDA cores in f32 like the flash forward it is built
// from, so it is bound by FMA issue and shared-memory bandwidth. Design:
// one block of 128 threads per (64-row tile of the chunk, sequence * head);
// the Q tile stays in shared memory; 64-position K/V tiles are gathered
// through the page table (any page size: each row finds its page) with
// 16-byte vector loads; each thread owns a 4 x 8 block of scores and a
// 4 x (D / 8) block of the output in registers. A tile walks positions only
// up to the one its last real row can see (the TPU kernel's early-out at
// the page holding q_offset + C - 1, finer by row tile), so pages past it
// are never read. Shared pages are only read. Head dims: any 0 < d <= 128,
// in the instance D of common.cuh (FULL at d = D; masked columns past d
// otherwise).
#include "common.cuh"

namespace ptt {
namespace {

constexpr int kBQ = 64;   // chunk rows per block
constexpr int kBK = 64;   // positions per K/V tile
constexpr int kNT = 128;  // threads per block
constexpr int kTC = 8;    // threads across a row
constexpr int kRPT = kBQ / (kNT / kTC);  // rows per thread (4)
constexpr int kCPT = kBK / kTC;          // score columns per thread (8)

template <int D>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D, bool FULL>
__global__ void __launch_bounds__(kNT)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ pt,
                     T* __restrict__ o, int nh, int hd, int C, int ps,
                     int pps, int q_sb, int q_ss, int q_sh, int q_offset,
                     float scale) {
  constexpr int DP = D + 1;
  const int rw = FULL ? D : hd;  // the rows' width in memory
  constexpr int PP = kBK + 1;
  constexpr int DPT = D / kTC;  // output columns per thread
  constexpr int VEC = Vec<T>::N;
  extern __shared__ float smem[];
  float* Qs = smem;             // [kBQ][DP]
  float* Ks = Qs + kBQ * DP;    // [kBK][DP]
  float* Vs = Ks + kBK * DP;    // [kBK][D]
  float* Ps = Vs + kBK * D;     // [kBQ][PP]

  const int tid = threadIdx.x;
  const int tr = tid / kTC;
  const int tc = tid % kTC;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / nh;
  const int h = blockIdx.y % nh;
  const T* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const int* table = pt + (long long)b * pps;

  for (int idx = tid; idx < kBQ * (D / VEC); idx += kNT) {
    const int r = idx / (D / VEC);
    const int c = (idx % (D / VEC)) * VEC;
    float t[VEC];
    if (q0 + r < C) {
      load_cols<T, FULL>(qb + (long long)(q0 + r) * q_ss, c, rw, t);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) t[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) Qs[r * DP + c + i] = t[i];
  }

  float m[kRPT], l[kRPT], acc[kRPT][DPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.f;
  }

  // positions this tile can see: up to its last real row's, within the
  // table's reach
  const int kv_end = min(pps * ps, q_offset + min(q0 + kBQ, C));
  const int ntiles = (kv_end + kBK - 1) / kBK;
  const long long row_stride = (long long)nh * rw;  // between a page's rows

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * (D / VEC); idx += kNT) {
      const int r = idx / (D / VEC);
      const int c = (idx % (D / VEC)) * VEC;
      const int pos = k0 + r;
      float tk[VEC], tv[VEC];
      if (pos < kv_end) {
        const long long page = table[pos / ps];
        const long long off = (page * ps + pos % ps) * row_stride +
                              (long long)h * rw;
        load_cols<T, FULL>(kp + off, c, rw, tk);
        load_cols<T, FULL>(vp + off, c, rw, tv);
      } else {  // zero V past the last visible position: 0 * garbage
#pragma unroll
        for (int i = 0; i < VEC; ++i) tk[i] = tv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        Ks[r * DP + c + i] = tk[i];
        Vs[r * D + c + i] = tv[i];
      }
    }
    __syncthreads();

    float s[kRPT][kCPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
#pragma unroll
      for (int jj = 0; jj < kCPT; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRPT], kv[kCPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) qv[i] = Qs[(tr + i * (kNT / kTC)) * DP + d];
#pragma unroll
      for (int jj = 0; jj < kCPT; ++jj) kv[jj] = Ks[(tc + jj * kTC) * DP + d];
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
#pragma unroll
        for (int jj = 0; jj < kCPT; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int rl = tr + i * (kNT / kTC);
      const int row = q_offset + q0 + rl;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kCPT; ++jj) {
        const int col = k0 + tc + jj * kTC;
        float x = s[i][jj] * scale;
        if (col > row || col >= kv_end) x = kNegInf;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      // the 8 threads of a row are 8 consecutive lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kCPT; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        psum += p;
        Ps[rl * PP + tc + jj * kTC] = round_to<T>(p);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      m[i] = m_new;
      l[i] = corr * l[i] + psum;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[i][dd] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) pv[i] = Ps[(tr + i * (kNT / kTC)) * PP + kk];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) vv[dd] = Vs[kk * D + tc + dd * kTC];
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = fmaf(pv[i], vv[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int r = q0 + tr + i * (kNT / kTC);
    if (r >= C) continue;
    T* orow = o + (((long long)b * C + r) * nh + h) * rw;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (FULL || tc + j * kTC < rw)
        orow[tc + j * kTC] = from_float<T>(acc[i][j] / den);
  }
}

template <typename T, int D, bool FULL>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* pt, void* o, int B, int C, int nh, int hd,
                   int ps, int pps, int q_sb, int q_ss, int q_sh,
                   int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes<D>();
  auto kern = paged_prefill_kernel<T, D, FULL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((C + kBQ - 1) / kBQ, B * nh);
  kern<<<grid, kNT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(pt),
      static_cast<T*>(o), nh, hd, C, ps, pps, q_sb, q_ss, q_sh, q_offset,
      scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptt

// q is [B, C, nh, D] with unit stride along D (batch, row and head strides
// in elements); k_pages/v_pages are contiguous [num_pages, ps, nh, D];
// page_table is a contiguous int32 [B, pps]; out is a contiguous
// [B, C, nh, D]. D is any head dim 0 < D <= 128; at 16, 32, 64 and 128,
// q's rows and the pages are read with 16-byte loads and must be 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int ptt_paged_attention_prefill(
    const void* q, const void* kp, const void* vp, const void* pt, void* out,
    int dtype, int B, int C, int nh, int D, int ps, int pps, int q_sb,
    int q_ss, int q_sh, int q_offset, float scale, void* stream) {
  using namespace ptt;
  if (B < 1 || C < 1 || nh < 1 || ps < 1 || pps < 1 || q_offset < 0 ||
      (long long)B * nh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const bool full = D == instance_dim(D);
  return static_cast<int>(dispatch_dtype_dim(dtype, D, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    constexpr int kD = decltype(dim)::value;
    return full ? launch<T, kD, true>(q, kp, vp, pt, out, B, C, nh, D, ps,
                                      pps, q_sb, q_ss, q_sh, q_offset, scale,
                                      s)
                : launch<T, kD, false>(q, kp, vp, pt, out, B, C, nh, D, ps,
                                       pps, q_sb, q_ss, q_sh, q_offset,
                                       scale, s);
  }));
}
