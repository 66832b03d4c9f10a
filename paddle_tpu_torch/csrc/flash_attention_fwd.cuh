// FlashAttention-2 forward for sm_90a.
//
// Replaces: paddle_tpu/kernels/flash_attention.py::_fwd_kernel (launched by
// _fwd through pl.pallas_call). Same function: O = softmax(scale * Q K^T) V
// with an online softmax over K/V tiles, O in the input dtype and the f32
// log-sum-exp LSE = m + log(l); a causal mask with an integer q_offset
// (query row i sits at absolute position q_offset + i), ragged Sq/Sk masked
// inside the kernel (no padding copies), and GQA (query head h reads KV
// head h / (Nq / Nkv)).
//
// Numerics kept from the TPU kernel: products of the input dtype accumulate
// in f32, the scale multiplies the f32 product, masked scores are -1e30,
// P is rounded to V's dtype before P.V while l sums the unrounded P, and
// O = acc / l.
//
// Dtypes: this is the f32 kernel, on the CUDA cores, whose f32 products
// the f32 limits need. bf16 operands go to the tensor cores (launch routes
// by dtype): the wgmma kernel of flash_attention_fwd_wg.cu where TMA can
// describe q, k and v, else the mma.sync kernel of attention_fwd_tc.cuh
// (the rule: attention_wg.cuh); those files hold the bf16 bound and design.
//
// What bounds it on an H100: at the serving shapes (S <= 1024, d = 128,
// 8 heads, batch 1) the causal work is ~2 GFLOP against ~8 MB of traffic,
// so the ideal kernel sits near the memory/compute ridge (a few us). This
// kernel computes in f32 on the CUDA cores (67 TFLOP/s at most), so it
// is bound by shared-memory bandwidth and FMA issue, far above that bound.
// Its design: one block of 128 threads per (64-row query tile, batch*head);
// the Q tile stays in shared memory; K/V tiles of 64 rows stream through
// shared memory (16-byte vector loads, widened to f32 once); each thread
// owns a 4x8 block of scores and a 4x(D/8) block of the output
// accumulator in registers, so every shared-memory read feeds 2.7 (QK^T)
// or 3.2 (PV) FMAs; the row max and sum reduce with warp shuffles across
// the 8 threads that share a row; key tiles wholly above the causal
// diagonal or past Sk are never visited. Padded row strides (D + 1) keep
// the column reads free of bank conflicts. Head dims: any 0 < d <= 128, in
// the instance D of common.cuh: FULL at d = D (flash_attention_fwd.cu),
// masked columns past d otherwise (flash_attention_fwd_masked.cu).
#pragma once

#include <type_traits>

#include "attention_fwd_tc.cuh"
#include "attention_wg.cuh"
#include "common.cuh"

namespace ptt {
namespace flash_fwd {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // key rows per tile
constexpr int kNT = 128;  // threads per block
constexpr int kTC = 8;    // threads across a row
constexpr int kRPT = kBQ / (kNT / kTC);  // rows per thread (4)
constexpr int kCPT = kBK / kTC;          // score columns per thread (8)

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D, bool FULL>
__global__ void __launch_bounds__(kNT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Nq, int Nkv, int Sq, int Sk,
                 int hd,
                 int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                 int v_sb, int v_ss, int v_sh, int o_sb, int o_ss, int o_sh,
                 int causal, int q_offset, float scale) {
  constexpr int DP = D + 1;
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
  const int b = blockIdx.y / Nq;
  const int h = blockIdx.y % Nq;
  const int hk = h / (Nq / Nkv);

  const T* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const T* kb = k + (long long)b * k_sb + (long long)hk * k_sh;
  const T* vb = v + (long long)b * v_sb + (long long)hk * v_sh;

  for (int idx = tid; idx < kBQ * (D / VEC); idx += kNT) {
    const int r = idx / (D / VEC);
    const int c = (idx % (D / VEC)) * VEC;
    float t[VEC];
    if (q0 + r < Sq) {
      load_cols<T, FULL>(qb + (long long)(q0 + r) * q_ss, c, hd, t);
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

  // keys this tile can see: all of Sk, or up to the causal diagonal of its
  // last row (q_offset + q0 + kBQ - 1)
  int kv_end = Sk;
  if (causal) kv_end = min(Sk, q_offset + q0 + kBQ);
  const int ntiles = (kv_end + kBK - 1) / kBK;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * (D / VEC); idx += kNT) {
      const int r = idx / (D / VEC);
      const int c = (idx % (D / VEC)) * VEC;
      float tk[VEC], tv[VEC];
      if (k0 + r < Sk) {
        load_cols<T, FULL>(kb + (long long)(k0 + r) * k_ss, c, hd, tk);
        load_cols<T, FULL>(vb + (long long)(k0 + r) * v_ss, c, hd, tv);
      } else {  // zero V past Sk: 0 * garbage could be NaN
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
        if ((causal && col > row) || col >= Sk) x = kNegInf;
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
    if (r >= Sq) continue;
    T* orow = o + (long long)b * o_sb + (long long)h * o_sh + (long long)r * o_ss;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
      if (FULL || tc + dd * kTC < hd)
        orow[tc + dd * kTC] = from_float<T>(acc[i][dd] / l[i]);
    if (tc == 0) lse[((long long)b * Nq + h) * Sq + r] = m[i] + logf(l[i]);
  }
}

template <typename T, int D, bool FULL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Nq, int Nkv, int Sq, int Sk, int hd,
                   const int* st, int causal, int q_offset, float scale,
                   cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const void* views[3] = {q, k, v};
    if (attn_wg::takes(views, st, 3))
      return attn_wg::launch_fwd(q, k, v, o, lse, B, Nq, Nkv, Sq, Sk, hd, st,
                                 causal, q_offset, scale, stream);
    return attn_fwd_tc::launch_flash<D, FULL>(q, k, v, o, lse, B, Nq, Nkv,
                                              Sq, Sk, hd, st, causal,
                                              q_offset, scale, stream);
  } else {
    constexpr size_t smem = flash_smem_bytes<D>();
    auto kern = flash_fwd_kernel<T, D, FULL>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((Sq + kBQ - 1) / kBQ, B * Nq);
    kern<<<grid, kNT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), Nq, Nkv, Sq, Sk, hd, st[0], st[1], st[2],
        st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
        causal, q_offset, scale);
    return cudaGetLastError();
  }
}

// the masked instances (head dims between the built ones), compiled in
// flash_attention_fwd_masked.cu
cudaError_t launch_masked(int dtype, const void* q, const void* k,
                          const void* v, void* o, void* lse, int B, int Nq,
                          int Nkv, int Sq, int Sk, int hd, const int* st,
                          int causal, int q_offset, float scale,
                          cudaStream_t stream);

}  // namespace flash_fwd
}  // namespace ptt

