// FlashAttention-2 backward for sm_90a: the dQ pass and the dK/dV pass.
//
// Replaces: paddle_tpu/kernels/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (launched by _bwd through two pl.pallas_calls). Same
// functions, from the forward's residuals q, k, v, o and the f32 LSE:
//   P  = exp(scale * Q K^T - LSE)        (recomputed, never stored)
//   dP = dO V^T,  Delta = rowsum(dO * O) in f32
//   dS = P * (dP - Delta) * scale, rounded to the input dtype
//   dQ = dS K,  dK = dS^T Q,  dV = round(P)^T dO   (f32 accumulation)
// with the forward's mask rules: -1e30 above the causal diagonal (query
// row i at absolute position q_offset + i) and past Sk, ragged Sq/Sk masked
// inside the kernel (no padding copies), and GQA (query head h reads KV
// head h / (Nq / Nkv); dK/dV sum over the g query heads of a KV head).
//
// Numerics kept from the TPU kernels: products of the input dtype
// accumulate in f32; P is rounded to dO's dtype before P^T dO; dS is
// rounded to the input dtype before dS K and dS^T Q; each output is
// rounded once, at the end.
//
// Dtypes: these are the f32 kernels, on the CUDA cores, whose f32 sums
// the f32 limits need. bf16 operands go to the tensor-core kernels of
// flash_attention_bwd_tc.cuh (launch_dq / launch_dkv route by dtype).
//
// What bounds it on an H100: at the training shape (B = 12, S = 1024,
// 8 heads of 128, causal) the two passes need 5 products of S x S x D per
// head, halved by the mask, against ~200 MB of traffic. These kernels
// compute in f32 on the CUDA cores (67 TFLOP/s at most), so they are
// bound by shared-memory bandwidth and FMA issue, far above that.
//
// Design. The TPU walks the reduction as a sequential ("arbitrary") grid
// dimension with the sum in VMEM scratch; here one block owns one output
// tile and walks the reduction in a loop, so no sum crosses blocks: no
// atomics, no second pass, and the result is the same from run to run.
//   dQ:  one block of 256 threads per (64-row query tile, batch * query
//        head). Its Q and dO tiles, LSE and Delta stay in shared memory;
//        K/V tiles of 64 rows stream through it, from key tile 0 up to the
//        causal diagonal (or Sk). The block also computes Delta for its
//        rows from dO and O and writes it out for the dK/dV pass, which is
//        launched after it on the same stream.
//   dKV: one block of 256 threads per (64-row key tile, batch * KV head).
//        Its K and V tiles stay in shared memory; it loops over the g query
//        heads of its group and, within each, over the query tiles from the
//        first that reaches the diagonal to the last, streaming Q, dO, LSE
//        and Delta. P^T and dS^T of a tile pass through shared memory.
// Every thread owns a 4x4 block of the 64x64 score tile and a 4 x (D/16)
// block of each f32 accumulator (dQ; or dK and dV: 2 x 32 floats at
// D = 128), so each register-resident sum is fed from shared memory at
// 2-2.7 FMAs per load. Tiles are widened to f32 once as they arrive
// (16-byte vector loads); padded row strides (D + 1, 64 + 1) keep the
// column reads free of bank conflicts. Shared memory: 149 KB (dQ) and
// 166 KB (dKV) at D = 128, so one block per SM. Head dims: any
// 0 < d <= 128, in the instance D of common.cuh: FULL at d = D
// (flash_attention_bwd.cu), masked columns past d otherwise
// (flash_attention_bwd_masked.cu).
#pragma once

#include "common.cuh"
#include "flash_attention_bwd_tc.cuh"

namespace ptt {
namespace flash_bwd {

constexpr int kB = 64;     // rows of a query or key tile
constexpr int kNT = 256;   // threads per block
constexpr int kTS = 16;    // thread grid is kTS x kTS over a 64x64 tile
constexpr int kR = kB / kTS;  // tile rows (and score columns) per thread (4)
constexpr int kPP = kB + 1;   // padded row stride of a score tile

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kB * (D + 1) + kB * kPP + 2 * kB);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * kPP + 2 * kB);
}

// rows [r0, r0 + kB) of a [S, hd] view (row stride ss) into
// dst[kB][D + 1] as f32; rows at or past S (and columns at or past hd when
// not FULL) become zeros
template <typename T, int D, bool FULL>
__device__ __forceinline__ void load_tile(const T* src, int ss, int r0, int S,
                                          int hd, float* dst) {
  constexpr int VEC = Vec<T>::N;
  for (int idx = threadIdx.x; idx < kB * (D / VEC); idx += kNT) {
    const int r = idx / (D / VEC);
    const int c = (idx % (D / VEC)) * VEC;
    float t[VEC];
    if (r0 + r < S) {
      load_cols<T, FULL>(src + (long long)(r0 + r) * ss, c, hd, t);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) t[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[r * (D + 1) + c + i] = t[i];
  }
}

// s[i][j] = sum_d A[ra + 16 i][d] * B[rb + 16 j][d] and, in the same pass,
// t[i][j] = sum_d C[ra + 16 i][d] * E[rb + 16 j][d]: the score tile and
// the dP tile (or their transposes) of one thread
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* Bm,
                                             const float* C, const float* E,
                                             int ra, int rb, float s[kR][kR],
                                             float t[kR][kR]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[kR], b[kR], c[kR], e[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      a[i] = A[(ra + i * kTS) * DP + d];
      c[i] = C[(ra + i * kTS) * DP + d];
      b[i] = Bm[(rb + i * kTS) * DP + d];
      e[i] = E[(rb + i * kTS) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        t[i][j] = fmaf(c[i], e[j], t[i][j]);
      }
  }
}

template <typename T, int D, bool FULL>
__global__ void __launch_bounds__(kNT, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int Nq,
                    int Nkv, int Sq, int Sk, int hd, int q_sb, int q_ss,
                    int q_sh,
                    int k_sb, int k_ss, int k_sh, int v_sb, int v_ss,
                    int v_sh, int o_sb, int o_ss, int o_sh, int do_sb,
                    int do_ss, int do_sh, int dq_sb, int dq_ss, int dq_sh,
                    int causal, int q_offset, float scale) {
  constexpr int DP = D + 1;
  constexpr int DPT = D / kTS;  // accumulator columns per thread
  constexpr int VEC = Vec<T>::N;
  extern __shared__ float smem[];
  float* Qs = smem;               // [kB][DP]
  float* dOs = Qs + kB * DP;      // [kB][DP]
  float* Ks = dOs + kB * DP;      // [kB][DP]
  float* Vs = Ks + kB * DP;       // [kB][DP]
  float* dSs = Vs + kB * DP;      // [kB][kPP], query rows x key columns
  float* lse_s = dSs + kB * kPP;  // [kB]
  float* del_s = lse_s + kB;      // [kB]

  const int tid = threadIdx.x;
  const int tr = tid / kTS;
  const int tc = tid % kTS;
  const int q0 = blockIdx.x * kB;
  const int b = blockIdx.y / Nq;
  const int h = blockIdx.y % Nq;
  const int hk = h / (Nq / Nkv);
  const long long row_base = ((long long)b * Nq + h) * Sq;

  const T* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const T* ob = o + (long long)b * o_sb + (long long)h * o_sh;
  const T* dob = dout + (long long)b * do_sb + (long long)h * do_sh;
  const T* kb = k + (long long)b * k_sb + (long long)hk * k_sh;
  const T* vb = v + (long long)b * v_sb + (long long)hk * v_sh;

  load_tile<T, D, FULL>(qb, q_ss, q0, Sq, hd, Qs);
  load_tile<T, D, FULL>(dob, do_ss, q0, Sq, hd, dOs);

  // Delta = rowsum(dO * O) in f32: four threads per row, each over every
  // fourth 16-byte chunk, joined by shuffles (the four are adjacent lanes)
  {
    const int r = tid / 4;
    const int part = tid % 4;
    float sum = 0.f;
    if (q0 + r < Sq) {
      for (int c = part * VEC; c < D; c += 4 * VEC) {
        float tdo[VEC], to[VEC];
        load_cols<T, FULL>(dob + (long long)(q0 + r) * do_ss, c, hd, tdo);
        load_cols<T, FULL>(ob + (long long)(q0 + r) * o_ss, c, hd, to);
#pragma unroll
        for (int i = 0; i < VEC; ++i) sum = fmaf(tdo[i], to[i], sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      del_s[r] = sum;
      lse_s[r] = q0 + r < Sq ? lse[row_base + q0 + r] : 0.f;
      if (q0 + r < Sq) delta[row_base + q0 + r] = sum;
    }
  }

  float acc[kR][DPT];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.f;

  // keys any valid row of this tile can see: all of Sk, or up to the
  // causal diagonal of its last valid row
  int kv_end = Sk;
  if (causal) kv_end = min(Sk, q_offset + min(q0 + kB, Sq));
  const int ntiles = (kv_end + kB - 1) / kB;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kB;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, FULL>(kb, k_ss, k0, Sk, hd, Ks);
    load_tile<T, D, FULL>(vb, v_ss, k0, Sk, hd, Vs);
    __syncthreads();

    float s[kR][kR], dp[kR][kR];
    two_products<D>(Qs, Ks, dOs, Vs, tr, tc, s, dp);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int rl = tr + i * kTS;
      const int row = q_offset + q0 + rl;
      const float l = lse_s[rl];
      const float dl = del_s[rl];
      const bool valid_row = q0 + rl < Sq;
#pragma unroll
      for (int jj = 0; jj < kR; ++jj) {
        const int cl = tc + jj * kTS;
        const int col = k0 + cl;
        float x = s[i][jj] * scale;
        if ((causal && col > row) || col >= Sk) x = kNegInf;
        const float p = valid_row ? expf(x - l) : 0.f;
        dSs[rl * kPP + cl] = round_to<T>(p * (dp[i][jj] - dl) * scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float ds[kR], kv[DPT];
#pragma unroll
      for (int i = 0; i < kR; ++i) ds[i] = dSs[(tr + i * kTS) * kPP + kk];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) kv[dd] = Ks[kk * DP + tc + dd * kTS];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = fmaf(ds[i], kv[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + tr + i * kTS;
    if (r >= Sq) continue;
    T* row = dq + (long long)b * dq_sb + (long long)h * dq_sh + (long long)r * dq_ss;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
      if (FULL || tc + dd * kTS < hd) row[tc + dd * kTS] = from_float<T>(acc[i][dd]);
  }
}

template <typename T, int D, bool FULL>
__global__ void __launch_bounds__(kNT, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Nq, int Nkv, int Sq, int Sk,
                     int hd, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                     int v_sb, int v_ss, int v_sh, int do_sb, int do_ss,
                     int do_sh, int dk_sb, int dk_ss, int dk_sh, int dv_sb,
                     int dv_ss, int dv_sh, int causal, int q_offset,
                     float scale) {
  constexpr int DP = D + 1;
  constexpr int DPT = D / kTS;
  extern __shared__ float smem[];
  float* Ks = smem;               // [kB][DP]
  float* Vs = Ks + kB * DP;       // [kB][DP]
  float* Qs = Vs + kB * DP;       // [kB][DP]
  float* dOs = Qs + kB * DP;      // [kB][DP]
  float* PTs = dOs + kB * DP;     // [kB][kPP], key rows x query columns
  float* dSTs = PTs + kB * kPP;   // [kB][kPP]
  float* lse_s = dSTs + kB * kPP; // [kB]
  float* del_s = lse_s + kB;      // [kB]

  const int tid = threadIdx.x;
  const int tr = tid / kTS;  // key rows tr + 16 i
  const int tc = tid % kTS;  // query columns tc + 16 j; D columns tc + 16 dd
  const int k0 = blockIdx.x * kB;
  const int b = blockIdx.y / Nkv;
  const int hk = blockIdx.y % Nkv;
  const int g = Nq / Nkv;

  const T* kb = k + (long long)b * k_sb + (long long)hk * k_sh;
  const T* vb = v + (long long)b * v_sb + (long long)hk * v_sh;
  load_tile<T, D, FULL>(kb, k_ss, k0, Sk, hd, Ks);
  load_tile<T, D, FULL>(vb, v_ss, k0, Sk, hd, Vs);

  float dk_acc[kR][DPT], dv_acc[kR][DPT];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) dk_acc[i][dd] = dv_acc[i][dd] = 0.f;

  // the first query tile whose last row reaches this key tile's first
  // column: q_offset + 64 qt + 63 >= k0
  const int nq = (Sq + kB - 1) / kB;
  const int qt0 = (causal && k0 > q_offset + kB - 1) ? (k0 - q_offset) / kB : 0;

  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    const long long row_base = ((long long)b * Nq + h) * Sq;
    const T* qb = q + (long long)b * q_sb + (long long)h * q_sh;
    const T* dob = dout + (long long)b * do_sb + (long long)h * do_sh;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D, FULL>(qb, q_ss, q0, Sq, hd, Qs);
      load_tile<T, D, FULL>(dob, do_ss, q0, Sq, hd, dOs);
      if (tid < kB) {
        const bool ok = q0 + tid < Sq;
        lse_s[tid] = ok ? lse[row_base + q0 + tid] : 0.f;
        del_s[tid] = ok ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();

      // transposed tiles: s[i][j] = S[query tc + 16 j][key tr + 16 i]
      float s[kR][kR], dp[kR][kR];
      two_products<D>(Ks, Qs, Vs, dOs, tr, tc, s, dp);
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int ql = tc + j * kTS;
        const int row = q_offset + q0 + ql;
        const float l = lse_s[ql];
        const float dl = del_s[ql];
        const bool valid_row = q0 + ql < Sq;
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const int kl = tr + i * kTS;
          const int col = k0 + kl;
          float x = s[i][j] * scale;
          if ((causal && col > row) || col >= Sk) x = kNegInf;
          const float p = valid_row ? expf(x - l) : 0.f;
          PTs[kl * kPP + ql] = round_to<T>(p);
          dSTs[kl * kPP + ql] = round_to<T>(p * (dp[i][j] - dl) * scale);
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int qq = 0; qq < kB; ++qq) {
        float pt[kR], dst[kR], dov[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          pt[i] = PTs[(tr + i * kTS) * kPP + qq];
          dst[i] = dSTs[(tr + i * kTS) * kPP + qq];
        }
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) {
          dov[dd] = dOs[qq * DP + tc + dd * kTS];
          qv[dd] = Qs[qq * DP + tc + dd * kTS];
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int dd = 0; dd < DPT; ++dd) {
            dv_acc[i][dd] = fmaf(pt[i], dov[dd], dv_acc[i][dd]);
            dk_acc[i][dd] = fmaf(dst[i], qv[dd], dk_acc[i][dd]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = k0 + tr + i * kTS;
    if (r >= Sk) continue;
    T* krow = dk + (long long)b * dk_sb + (long long)hk * dk_sh + (long long)r * dk_ss;
    T* vrow = dv + (long long)b * dv_sb + (long long)hk * dv_sh + (long long)r * dv_ss;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      if (!FULL && tc + dd * kTS >= hd) continue;
      krow[tc + dd * kTS] = from_float<T>(dk_acc[i][dd]);
      vrow[tc + dd * kTS] = from_float<T>(dv_acc[i][dd]);
    }
  }
}

template <typename T, int D, bool FULL>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, void* dq, int B, int Nq, int Nkv, int Sq,
                      int Sk, int hd, const int* st, int causal, int q_offset,
                      float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return flash_bwd_tc::launch_dq<D, FULL>(q, k, v, o, dout, lse, delta, dq,
                                            B, Nq, Nkv, Sq, Sk, hd, st, causal,
                                            q_offset, scale, stream);
  } else {
    constexpr size_t smem = dq_smem_bytes<D>();
    auto kern = flash_bwd_dq_kernel<T, D, FULL>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((Sq + kB - 1) / kB, B * Nq);
    kern<<<grid, kNT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<float*>(delta), static_cast<T*>(dq), Nq, Nkv, Sq, Sk, hd,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
        st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
        causal, q_offset, scale);
    return cudaGetLastError();
  }
}

template <typename T, int D, bool FULL>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Nq, int Nkv, int Sq,
                       int Sk, int hd, const int* st, int causal,
                       int q_offset, float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return flash_bwd_tc::launch_dkv<D, FULL>(q, k, v, dout, lse, delta, dk,
                                             dv, B, Nq, Nkv, Sq, Sk, hd, st,
                                             causal, q_offset, scale, stream);
  } else {
    constexpr size_t smem = dkv_smem_bytes<D>();
    auto kern = flash_bwd_dkv_kernel<T, D, FULL>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((Sk + kB - 1) / kB, B * Nkv);
    kern<<<grid, kNT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), Nq, Nkv, Sq, Sk, hd, st[0],
        st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
        st[11], st[12], st[13], st[14], st[15], st[16], st[17], causal,
        q_offset, scale);
    return cudaGetLastError();
  }
}

inline bool bad_args(int B, int Nq, int Nkv, int Sq, int Sk, int q_offset) {
  return B < 1 || Nq < 1 || Nkv < 1 || Nq % Nkv || Sq < 1 || Sk < 1 ||
         q_offset < 0;
}

// the masked instances (head dims between the built ones), compiled in
// flash_attention_bwd_masked.cu
cudaError_t launch_dq_masked(int dtype, const void* q, const void* k,
                             const void* v, const void* o, const void* dout,
                             const void* lse, void* delta, void* dq, int B,
                             int Nq, int Nkv, int Sq, int Sk, int hd,
                             const int* st, int causal, int q_offset,
                             float scale, cudaStream_t stream);
cudaError_t launch_dkv_masked(int dtype, const void* q, const void* k,
                              const void* v, const void* dout,
                              const void* lse, const void* delta, void* dk,
                              void* dv, int B, int Nq, int Nkv, int Sq,
                              int Sk, int hd, const int* st, int causal,
                              int q_offset, float scale, cudaStream_t stream);

}  // namespace flash_bwd
}  // namespace ptt

