// Ragged paged-attention decode for sm_90a, the page walk split across
// blocks (flash-decoding): the kernels and their launch.
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
// -1e30 for masked keys, an f32 online softmax whose P is rounded to V's
// dtype before P.V against the running max of the state that holds it,
// O = acc / max(l, 1e-30). Only the grouping differs: the TPU kernel keeps
// one state a page walk; here each warp keeps one over its own positions,
// and the states are merged (m = max, l and acc rescaled by exp(m_i - m)
// and summed) in a fixed order, so two calls give the same bits.
//
// What bounds it on an H100: the K and V bytes of the live tokens
// (2 * seq_len * d * itemsize per sequence and KV head); the arithmetic is
// 4 * g * d FLOPs per token, far below the ridge, so it stays on the CUDA
// cores. What the design does about the bytes:
//   - The page walk of a (sequence, KV head) is split over n_split blocks,
//     grid (n_split, KV heads x head groups, B): split s takes the table's
//     pages [s * per, (s + 1) * per), per = ceil(pps / n_split). The
//     wrapper picks n_split from B, nkv, g, pps and the SM count only
//     (never from seq_lens, which live on the device), for at least two
//     blocks an SM where the pages allow. A split whose pages all lie past
//     the sequence's length reads nothing and waits for the merge.
//   - Inside a block, 4 warps take 16-position steps in turn (STEP rows:
//     a lane loads VEC = 16 bytes of each of U rows of K and of V straight
//     into registers, LPR lanes to a row), each warp with its own (m, l,
//     acc), so 4 steps of loads are in flight a block; no page is staged
//     in shared memory. The g query heads of a block's KV head read each K
//     and V row once (GQA): up to 8 heads a block, larger groups in blocks
//     of 8.
//   - The n_split blocks of a walk form a thread-block cluster (up to 8,
//     grid x). Each block merges its warps' states in shared memory; after
//     one cluster barrier, rank r merges every rank's state, in rank order,
//     for its share of the (head, column) elements, reading the other
//     blocks' shared memory, and writes O. One launch, no workspace, no
//     atomics. A split with nothing to read merges an empty state (m =
//     -1e30, l = 0, acc = 0), which adds exact zeros.
// Head dims: any 0 < d <= 128, in the instance D of common.cuh (FULL at
// d = D, rows read with 16-byte loads; masked columns past d otherwise).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace ptt {
namespace paged_decode {

constexpr int kWarps = 4;
constexpr int kNT = 32 * kWarps;
// the largest split: a portable cluster (clusters of 16, allowed on sm_90
// as non-portable, ran the bucket-4 decode in 0.0165 ms against 0.0116
// with 8 on an H100: PERF.md)
constexpr int kMaxSplit = 8;

// the query heads a block takes: the instance G >= min(g, 8)
inline int head_instance(int g) {
  return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
}

// a warp's walk: LPR lanes load one row (VEC elements each), RPI rows a
// load instruction, U instructions a step of STEP rows (the wrapper's
// _decode_step mirrors this)
template <typename T, int D, int G>
struct Walk {
  static constexpr int VEC = Vec<T>::N;
  static constexpr int LPR = D / VEC;
  static constexpr int RPI = 32 / LPR;
  static constexpr int U0 = 8 / G < 16 / RPI ? 8 / G : 16 / RPI;
  static constexpr int U = U0 < 1 ? 1 : U0;
  static constexpr int STEP = U * RPI;
};

// 16 bytes of a row at columns c.. as raw words: one 16-byte load at the
// instance's full width (src 16-byte aligned), else element by element
// with 0 at columns >= d
template <typename T, bool FULL>
__device__ __forceinline__ uint4 load_raw(const T* src, int c, int d) {
  if constexpr (FULL) {
    return __ldg(reinterpret_cast<const uint4*>(src + c));
  } else {
    uint32_t w[4];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = c + j < d ? __float_as_uint(to_float<T>(src[c + j])) : 0u;
    } else {
      const unsigned short* e = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = c + 2 * j < d ? e[c + 2 * j] : 0u;
        const uint32_t hi = c + 2 * j + 1 < d ? e[c + 2 * j + 1] : 0u;
        w[j] = lo | (hi << 16);
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the Vec<T>::N elements of 16 raw bytes, as f32
template <typename T>
__device__ __forceinline__ void widen(const uint4& v,
                                      float (&dst)[Vec<T>::N]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 4) {
      dst[j] = __uint_as_float(w[j]);
    } else {
      dst[2 * j] = __uint_as_float(w[j] << 16);
      dst[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

template <typename T, int D, bool FULL, int G>
__global__ void __launch_bounds__(kNT)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp, const int* __restrict__ pt,
                          const int* __restrict__ sl, T* __restrict__ out,
                          int nh, int nkv, int hd, int ps, int pps, int span,
                          int q_sb, int q_sh, float scale) {
  using W = Walk<T, D, G>;
  constexpr int VEC = W::VEC, LPR = W::LPR, RPI = W::RPI, U = W::U;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int g = nh / nkv;
  const int hg = (g + G - 1) / G;            // blocks a KV head's group takes
  const int h = blockIdx.y / hg;
  const int gfirst = (blockIdx.y % hg) * G;  // first head within the group
  const int nheads = min(G, g - gfirst);
  const int head0 = h * g + gfirst;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = FULL ? D : hd;              // the rows' width in memory

  // a length past the table's reach reads only the pages the table has
  const int tmax = min(sl[b], pps * ps);
  const int t0 = split * span;
  const int t1 = min(t0 + span, tmax);

  __shared__ float st_m[kWarps][G], st_l[kWarps][G];
  __shared__ float st_acc[kWarps][G][D];
  __shared__ float bl_m[G], bl_l[G], bl_acc[G][D];  // the block's state

  const int c = (lane % LPR) * VEC;          // this lane's columns
  const int rsub = lane / LPR;               // its row in a load instruction
  float qv[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      qv[gi][i] = gi < nheads && (FULL || c + i < hd)
                      ? to_float<T>(q[(long long)b * q_sb +
                                      (long long)(head0 + gi) * q_sh + c + i])
                      : 0.f;
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[gi][i] = 0.f;
  }

  const long long tok_stride = (long long)nkv * rw;  // between a page's rows
  const int nsteps = t1 > t0 ? (t1 - t0 + W::STEP - 1) / W::STEP : 0;
  for (int j = warp; j < nsteps; j += kWarps) {
    const int base = t0 + j * W::STEP;
    uint4 kr[U], vr[U];                      // raw rows, all in flight
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * RPI + rsub;
      live[u] = r < t1;
      const int rr = live[u] ? r : t0;       // a real row, read and dropped
      const long long page = __ldg(pt + (long long)b * pps + rr / ps);
      const long long off = (page * ps + rr % ps) * tok_stride +
                            (long long)h * rw;
      kr[u] = load_raw<T, FULL>(kp + off, c, rw);
      vr[u] = load_raw<T, FULL>(vp + off, c, rw);
    }
    float s[G][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      widen<T>(kr[u], kf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) a = fmaf(qv[gi][i], kf[i], a);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        s[gi][u] = live[u] ? a * scale : kNegInf;
      }
      if (!live[u]) vr[u] = make_uint4(0u, 0u, 0u, 0u);  // 0 * garbage: NaN
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float mx = s[gi][0];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[gi][u]);
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[gi], mx);
      const float corr = expf(m[gi] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[gi][i] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[gi][u] - m_new);
        psum += p;
        const float pr = round_to<T>(p);
        float vf[VEC];
        widen<T>(vr[u], vf);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[gi][i] = fmaf(pr, vf[i], acc[gi][i]);
      }
      l[gi] = corr * l[gi] + psum;
      m[gi] = m_new;
    }
  }
  // this warp's rows were spread over its RPI row groups: sum them
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], off);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[gi][i] += __shfl_xor_sync(0xffffffffu, acc[gi][i], off);
    }
  if (lane < LPR) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) st_acc[warp][gi][c + i] = acc[gi][i];
      if (lane == 0) {
        st_m[warp][gi] = m[gi];
        st_l[warp][gi] = l[gi];
      }
    }
  }
  __syncthreads();
  // the warps' states, merged in warp order
  for (int idx = threadIdx.x; idx < G * D; idx += kNT) {
    const int gi = idx / D, d = idx % D;
    if (gi >= nheads) continue;
    float mm = st_m[0][gi];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, st_m[w][gi]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(st_m[w][gi] - mm);
      ll += e * st_l[w][gi];
      aa += e * st_acc[w][gi][d];
    }
    if (nsplit == 1) {
      const long long row = (long long)b * nh + head0 + gi;
      if (FULL || d < hd) out[row * rw + d] = from_float<T>(aa / fmaxf(ll, 1e-30f));
    } else {
      bl_acc[gi][d] = aa;
      if (d == 0) {
        bl_m[gi] = mm;
        bl_l[gi] = ll;
      }
    }
  }
  if (nsplit == 1) return;
  // the splits' states, merged in rank (split) order: rank r takes the
  // elements r * kNT + tid, + kNT * nsplit, ...
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  for (int idx = split * kNT + threadIdx.x; idx < G * D;
       idx += kNT * nsplit) {
    const int gi = idx / D, d = idx % D;
    if (gi >= nheads) continue;
    float mm = kNegInf;
#pragma unroll 4
    for (int r = 0; r < nsplit; ++r)
      mm = fmaxf(mm, cluster.map_shared_rank(&bl_m[0], r)[gi]);
    float ll = 0.f, aa = 0.f;
#pragma unroll 4
    for (int r = 0; r < nsplit; ++r) {
      const float e = expf(cluster.map_shared_rank(&bl_m[0], r)[gi] - mm);
      ll += e * cluster.map_shared_rank(&bl_l[0], r)[gi];
      aa += e * cluster.map_shared_rank(&bl_acc[0][0], r)[gi * D + d];
    }
    const long long row = (long long)b * nh + head0 + gi;
    if (FULL || d < hd) out[row * rw + d] = from_float<T>(aa / fmaxf(ll, 1e-30f));
  }
  cluster.sync();                            // no block leaves while read
}

template <typename T, int D, bool FULL, int G>
cudaError_t launch_g(const void* q, const void* kp, const void* vp,
                     const void* pt, const void* sl, void* out, int B, int nh,
                     int nkv, int hd, int ps, int pps, int nsplit, int q_sb,
                     int q_sh, float scale, cudaStream_t stream) {
  const int g = nh / nkv;
  const int span = (pps + nsplit - 1) / nsplit * ps;
  auto kern = paged_decode_split_kernel<T, D, FULL, G>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, nkv * ((g + G - 1) / G), B);
  cfg.blockDim = dim3(kNT);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(pt),
      static_cast<const int*>(sl), static_cast<T*>(out), nh, nkv, hd, ps, pps,
      span, q_sb, q_sh, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int D, bool FULL>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* pt, const void* sl, void* out, int B,
                   int nh, int nkv, int hd, int ps, int pps, int nsplit,
                   int q_sb, int q_sh, float scale, cudaStream_t stream) {
  switch (head_instance(nh / nkv)) {
    case 1:
      return launch_g<T, D, FULL, 1>(q, kp, vp, pt, sl, out, B, nh, nkv,
                                     hd, ps, pps, nsplit, q_sb, q_sh, scale,
                                     stream);
    case 2:
      return launch_g<T, D, FULL, 2>(q, kp, vp, pt, sl, out, B, nh, nkv,
                                     hd, ps, pps, nsplit, q_sb, q_sh, scale,
                                     stream);
    case 4:
      return launch_g<T, D, FULL, 4>(q, kp, vp, pt, sl, out, B, nh, nkv,
                                     hd, ps, pps, nsplit, q_sb, q_sh, scale,
                                     stream);
    default:
      return launch_g<T, D, FULL, 8>(q, kp, vp, pt, sl, out, B, nh, nkv,
                                     hd, ps, pps, nsplit, q_sb, q_sh, scale,
                                     stream);
  }
}

cudaError_t launch_masked(int dtype, const void* q, const void* kp,
                          const void* vp, const void* pt, const void* sl,
                          void* out, int B, int nh, int nkv, int hd,
                          int ps, int pps, int nsplit, int q_sb, int q_sh,
                          float scale, cudaStream_t stream);

}  // namespace paged_decode
}  // namespace ptt
