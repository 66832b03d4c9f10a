// Weight-only int8 dequant-matmul for sm_90a.
//
// Replaces: paddle_tpu/kernels/int8_matmul.py::_mm_kernel (launched by
// int8_matmul through pl.pallas_call). Same function:
// out[M, N] = round_to_T((x[M, K] . float(w)) * scale[N]), x in f32 or
// bf16, w int8, scale f32: the products accumulate in f32, the f32
// per-column scale multiplies the f32 sum, and the result is rounded once
// to x's dtype.
//
// Two layouts of w, as the serving engine stores its weights:
//   "kn": w[K, N], contiguous along N (wqkv, wo, w1, w2);
//   "nk": w[N, K], contiguous along K (the logits against wte[V, H]).
//
// What bounds it on an H100: at decode (M <= 8) the int8 weight bytes, one
// read of K * N bytes against 2 * M * K * N operations, far below the
// ridge: a weight-streaming kernel. What the design does about it:
//   - One pass, every load of a walk in flight: each lane issues all of
//     its 16-byte weight loads for U steps of K into registers before it
//     uses the first, so a warp's walk costs one DRAM latency per U steps.
//   - Filling the card: a block of 4 warps owns 128 output columns ("kn";
//     its warps split K) or 64 ("nk"; one 16-column tile a warp) and 8 or
//     16 rows of x. Where those tiles are fewer than the card needs, K is
//     split further across the blocks of a thread-block cluster (up to 8,
//     grid x), and the cluster sums its partial tiles through distributed
//     shared memory in rank order. No atomics, no workspace, nothing
//     outlives a launch, and two calls give the same bits.
//   - bf16 x on the tensor cores: out^T = W^T . x^T with mma.sync
//     m16n8k16 (16 weight columns on the m16 side, 8 rows of x on n8), so
//     decode pads nothing; M > 8 takes 16 rows a block (two n8 tiles). The
//     int8 weight is widened to bf16 in registers, exactly (every int8 is
//     a bf16): a byte is placed in the mantissa of 2^23 (prmt), 2^23 + 128
//     subtracted, and the high half of the f32 taken. No shared memory
//     holds the weight: K is a sum, so the kernel assigns each lane's
//     fragment slots to the bytes its own 16-byte loads bring (the same K
//     order for x's fragments, which are read from global memory, L1
//     resident): "nk" lane (g, t) loads 16 bytes of weight rows g and
//     g + 8 at K offset 16 t of each 64-deep chunk, which feed 4 steps;
//     "kn" lane (g, t) loads K rows 4 t .. 4 t + 3 of a 16-deep step at
//     columns 16 g .. 16 g + 15, which feed the fragments of 8 column
//     tiles (tile i: rows 16 g + 2 i and + 1).
//   - f32 x keeps CUDA-core FMAs (the same one-pass, cluster-reduced
//     structure): x is read into registers once for the 2 ("nk") or 16
//     ("kn") weights it multiplies.
// Ragged M, N and K are masked in the kernel; a weight that is not 16-byte
// aligned along its contiguous axis is read byte by byte, and x with a row
// stride that is not 16-byte aligned element by element.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "tensor_core.cuh"

namespace ptt {
namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kNT = 32 * kWarps;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kKN = 0, kNK = 1;

template <int LAYOUT>
struct Tile {
  static constexpr int BN = LAYOUT == kKN ? 128 : 16 * kWarps;  // columns
  static constexpr int WK = LAYOUT == kKN ? kWarps : 1;  // warps across K
  static constexpr int KU = LAYOUT == kKN ? 16 : 64;     // K of one unit
};

// 16 int8 at src as raw bytes; bytes at or past `valid` read as 0; vec:
// src is 16-byte aligned
__device__ __forceinline__ uint4 load_w16(const int8_t* src, bool vec,
                                          int valid) {
  if (vec && valid >= 16) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < valid)
      w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[i]))
                  << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void to_words(uint4 v, uint32_t (&w)[4]) {
  // the sign bit of each byte flipped: byte = v + 128 as an unsigned
  w[0] = v.x ^ 0x80808080u;
  w[1] = v.y ^ 0x80808080u;
  w[2] = v.z ^ 0x80808080u;
  w[3] = v.w ^ 0x80808080u;
}

// byte b of a flipped word as the f32 value of the int8, exactly:
// 2^23 + (v + 128) - (2^23 + 128)
__device__ __forceinline__ float s8(uint32_t word, int b) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | b)) -
         8388736.f;
}

// two f32 that are bf16 values (integers of at most 8 bits) as a bf16x2
// word, lo in the low half: their high halves, exactly
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t bits16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// x[m][k .. k + 3] (bf16) as two bf16x2 words; 0 past M or K
__device__ __forceinline__ void load_x4(const __nv_bfloat16* x, int xs, int M,
                                        int K, int m, int k, bool xvec,
                                        uint32_t& b0, uint32_t& b1) {
  b0 = b1 = 0u;
  if (m >= M) return;
  const __nv_bfloat16* p = x + (long long)m * xs + k;
  if (xvec && k + 3 < K) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    b0 = v.x;
    b1 = v.y;
    return;
  }
  uint32_t e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = k + i < K ? bits16(p + i) : 0u;
  b0 = e[0] | (e[1] << 16);
  b1 = e[2] | (e[3] << 16);
}

// x[m][k .. k + 15] (bf16) as 8 bf16x2 words; 0 past M or K
__device__ __forceinline__ void load_x16(const __nv_bfloat16* x, int xs,
                                         int M, int K, int m, int k,
                                         bool xvec, uint32_t (&w)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = 0u;
  if (m >= M) return;
  const __nv_bfloat16* p = x + (long long)m * xs + k;
  if (xvec && k + 15 < K) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p + 8));
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t lo = k + 2 * i < K ? bits16(p + 2 * i) : 0u;
    const uint32_t hi = k + 2 * i + 1 < K ? bits16(p + 2 * i + 1) : 0u;
    w[i] = lo | (hi << 16);
  }
}

// ------------------------------------------------------ bf16, tensor cores

// "kn": this warp's partial [MT * 8][128] tile over its K units (unit =
// 16 K rows; the warp takes units ubeg + wk, + kWarps, ... below uend)
template <int MT>
__device__ __forceinline__ void kn_bf16(const __nv_bfloat16* x,
                                        const int8_t* w, float* part, int M,
                                        int N, int K, int xs, int m0, int n0,
                                        int ubeg, int uend, bool vec,
                                        bool xvec) {
  constexpr int U = MT == 1 ? 4 : 2;   // K units a lane loads at once
  const int lane = threadIdx.x & 31, wk = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nb = n0 + 16 * g;          // this lane's 16 columns
  float acc[8][MT][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][mt][e] = 0.f;

  for (int u0 = ubeg + wk; u0 < uend; u0 += kWarps * U) {
    uint4 raw[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int unit = u0 + u * kWarps;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = unit * 16 + 4 * t + j;
        raw[u][j] = unit < uend && k < K
                        ? load_w16(w + (long long)k * N + nb, vec, N - nb)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int unit = u0 + u * kWarps;
      if (unit >= uend) break;
      const int kb = unit * 16 + 4 * t;
      uint32_t b0[MT], b1[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_x4(x, xs, M, K, m0 + mt * 8 + g, kb, xvec, b0[mt], b1[mt]);
      uint32_t r[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) to_words(raw[u][j], r[j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // tile i: fragment row g is column 16 g + 2 i, row g + 8 the next;
        // fragment k 2t, 2t + 1 are K rows 4t, 4t + 1, k 2t + 8, 2t + 9
        // the rows 4t + 2, 4t + 3
        const int wi = i >> 1, lo = 2 * (i & 1);
        uint32_t a[4];
        a[0] = bf16x2(s8(r[0][wi], lo), s8(r[1][wi], lo));
        a[1] = bf16x2(s8(r[0][wi], lo + 1), s8(r[1][wi], lo + 1));
        a[2] = bf16x2(s8(r[2][wi], lo), s8(r[3][wi], lo));
        a[3] = bf16x2(s8(r[2][wi], lo + 1), s8(r[3][wi], lo + 1));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tc::mma_bf16(acc[i][mt], a, b0[mt], b1[mt]);
      }
    }
  }
  float* p = part + wk * (MT * 8 * 128);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = mt * 8 + 2 * t, n = 16 * g + 2 * i;
      p[m * 128 + n] = acc[i][mt][0];
      p[(m + 1) * 128 + n] = acc[i][mt][1];
      p[m * 128 + n + 1] = acc[i][mt][2];
      p[(m + 1) * 128 + n + 1] = acc[i][mt][3];
    }
}

// "nk": this warp's 16 columns (weight rows) of the partial [MT * 8][64]
// tile over the block's K units (unit = a 64-deep chunk)
template <int MT>
__device__ __forceinline__ void nk_bf16(const __nv_bfloat16* x,
                                        const int8_t* w, float* part, int M,
                                        int N, int K, int xs, int m0, int n0,
                                        int ubeg, int uend, bool vec,
                                        bool xvec) {
  constexpr int U = 2;                 // chunks a lane loads at once
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = n0 + 16 * wn + g, rb = ra + 8;
  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

  for (int u0 = ubeg; u0 < uend; u0 += U) {
    uint4 ka[U], kb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = (u0 + u) * 64 + 16 * t;
      const bool live = u0 + u < uend;
      ka[u] = live && ra < N ? load_w16(w + (long long)ra * K + k, vec, K - k)
                             : make_uint4(0u, 0u, 0u, 0u);
      kb[u] = live && rb < N ? load_w16(w + (long long)rb * K + k, vec, K - k)
                             : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u0 + u >= uend) break;
      const int k = (u0 + u) * 64 + 16 * t;
      uint32_t xw[MT][8];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_x16(x, xs, M, K, m0 + mt * 8 + g, k, xvec, xw[mt]);
      uint32_t wa[4], wb[4];
      to_words(ka[u], wa);
      to_words(kb[u], wb);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // step s: fragment k 2t, 2t + 1 are bytes 4s, 4s + 1 of this
        // lane's 16, k 2t + 8, 2t + 9 the bytes 4s + 2, 4s + 3
        uint32_t a[4];
        a[0] = bf16x2(s8(wa[s], 0), s8(wa[s], 1));
        a[1] = bf16x2(s8(wb[s], 0), s8(wb[s], 1));
        a[2] = bf16x2(s8(wa[s], 2), s8(wa[s], 3));
        a[3] = bf16x2(s8(wb[s], 2), s8(wb[s], 3));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tc::mma_bf16(acc[mt], a, xw[mt][2 * s], xw[mt][2 * s + 1]);
      }
    }
  }
  constexpr int BN = Tile<kNK>::BN;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = mt * 8 + 2 * t, n = 16 * wn + g;
    part[m * BN + n] = acc[mt][0];
    part[(m + 1) * BN + n] = acc[mt][1];
    part[m * BN + n + 8] = acc[mt][2];
    part[(m + 1) * BN + n + 8] = acc[mt][3];
  }
}

// ------------------------------------------------------- f32, CUDA cores

// x[m][k] for the 8 rows of a tile; 0 past M or K
__device__ __forceinline__ float x_at(const float* x, int xs, int M, int K,
                                      int m, int k) {
  return m < M && k < K ? __ldg(x + (long long)m * xs + k) : 0.f;
}

// "kn": lane (cg = lane % 8, kl = lane / 8) takes columns 16 cg .. + 15 of
// the warp's 128 and K rows 4 kl .. 4 kl + 3 of each 16-deep unit
__device__ __forceinline__ void kn_f32(const float* x, const int8_t* w,
                                       float* part, int M, int N, int K,
                                       int xs, int m0, int n0, int ubeg,
                                       int uend, bool vec) {
  const int lane = threadIdx.x & 31, wk = threadIdx.x >> 5;
  const int cg = lane & 7, kl = lane >> 3;
  const int nb = n0 + 16 * cg;
  float acc[8][16];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[m][i] = 0.f;
  for (int unit = ubeg + wk; unit < uend; unit += kWarps) {
    uint4 raw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = unit * 16 + 4 * kl + j;
      raw[j] = k < K ? load_w16(w + (long long)k * N + nb, vec, N - nb)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = unit * 16 + 4 * kl + j;
      uint32_t r[4];
      to_words(raw[j], r);
      float xv[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) xv[m] = x_at(x, xs, M, K, m0 + m, k);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float wv = s8(r[i / 4], i % 4);
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[m][i] = fmaf(xv[m], wv, acc[m][i]);
      }
    }
  }
  // the 4 k-lanes of a column group: lanes cg, cg + 8, cg + 16, cg + 24
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float v = acc[m][i];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][i] = v;
    }
  if (lane < 8) {
    float* p = part + wk * (8 * 128);
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int i = 0; i < 16; ++i) p[m * 128 + 16 * cg + i] = acc[m][i];
  }
}

// "nk": lane (g, t) takes weight rows g and g + 8 of the warp's 16 and
// the 16 bytes at K offset 16 t of each 64-deep unit
__device__ __forceinline__ void nk_f32(const float* x, const int8_t* w,
                                       float* part, int M, int N, int K,
                                       int xs, int m0, int n0, int ubeg,
                                       int uend, bool vec, bool xvec) {
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = n0 + 16 * wn + g, rb = ra + 8;
  float acc[2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[r][m] = 0.f;
  for (int u0 = ubeg; u0 < uend; u0 += 2) {
    uint4 raw[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = (u0 + u) * 64 + 16 * t;
      const bool live = u0 + u < uend;
      raw[u][0] = live && ra < N
                      ? load_w16(w + (long long)ra * K + k, vec, K - k)
                      : make_uint4(0u, 0u, 0u, 0u);
      raw[u][1] = live && rb < N
                      ? load_w16(w + (long long)rb * K + k, vec, K - k)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u0 + u >= uend) break;
      const int k = (u0 + u) * 64 + 16 * t;
      uint32_t wa[4], wb[4];
      to_words(raw[u][0], wa);
      to_words(raw[u][1], wb);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float xv[16];
        const int row = m0 + m;
        if (xvec && row < M && k + 15 < K) {
          const float4* p =
              reinterpret_cast<const float4*>(x + (long long)row * xs + k);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = __ldg(p + q);
            xv[4 * q] = v.x;
            xv[4 * q + 1] = v.y;
            xv[4 * q + 2] = v.z;
            xv[4 * q + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) xv[i] = x_at(x, xs, M, K, row, k + i);
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          acc[0][m] = fmaf(xv[i], s8(wa[i / 4], i % 4), acc[0][m]);
          acc[1][m] = fmaf(xv[i], s8(wb[i / 4], i % 4), acc[1][m]);
        }
      }
    }
  }
  // the 4 lanes t of a row pair
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      float v = acc[r][m];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      acc[r][m] = v;
    }
  if (t == 0) {
    constexpr int BN = Tile<kNK>::BN;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      part[m * BN + 16 * wn + g] = acc[0][m];
      part[m * BN + 16 * wn + g + 8] = acc[1][m];
    }
  }
}

// ------------------------------------------------------------- the kernel

// grid (cluster size, column tiles, row tiles), cluster (gridDim.x, 1, 1):
// the blocks of a cluster split K; each sums its warps' partial tiles in
// shared memory, then rank r sums every rank's tile, in rank order, at the
// elements of its share of the tile (reading the other ranks' shared
// memory), and writes them out. (Gathering every tile into rank 0 instead,
// with one cluster barrier, took 0.6-1.5 us longer at the "kn" decode
// shapes on an H100: PERF.md.)
template <typename T, int LAYOUT, int MT>
__global__ void __launch_bounds__(kNT)
int8_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, T* __restrict__ out, int M,
               int N, int K, int xs, int vec, int xvec) {
  using TL = Tile<LAYOUT>;
  constexpr int ROWS = 8 * MT;
  constexpr int TILE = ROWS * TL::BN;
  extern __shared__ float part[];      // [TL::WK][ROWS][TL::BN]
  const int cs = gridDim.x;
  const int rank = blockIdx.x;
  const int n0 = blockIdx.y * TL::BN;
  const int m0 = blockIdx.z * ROWS;
  const int units = (K + TL::KU - 1) / TL::KU;
  const int per = (units + cs - 1) / cs;
  const int ubeg = min(units, rank * per);
  const int uend = min(units, ubeg + per);

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if constexpr (LAYOUT == kKN)
      kn_bf16<MT>(x, w, part, M, N, K, xs, m0, n0, ubeg, uend, vec, xvec);
    else
      nk_bf16<MT>(x, w, part, M, N, K, xs, m0, n0, ubeg, uend, vec, xvec);
  } else {
    static_assert(MT == 1, "f32 x takes 8 rows a block");
    if constexpr (LAYOUT == kKN)
      kn_f32(x, w, part, M, N, K, xs, m0, n0, ubeg, uend, vec);
    else
      nk_f32(x, w, part, M, N, K, xs, m0, n0, ubeg, uend, vec, xvec);
  }
  __syncthreads();
  if constexpr (TL::WK > 1) {          // the warps' partials, in warp order
    for (int e = threadIdx.x; e < TILE; e += kNT) {
      float v = part[e];
#pragma unroll
      for (int wk = 1; wk < TL::WK; ++wk) v += part[wk * TILE + e];
      part[e] = v;
    }
  }
  if (cs == 1) {   // each thread writes the elements it summed
    for (int e = threadIdx.x; e < TILE; e += kNT) {
      const int m = e / TL::BN, n = e % TL::BN;
      if (m0 + m < M && n0 + n < N)
        out[(long long)(m0 + m) * N + n0 + n] =
            from_float<T>(part[e] * scale[n0 + n]);
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                      // every rank's tile is summed
  for (int e = rank * kNT + threadIdx.x; e < TILE; e += kNT * cs) {
    float pr[kMaxCluster];             // every rank's read in flight at once
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      pr[r] = r < cs ? cluster.map_shared_rank(part, r)[e] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < cs) v += pr[r];
    const int m = e / TL::BN, n = e % TL::BN;
    if (m0 + m < M && n0 + n < N)
      out[(long long)(m0 + m) * N + n0 + n] = from_float<T>(v * scale[n0 + n]);
  }
  cluster.sync();                      // no block leaves while others read
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!cached[dev]) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n < 1)
      return 132;
    cached[dev] = n;
  }
  return cached[dev];
}

template <typename T, int LAYOUT, int MT>
cudaError_t launch(const void* x, const void* w, const void* s, void* out,
                   int M, int N, int K, int xs, int vec, int xvec,
                   cudaStream_t stream) {
  using TL = Tile<LAYOUT>;
  const int mtiles = (M + 8 * MT - 1) / (8 * MT);
  const int ntiles = (N + TL::BN - 1) / TL::BN;
  const int units = (K + TL::KU - 1) / TL::KU;
  // split K across a cluster while the tiles give fewer than two blocks an
  // SM, keeping at least one unit for each warp across K
  const long long tiles = (long long)mtiles * ntiles;
  int cs = (int)std::min<long long>(
      kMaxCluster, (2LL * sm_count() + tiles - 1) / tiles);
  cs = std::max(1, std::min(cs, units / TL::WK));
  const size_t smem = sizeof(float) * TL::WK * 8 * MT * TL::BN;
  auto kern = int8_mm_kernel<T, LAYOUT, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, ntiles, mtiles);
  cfg.blockDim = dim3(kNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x),
                         static_cast<const int8_t*>(w),
                         static_cast<const float*>(s), static_cast<T*>(out),
                         M, N, K, xs, vec, xvec);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int MT>
cudaError_t launch_layout(int layout, const void* x, const void* w,
                          const void* s, void* out, int M, int N, int K,
                          int xs, int vec, int xvec, cudaStream_t st) {
  return layout == kKN
             ? launch<T, kKN, MT>(x, w, s, out, M, N, K, xs, vec, xvec, st)
             : launch<T, kNK, MT>(x, w, s, out, M, N, K, xs, vec, xvec, st);
}

}  // namespace
}  // namespace ptt

// x is [M, K] with unit stride along K (row stride x_stride, in elements);
// w is a contiguous int8 [K, N] (layout 0) or [N, K] (layout 1); scale is
// a contiguous f32 [N]; out is a contiguous [M, N] of x's dtype. vec says
// w's rows are 16-byte aligned; xvec that x's rows are (its base and
// x_stride). Returns cudaGetLastError() after the launch.
extern "C" int ptt_int8_matmul(const void* x, const void* w, const void* s,
                               void* out, int dtype, int layout, int M, int N,
                               int K, int x_stride, int vec, int xvec,
                               void* stream) {
  using namespace ptt;
  if (M < 1 || N < 1 || K < 1 || (layout != kKN && layout != kNK) ||
      (M + 7) / 8 > 65535 || (N + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(launch_layout<float, 1>(
        layout, x, w, s, out, M, N, K, x_stride, vec, xvec, st));
  if (dtype == kBF16)
    return static_cast<int>(
        M <= 8 ? launch_layout<__nv_bfloat16, 1>(layout, x, w, s, out, M, N,
                                                 K, x_stride, vec, xvec, st)
               : launch_layout<__nv_bfloat16, 2>(layout, x, w, s, out, M, N,
                                                 K, x_stride, vec, xvec, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
