// Warp-level tensor-core building blocks for sm_90a (inline PTX): bf16
// mma.sync m16n8k16 with f32 accumulators, ldmatrix fragment loads from an
// XOR-swizzled shared-memory tile, and cp.async copies into it; then the
// tile loads and stores that the attention kernels share (the forward and
// the chunk prefill in attention_fwd_tc.cuh, the backward in
// flash_attention_bwd_tc.cuh).
//
// Fragments of mma.m16n8k16.row.col (g = lane / 4, t = lane % 4; each
// 32-bit register holds two bf16, the lower column in the low half):
//   A (16 x 16, row-major): a0 (row g, cols 2t..2t+1), a1 (row g + 8),
//     a2 (row g, cols 2t + 8..), a3 (row g + 8, cols 2t + 8..);
//   B (16 x 8, k x n):      b0 (k 2t..2t+1, col g), b1 (k 2t + 8.., col g);
//   C (16 x 8, f32):        c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8).
// The C fragments of two neighbouring 8-column tiles are, packed to bf16,
// the A fragment of a 16-deep step: a product's result feeds the next
// product from registers.
//
// Tiles are [rows][D] bf16, D / 8 chunks of 16 bytes a row; chunk c of row
// r is stored at chunk swizzle(r, c), which sends the 8 rows of every 8 x 8
// block that ldmatrix reads to 8 different 16-byte bank groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt {
namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int CPR>  // 16-byte chunks a row: 2, 4, 8 or 16
__device__ __forceinline__ int swizzle(int r, int c) {
  if constexpr (CPR >= 8) {
    return c ^ (r & 7);
  } else {
    return c ^ ((r / (8 / CPR)) & (CPR - 1));
  }
}

// byte offset of chunk c of row r
template <int CPR>
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  return static_cast<uint32_t>((r * CPR + swizzle<CPR>(r, c)) * 16);
}

// this lane's row address for an x4 ldmatrix of the 16 x 16 block at row
// r0, chunk c0 (r0 a multiple of 8, c0 even): registers 0..3 are then the
// A fragment of that block or, with .trans from a [k][n] tile, the B
// fragments of the two 8-column tiles n0 = 8 c0 (registers 0, 1) and
// n0 + 8 (registers 2, 3)
template <int CPR>
__device__ __forceinline__ uint32_t addr_a(uint32_t base, int r0, int c0,
                                           int lane) {
  return base + chunk_offset<CPR>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  c0 + (lane >> 4));
}

// the same for the B fragments of the two 8-column tiles at rows n0 and
// n0 + 8 of an [n][k] tile, k chunks c0 and c0 + 1 (without .trans):
// registers 0, 1 for tile n0, registers 2, 3 for tile n0 + 8
template <int CPR>
__device__ __forceinline__ uint32_t addr_b(uint32_t base, int n0, int c0,
                                           int lane) {
  return base + chunk_offset<CPR>(n0 + (lane & 7) + (lane >> 4) * 8,
                                  c0 + ((lane >> 3) & 1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b on the tensor cores, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes from global memory (16-byte aligned) to shared memory, async
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 4 bytes, async; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// d += a * b: the tensor cores sum the 16 products of the step into a
// fresh accumulator, which is added to d in f32 on the CUDA cores (round
// to nearest). The attention kernels sum S (and dP) this way: chained in
// the tensor cores, whose additions truncate, they drift further from the
// plain versions' f32 sums, and more bf16 roundings of P (and dS) flip
// (PERF.md).
__device__ __forceinline__ void mma_rn(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// two bf16 values of a 32-bit word (lo: the low half), widened to f32
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// f32 ulps around a bf16 rounding tie within which a sum in another order
// may move x to the other side (S summed by mma_rn and by a sequential
// FMA put exp(S - m) at most 22 ulps apart, 99.9% of them within 15, in a
// simulation of the tensor cores' truncation over 128 random products)
constexpr uint32_t kTieMargin = 16;

// the same for dS = P (dP - Delta) scale: P's error and dP's, a few ulps
// of |dP| (Delta is summed in the plain order). Where dP - Delta cancels,
// dP's error is more ulps of dS, but dS is then small beside the sums it
// enters, and a flip of it stays far below the limits.
constexpr uint32_t kDsTieMargin = 32;

// the distance of x's low 16 bits above 0x8000 - margin (wrapped): below
// 2 margin where rounding x to bf16 (to nearest even) lies within margin
// ulps of a tie. Masked elements (0) lie far from one.
template <uint32_t M>
__device__ __forceinline__ uint32_t tie_distance(float x) {
  return (__float_as_uint(x) - (0x8000u - M)) & 0xffffu;
}

template <uint32_t M = kTieMargin>
__device__ __forceinline__ bool near_tie(float x) {
  return tie_distance<M>(x) < 2u * M;
}

// the sum over d of x[rx][d] * y[ry][d], rows of two swizzled [rows][D]
// bf16 tiles, as a sequential f32 FMA from d = 0: the order of the plain
// versions' f32 products (cuBLAS), bit for bit. dots_in_order: S (from Q
// and K) and dP (from dO and V) one after the other (in one loop, the two
// chains put the D = 128 instances over their registers).
template <int D>
__device__ __forceinline__ float dot_in_order(uint32_t x, int rx, uint32_t y,
                                              int ry) {
  constexpr int CPR = D / 8;
  float acc = 0.f;
#pragma unroll 1
  for (int k = 0; k < CPR; ++k) {
    const uint4 u = ld_shared_v4(x + chunk_offset<CPR>(rx, k));
    const uint4 v = ld_shared_v4(y + chunk_offset<CPR>(ry, k));
    const uint32_t uw[4] = {u.x, u.y, u.z, u.w}, vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = fmaf(bf16_lo(uw[j]), bf16_lo(vw[j]), acc);
      acc = fmaf(bf16_hi(uw[j]), bf16_hi(vw[j]), acc);
    }
  }
  return acc;
}

template <int D>
__device__ __forceinline__ void dots_in_order(uint32_t a, int ra, uint32_t b,
                                              int rb, uint32_t c, int rc,
                                              uint32_t e, int re, float& s,
                                              float& dp) {
  s = dot_in_order<D>(a, ra, b, rb);
  dp = dot_in_order<D>(c, rc, e, re);
}

// P = exp(S scale - lse) and dS = P (dP - delta) scale from S and dP summed
// in the plain version's order, each product and difference rounded where
// the plain version rounds it (no contraction into an FMA): bit for bit
// the plain backward's P and dS (before their bf16 rounding)
__device__ __forceinline__ float p_in_order(float s, float scale, float lse) {
  return expf(__fsub_rn(__fmul_rn(s, scale), lse));
}
__device__ __forceinline__ float ds_in_order(float p, float dp, float delta,
                                             float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// Delta = the sum over d < hd of dO[d] O[d] (each product of two bf16 exact
// in f32) for one row, in the order of the plain version's torch.sum over
// the last dim on the card (ATen's reduce kernel, torch 2.11: one warp a
// row; at hd = 128 lane l adds its elements 4l..4l+3 in order, below lane
// l adds l, l + w, l + 2w, l + 3w (those below hd) in order, w =
// min(2^floor(log2 hd), 32); then lane l < off adds lane l + off's sum for
// off = w / 2, w / 4, .., 1). Here two threads (adjacent lanes, part =
// lane & 1) take a row: each sums the reduce kernel's lanes of its parity
// in that kernel's tree, and the two sums are added last, as the final
// shuffle adds lanes 0 and 1. Lanes at or past w count as 0: adding 0 is
// exact, so the tree of 32 lanes gives the tree of w. Both threads return
// the row's Delta (chip_smoke.py checks it bit for bit against the plain
// version).
template <int D, bool FULL>
__device__ __forceinline__ float delta_in_order(const __nv_bfloat16* dorow,
                                                const __nv_bfloat16* orow,
                                                int hd, int part) {
  const int w = hd >= 32 ? 32 : 1 << (31 - __clz(hd));
  // the reduce kernel's lane l's sum
  auto lane = [&](int l) {
    float v = 0.f;
    if constexpr (FULL && D == 128) {  // rows 16-byte aligned
      const uint2 x = *reinterpret_cast<const uint2*>(dorow + 4 * l);
      const uint2 y = *reinterpret_cast<const uint2*>(orow + 4 * l);
      v = bf16_lo(x.x) * bf16_lo(y.x);
      v += bf16_hi(x.x) * bf16_hi(y.x);
      v += bf16_lo(x.y) * bf16_lo(y.y);
      v += bf16_hi(x.y) * bf16_hi(y.y);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = l + j * w;
        if (l < w && col < hd)
          v += __bfloat162float(dorow[col]) * __bfloat162float(orow[col]);
      }
    }
    return v;
  };
  // the tree over this thread's lanes 2i + part: a_i = lane(2i + part) +
  // lane(2i + part + 16), t_k = a_k + a_{k + 4}, u_m = t_m + t_{m + 2},
  // r = u_0 + u_1; one u a pass of a loop, to bound the loads in flight
  float r = 0.f;
#pragma unroll 1
  for (int m = 0; m < 2; ++m) {
    float u = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = m + 2 * h;
      const float t = (lane(2 * k + part) + lane(2 * k + part + 16)) +
                      (lane(2 * k + part + 8) + lane(2 * k + part + 24));
      u = h == 0 ? t : u + t;
    }
    r = m == 0 ? u : r + u;
  }
  return r + __shfl_xor_sync(0xffffffffu, r, 1);
}

// the rows of a [S, hd] view with row stride ss (elements): a row source
// of load_tile
struct Strided {
  const __nv_bfloat16* p;
  long long ss;
  __device__ __forceinline__ const __nv_bfloat16* row(int r) const {
    return p + r * ss;
  }
};

// rows [r0, r0 + ROWS) of a row source (src.row(r): the address of row r,
// 16-byte aligned at full width; taken for every row, read only for rows
// below S) into the swizzled [ROWS][D] tile at dst, by the NT threads of
// the block: cp.async 16-byte copies; rows at or past S, and columns at or
// past hd, become zeros. A masked instance (FULL false) copies a chunk
// that is not whole or not 16-byte aligned element by element. UNROLL: the
// copies a thread unrolls (all by default; a streamed tile rolls them so
// that its addresses are not held in registers across the caller's loop).
template <int ROWS, int NT, int D, bool FULL,
          int UNROLL = (ROWS * D / 8 + NT - 1) / NT, class Src>
__device__ __forceinline__ void load_tile(uint32_t dst, const Src& src,
                                          int r0, int S, int hd) {
  constexpr int CPR = D / 8;
  constexpr int N = ROWS * CPR;  // chunks of the tile
#pragma unroll(UNROLL)
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    if (N % NT != 0 && idx >= N) break;
    const int r = idx / CPR;
    const int c = idx % CPR;
    const uint32_t d = dst + chunk_offset<CPR>(r, c);
    const __nv_bfloat16* g = src.row(r0 + r) + c * 8;
    if (r0 + r >= S) {
      st_shared_v4(d, make_uint4(0u, 0u, 0u, 0u));
    } else if constexpr (FULL) {
      cp_async16(d, g);
    } else {
      const int n = hd - c * 8;  // columns of this chunk before hd
      if (n >= 8 && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
        cp_async16(d, g);
      } else {  // narrower: element by element, zeros at and past hd
        const unsigned short* e = reinterpret_cast<const unsigned short*>(g);
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t lo = 2 * j < n ? e[2 * j] : 0u;
          const uint32_t hi = 2 * j + 1 < n ? e[2 * j + 1] : 0u;
          w[j] = lo | (hi << 16);
        }
        st_shared_v4(d, make_uint4(w[0], w[1], w[2], w[3]));
      }
    }
  }
}

// one warp: acc (rows r0 + lane / 4 and + 8 of a 16-row slab, D columns
// as D / 8 C fragments) rounded to bf16 into those rows of the swizzled
// tile at tile, then the slab's rows below S out to dst (row stride ss),
// columns below hd, in 16-byte stores where whole and aligned
template <int D, bool FULL>
__device__ __forceinline__ void store_rows(float (&acc)[D / 8][4],
                                           uint32_t tile, int r0,
                                           __nv_bfloat16* dst, int ss,
                                           int row0, int S, int hd,
                                           int lane) {
  constexpr int CPR = D / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    st_shared_b32(tile + chunk_offset<CPR>(r0 + g, nt) + 4 * t,
                  pack_bf16(acc[nt][0], acc[nt][1]));
    st_shared_b32(tile + chunk_offset<CPR>(r0 + g + 8, nt) + 4 * t,
                  pack_bf16(acc[nt][2], acc[nt][3]));
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CPR / 32; ++i) {
    const int idx = lane + i * 32;
    const int r = idx / CPR;
    const int c = idx % CPR;
    if (row0 + r0 + r >= S) continue;
    const uint4 v = ld_shared_v4(tile + chunk_offset<CPR>(r0 + r, c));
    __nv_bfloat16* out = dst + (long long)(row0 + r0 + r) * ss + c * 8;
    const int n = FULL ? 8 : hd - c * 8;
    if (n >= 8 && (FULL || (reinterpret_cast<uintptr_t>(out) & 15) == 0)) {
      *reinterpret_cast<uint4*>(out) = v;
    } else if (n > 0) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      for (int j = 0; j < n && j < 8; ++j) out[j] = e[j];
    }
  }
}

}  // namespace tc
}  // namespace ptt
