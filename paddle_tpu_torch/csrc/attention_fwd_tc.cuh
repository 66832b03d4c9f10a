// Attention forward on Hopper's tensor cores, bf16: the FlashAttention-2
// forward and the ragged chunk prefill, two entries on one tile pipeline.
//
// Replaces, for bf16 operands:
//   paddle_tpu/kernels/flash_attention.py::_fwd_kernel
//     -> flash_fwd_tc_kernel (ptt_flash_attention_fwd, via
//        flash_attention_fwd.cuh's launch);
//   paddle_tpu/kernels/paged_attention.py::_prefill_kernel
//     -> paged_prefill_tc_kernel (ptt_paged_attention_prefill, via
//        paged_attention_prefill.cuh's launch).
// f32 operands keep the CUDA-core kernels of flash_attention_fwd.cuh and
// paged_attention_prefill.cuh, whose f32 products the f32 limits need.
// Both compute, for each query row i at absolute position q_offset + i,
//   S = scale * q_i K^T (f32), -1e30 at masked positions,
//   O = softmax(S) V by an online softmax over 64-position K/V tiles,
// with the rounding points of the TPU kernels and of the plain version
// ragged_prefill_reference (kernels/paged_attention.py): S summed in f32;
// the running max taken per 64-position tile, the tiles walked in order;
// P = exp(S - m) rounded to bf16 where it becomes the A operand of P V,
// while l sums the unrounded P; O = acc / max(l, 1e-30), rounded once.
// The flash forward also writes the f32 LSE = m + log l. Masks: the flash
// forward's causal diagonal (optional) and Sk; the prefill's causal
// diagonal and the last position its rows can see (the table's reach).
//
// What bounds it on an H100 (bf16 tensor cores 989 TFLOP/s, HBM 3.35
// TB/s): the flash forward at the serving shape (B = 1, S = 1024, 8 heads
// of 128, causal) does 2.15 GFLOP on 8.4 MB, bound by its bytes at 2.5 us;
// at the training shape (B = 12) 25.8 GFLOP on 100.7 MB, bound by its
// operations at 26 us; the chunk prefill at the serving shape (C = 256,
// offset 768) 0.94 GFLOP on 5.2 MB, 1.6 us. mma.sync reaches a fraction of
// the tensor cores' rate (wgmma, TMA and warp specialisation are the
// further headroom); the chunk prefill's S runs on the CUDA cores (below),
// 67 TFLOP/s at most.
//
// Design (FlashAttention-2's forward). Both entries stream 64-row K and V
// tiles through a two-stage cp.async ring of swizzled bf16 tiles (tile
// j + 1 in flight while tile j is used), keep the online softmax in
// registers (a row's max and sum reduce over the 4 lanes of a quad), pack
// P to bf16 from S's C fragments, and compute P V with mma.sync m16n8k16
// from P's A fragments and V's B fragments (ldmatrix.trans), each tile's
// product summed in the tensor cores and added to O in f32. Masks are
// evaluated only on tiles that cross the causal diagonal or run past the
// last visible position. Blocks are launched longest walk first. The K/V
// rows come from a row source: base + pos * row_stride for the flash
// forward (strided views of a fused QKV projection; GQA: query head h
// reads KV head h / (Nq / Nkv)), and for the prefill the sequence's page
// table, one address per 16-byte chunk (any page size; the pool is never
// gathered). Rows past the visible positions are zero-filled; a masked
// head dim (hd < D) zero-fills columns hd..D-1 and never stores them
// (tc::load_tile, tc::store_rows).
//   Flash forward (attend): a block of 4 warps owns 64 query rows, each
//   warp 16, and computes their S on the tensor cores: Q's and K's
//   fragments by ldmatrix, S chained in the f32 accumulators (its limit
//   holds over 6 seeds that way, and summing each 16-deep step on the
//   CUDA cores, tc::mma_rn, costs more; PERF.md). P's A fragments
//   stay in registers, so P never passes through shared memory. 80 KB of
//   shared memory at D = 128, two blocks an SM (__launch_bounds__(128,
//   2)).
//   Chunk prefill (attend_split): its limit against
//   ragged_prefill_reference (rms 1e-4) needs S bit for bit as the plain
//   version sums it (a sequential f32 FMA over d, cuBLAS's order): S
//   summed on the tensor cores flips bf16 roundings of P, 1.0e-4 to
//   1.7e-4 rms over 6 seeds (PERF.md). So S runs on the CUDA cores from
//   K widened to f32 in shared memory. To spread that work, a block of 8
//   warps owns one group of 16 query rows: per tile, warp w computes S
//   of positions 8 w .. 8 w + 7; the row maxima and sums of the 8 warps
//   meet in shared memory, so all apply the same running max; P, rounded
//   to bf16, passes through a shared 16 x 64 tile, and each warp computes
//   P V over all 64 positions for an eighth of the head dims (16; fewer
//   warps at D < 128). Each row's positions are still walked in order,
//   one running max per tile. 104 KB of shared memory at D = 128.
#pragma once

#include "common.cuh"
#include "tensor_core.cuh"

namespace ptt {
namespace attn_fwd_tc {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;  // positions of a K/V tile

struct FwdParams {
  const bf16* q;
  bf16* o;
  float* lse;  // [B, Nq, Sq] f32, or null (the prefill writes none)
  int Nq, Nkv, Sq, Sk, hd;
  int q_sb, q_ss, q_sh, o_sb, o_ss, o_sh;  // strides in elements
  int causal, q_offset;
  float scale;
};

// the flash forward's K and V: [B, Sk, Nkv, hd] views
struct StridedKV {
  const bf16* k;
  const bf16* v;
  int k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  __device__ __forceinline__ tc::Strided k_rows(int b, int h) const {
    return {k + (long long)b * k_sb + (long long)h * k_sh, k_ss};
  }
  __device__ __forceinline__ tc::Strided v_rows(int b, int h) const {
    return {v + (long long)b * v_sb + (long long)h * v_sh, v_ss};
  }
};

// one sequence's positions through its page table: position pos is row
// pos % ps of page table[pos / ps] (pos clamped to the table's reach, so
// that the address of a row past it reads no table entry out of bounds)
struct PagedRows {
  const bf16* p;  // the pool at this head's first column
  const int* table;
  int ps, last;   // last: the table's last position, pps * ps - 1
  long long page_stride;
  int row_stride;
  __device__ __forceinline__ const bf16* row(int pos) const {
    pos = min(pos, last);
    return p + (long long)table[pos / ps] * page_stride +
           (long long)(pos % ps) * row_stride;
  }
};

// the chunk prefill's K and V: pages [P, ps, nh, hd], table [B, pps], and
// the chunk's offset, one int32 in device memory (so that one captured
// CUDA graph serves every offset)
struct PagedKV {
  const bf16* k;
  const bf16* v;
  const int* pt;
  int pps, ps, nh, hd;
  const int* q_offset;
  __device__ __forceinline__ PagedRows rows(const bf16* pool, int b,
                                            int h) const {
    return {pool + (long long)h * hd, pt + (long long)b * pps, ps,
            pps * ps - 1, (long long)ps * nh * hd, nh * hd};
  }
  __device__ __forceinline__ PagedRows k_rows(int b, int h) const {
    return rows(k, b, h);
  }
  __device__ __forceinline__ PagedRows v_rows(int b, int h) const {
    return rows(v, b, h);
  }
};

// scale S (NS n-tiles of C fragments, their first column k0 + col0),
// mask it, and return this thread's row maxima over the 4 lanes of its
// quad (rows pos_r + g and + 8 at absolute positions; element e of a C
// fragment is row e / 2, column 2 t + e % 2). Masks: -1e30 above the
// causal diagonal and at or past kv_end, on tiles that cross either.
template <int NS>
__device__ __forceinline__ void scale_mask_max(float (&s)[NS][4],
                                               const FwdParams& p, int k0,
                                               int col0, int pos_r,
                                               int kv_end, bool edge, int g,
                                               int t, float (&mx)[2]) {
  mx[0] = mx[1] = kNegInf;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sv = s[nt][e] * p.scale;
      if (edge) {
        const int col = k0 + col0 + nt * 8 + 2 * t + (e & 1);
        if ((p.causal && col > pos_r + g + (e >> 1) * 8) || col >= kv_end)
          sv = kNegInf;
      }
      s[nt][e] = sv;
      mx[e >> 1] = fmaxf(mx[e >> 1], sv);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// P = exp(S - m) in place of S; returns this quad's row sums of the
// unrounded P
template <int NS>
__device__ __forceinline__ void exp_sum(float (&s)[NS][4],
                                        const float (&m)[2], float (&ps)[2]) {
  ps[0] = ps[1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = expf(s[nt][e] - m[e >> 1]);
    ps[0] += s[nt][0] + s[nt][1];
    ps[1] += s[nt][2] + s[nt][3];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
    ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
  }
}

// acc (NP pairs of 8-column C fragments, head dims from chunk c0 of the V
// tile) += P V over the tile's 64 positions: pa holds P's A fragments of
// the 4 16-deep steps; V read transposed, as [position][d] = [k][n], by
// ldmatrix.trans. Each pair's product is summed in the tensor cores, then
// added in f32.
template <int CPR, int NP>
__device__ __forceinline__ void pv_tile(float (&acc)[2 * NP][4],
                                        const uint32_t (&pa)[4][4],
                                        uint32_t stV, int c0, int lane) {
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t bv[4];
      tc::ldsm_x4_trans(tc::addr_a<CPR>(stV, kk * 16, c0 + 2 * np, lane),
                        bv);
      tc::mma_bf16(t0, pa[kk], bv[0], bv[1]);
      tc::mma_bf16(t1, pa[kk], bv[2], bv[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * np][e] += t0[e];
      acc[2 * np + 1][e] += t1[e];
    }
  }
}

// positions a block's rows can see: all of Sk, or up to the causal
// diagonal of its last real row (rows [q0, q0 + rows)); K/V rows at or
// past it are zero-filled and masked
__device__ __forceinline__ int visible_end(const FwdParams& p, int q0,
                                           int rows) {
  return p.causal ? min(p.Sk, p.q_offset + min(q0 + rows, p.Sq)) : p.Sk;
}

// ---------------------------------------------------------------- flash

constexpr int kFlashWarps = 4;  // 64 query rows a block, 16 a warp

template <int D>
__host__ __device__ constexpr size_t flash_smem_bytes() {
  return (16 * kFlashWarps + 4 * kBK) * D * sizeof(bf16);
}

// the flash forward's block: 64 query rows (blockIdx.y, the longest walks
// first) of (batch, query head) blockIdx.x; each warp owns 16 rows and
// computes their S on the tensor cores
template <int D, bool FULL, class KV>
__device__ __forceinline__ void attend(const FwdParams& p, const KV& kv) {
  constexpr int NT = 32 * kFlashWarps;  // threads
  constexpr int BQ = 16 * kFlashWarps;  // query rows
  constexpr int CPR = D / 8;            // 16-byte chunks of a row
  constexpr int KS = D / 16;            // 16-deep steps over D
  constexpr uint32_t TB = kBK * D * sizeof(bf16);
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  const uint32_t sQ = tc::smem_addr(fwd_smem);
  const uint32_t sK = sQ + BQ * D * sizeof(bf16);  // two stages
  const uint32_t sV = sK + 2 * TB;                 // two stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.Nq;
  const int h = blockIdx.x % p.Nq;
  const int hk = h / (p.Nq / p.Nkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int w0 = q0 + warp * 16;        // this warp's first row
  const int pos0 = p.q_offset + w0;     // and its absolute position
  const int kv_end = visible_end(p, q0, BQ);
  const int ntiles = (kv_end + kBK - 1) / kBK;

  const auto krows = kv.k_rows(b, hk);
  const auto vrows = kv.v_rows(b, hk);
  tc::load_tile<BQ, NT, D, FULL>(
      sQ,
      tc::Strided{p.q + (long long)b * p.q_sb + (long long)h * p.q_sh,
                  p.q_ss},
      q0, p.Sq, p.hd);
  tc::load_tile<kBK, NT, D, FULL>(sK, krows, 0, kv_end, p.hd);
  tc::load_tile<kBK, NT, D, FULL>(sV, vrows, 0, kv_end, p.hd);
  tc::cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // this thread's rows: w0 + g (index 0) and w0 + g + 8 (index 1)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kBK;
    const uint32_t stK = sK + (j & 1) * TB;
    const uint32_t stV = sV + (j & 1) * TB;
    if (j + 1 < ntiles) {
      tc::load_tile<kBK, NT, D, FULL, 1>(sK + ((j + 1) & 1) * TB, krows,
                                         k0 + kBK, kv_end, p.hd);
      tc::load_tile<kBK, NT, D, FULL, 1>(sV + ((j + 1) & 1) * TB, vrows,
                                         k0 + kBK, kv_end, p.hd);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile j (and at j = 0 the Q tile) has landed
    __syncthreads();

    // a warp whose rows all lie past Sq, or see none of this tile, skips it
    if (w0 < p.Sq && !(p.causal && k0 > pos0 + 15)) {
      // S = Q K^T (16 rows x 64 positions), chained in the tensor cores'
      // f32 accumulators; Q's A fragments of each 16-deep step read by
      // ldmatrix, K's B fragments likewise (a loop of the D / 16 steps, so
      // that their products are not all in flight)
      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4];
        tc::ldsm_x4(tc::addr_a<CPR>(sQ, warp * 16, 2 * kk, lane), qa);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          tc::ldsm_x4(tc::addr_b<CPR>(stK, np * 16, 2 * kk, lane), bk);
          tc::mma_bf16(s[2 * np], qa, bk[0], bk[1]);
          tc::mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        }
      }

      const bool edge =
          (p.causal && k0 + kBK - 1 > pos0) || k0 + kBK > kv_end;
      float mx[2], corr[2], ps[2];
      scale_mask_max<8>(s, p, k0, 0, pos0, kv_end, edge, g, t, mx);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
      exp_sum<8>(s, m, ps);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = corr[r] * l[r] + ps[r];
      // P packed to bf16 straight from S's C fragments: the A fragments
      // of the 4 16-deep steps of P V
      uint32_t pa[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        pa[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(s[nt][0], s[nt][1]);
        pa[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(s[nt][2], s[nt][3]);
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= corr[e >> 1];
      pv_tile<CPR, D / 16>(acc, pa, stV, 0, lane);
    }
    __syncthreads();  // every warp is done with stage j & 1
  }
  tc::cp_async_wait<0>();

  // O = acc / l, out through this warp's own rows of the Q tile
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = acc[i][e] / den[e >> 1];
  tc::store_rows<D, FULL>(
      acc, sQ, warp * 16, p.o + (long long)b * p.o_sb + (long long)h * p.o_sh,
      p.o_ss, q0, p.Sq, p.hd, lane);
  if (p.lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + g + 8 * r;
      if (row < p.Sq)
        p.lse[((long long)b * p.Nq + h) * p.Sq + row] = m[r] + logf(l[r]);
    }
  }
}

// ------------------------------------------------------- chunk prefill

constexpr int kSplitWarps = 8;  // warps sharing a 16-row group
constexpr int kSplitNT = 8 / kSplitWarps;  // 8-position n-tiles of S a warp
constexpr int kPCPR = kBK / 8;  // 16-byte chunks of a P row (bf16)

// head dims of a split block's P V: PW warps, DW columns each
template <int D>
__host__ __device__ constexpr int pv_warps() {
  return D / 16 < kSplitWarps ? D / 16 : kSplitWarps;
}

// f32 K row stride: 4 floats of padding, so that the 4 rows one LDS.128
// of scores_exact reads fall in different bank groups
template <int D>
__host__ __device__ constexpr int kf_stride() {
  return D + 4;
}

template <int D>
__host__ __device__ constexpr size_t split_smem_bytes() {
  return (16 + 4 * kBK) * D * sizeof(bf16)          // Q, 2 x (K, V)
         + kBK * kf_stride<D>() * sizeof(float)     // K widened
         + 16 * kBK * sizeof(bf16)                  // P
         + 2 * kSplitWarps * 16 * sizeof(float);    // row max and sums
}

// S of this warp's 8 kSplitNT positions of the tile (the C fragments of
// n-tiles kSplitNT w ..) for the group's 16 rows, on the CUDA cores: each
// element a sequential f32 FMA over d from 0, the order of the plain
// version's f32 product (cuBLAS), so S, and every bf16 rounding of P, is
// the plain version's bit for bit. Q from the bf16 tile, K from its f32
// copy; columns past hd are zeros and add +0.
template <int D>
__device__ __forceinline__ void scores_exact(float (&s)[kSplitNT][4],
                                             uint32_t sQ, const float* Kf,
                                             int warp, int lane) {
  constexpr int CPR = D / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kSplitNT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll 2
  for (int c = 0; c < CPR; ++c) {
    const uint4 qa = tc::ld_shared_v4(sQ + tc::chunk_offset<CPR>(g, c));
    const uint4 qb = tc::ld_shared_v4(sQ + tc::chunk_offset<CPR>(g + 8, c));
    const uint32_t qw[2][4] = {{qa.x, qa.y, qa.z, qa.w},
                               {qb.x, qb.y, qb.z, qb.w}};
#pragma unroll
    for (int i = 0; i < kSplitNT; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* kr = Kf +
                          ((warp * kSplitNT + i) * 8 + 2 * t + e) *
                              kf_stride<D>() +
                          c * 8;
        const float4 ka = *reinterpret_cast<const float4*>(kr);
        const float4 kb = *reinterpret_cast<const float4*>(kr + 4);
        const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& acc = s[i][2 * r + e];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc = fmaf(tc::bf16_lo(qw[r][j]), kv[2 * j], acc);
            acc = fmaf(tc::bf16_hi(qw[r][j]), kv[2 * j + 1], acc);
          }
        }
      }
    }
  }
}

// the chunk prefill's block: one group of 16 query rows (blockIdx.y, the
// longest walks first) of (batch, head) blockIdx.x, shared by kSplitWarps
// warps. Per 64-position tile, warp w computes S of its 8 kSplitNT
// positions (scores_exact); the row maxima and sums of the warps meet in
// shared memory, so every warp applies the same running max; each warp
// writes its P, rounded to bf16, into a shared P tile, and the first PW
// warps compute P V over all 64 positions, DW head dims each.
template <int D, bool FULL, class KV>
__device__ __forceinline__ void attend_split(const FwdParams& p,
                                             const KV& kv) {
  constexpr int NT = 32 * kSplitWarps;
  constexpr int CPR = D / 8;
  constexpr int PW = pv_warps<D>();
  constexpr int DW = D / PW;
  constexpr uint32_t TB = kBK * D * sizeof(bf16);
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  const uint32_t sQ = tc::smem_addr(fwd_smem);
  const uint32_t sK = sQ + 16 * D * sizeof(bf16);  // two stages
  const uint32_t sV = sK + 2 * TB;                 // two stages
  float* Kf = reinterpret_cast<float*>(fwd_smem + (16 + 4 * kBK) * D *
                                       sizeof(bf16));
  const uint32_t sP = tc::smem_addr(Kf + kBK * kf_stride<D>());
  float* red_max = reinterpret_cast<float*>(
      fwd_smem + split_smem_bytes<D>() - 2 * kSplitWarps * 16 * sizeof(float));
  float* red_sum = red_max + kSplitWarps * 16;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.Nq;
  const int h = blockIdx.x % p.Nq;
  const int hk = h / (p.Nq / p.Nkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 16;
  const int pos0 = p.q_offset + q0;
  const int kv_end = visible_end(p, q0, 16);
  const int ntiles = (kv_end + kBK - 1) / kBK;

  const auto krows = kv.k_rows(b, hk);
  const auto vrows = kv.v_rows(b, hk);
  tc::load_tile<16, NT, D, FULL>(
      sQ,
      tc::Strided{p.q + (long long)b * p.q_sb + (long long)h * p.q_sh,
                  p.q_ss},
      q0, p.Sq, p.hd);
  tc::load_tile<kBK, NT, D, FULL>(sK, krows, 0, kv_end, p.hd);
  tc::load_tile<kBK, NT, D, FULL>(sV, vrows, 0, kv_end, p.hd);
  tc::cp_async_commit();

  float acc[DW / 8][4];
#pragma unroll
  for (int i = 0; i < DW / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // this thread's rows: q0 + g (index 0) and q0 + g + 8 (index 1)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kBK;
    const uint32_t stK = sK + (j & 1) * TB;
    const uint32_t stV = sV + (j & 1) * TB;
    tc::cp_async_wait<0>();  // tile j (and at j = 0 the Q tile) has landed
    __syncthreads();         // and every warp is done with tile j - 1
    if (j + 1 < ntiles) {
      tc::load_tile<kBK, NT, D, FULL, 1>(sK + ((j + 1) & 1) * TB, krows,
                                         k0 + kBK, kv_end, p.hd);
      tc::load_tile<kBK, NT, D, FULL, 1>(sV + ((j + 1) & 1) * TB, vrows,
                                         k0 + kBK, kv_end, p.hd);
    }
    tc::cp_async_commit();
    // K widened to f32 (exact) for scores_exact
#pragma unroll 1
    for (int idx = threadIdx.x; idx < kBK * CPR; idx += NT) {
      const int r = idx / CPR, c = idx % CPR;
      const uint4 w = tc::ld_shared_v4(stK + tc::chunk_offset<CPR>(r, c));
      float4* dst = reinterpret_cast<float4*>(Kf + r * kf_stride<D>() + c * 8);
      dst[0] = make_float4(tc::bf16_lo(w.x), tc::bf16_hi(w.x),
                           tc::bf16_lo(w.y), tc::bf16_hi(w.y));
      dst[1] = make_float4(tc::bf16_lo(w.z), tc::bf16_hi(w.z),
                           tc::bf16_lo(w.w), tc::bf16_hi(w.w));
    }
    __syncthreads();

    // S of this warp's 16 positions; the group's row maxima meet
    float s[kSplitNT][4];
    scores_exact<D>(s, sQ, Kf, warp, lane);
    const bool edge =
        (p.causal && k0 + kBK - 1 > pos0) || k0 + kBK > kv_end;
    float mx[2], corr[2], ps[2];
    scale_mask_max<kSplitNT>(s, p, k0, warp * kSplitNT * 8, pos0, kv_end,
                             edge, g, t, mx);
    if (t == 0) {
      red_max[warp * 16 + g] = mx[0];
      red_max[warp * 16 + g + 8] = mx[1];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w)
        m_new = fmaxf(m_new, red_max[w * 16 + g + 8 * r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    // P = exp(S - m), rounded to bf16 into the P tile (row g and g + 8,
    // positions 16 w + 8 i + 2 t, + 1); the sums of the unrounded P meet
    exp_sum<kSplitNT>(s, m, ps);
#pragma unroll
    for (int i = 0; i < kSplitNT; ++i) {
      tc::st_shared_b32(
          sP + tc::chunk_offset<kPCPR>(g, kSplitNT * warp + i) + 4 * t,
          tc::pack_bf16(s[i][0], s[i][1]));
      tc::st_shared_b32(
          sP + tc::chunk_offset<kPCPR>(g + 8, kSplitNT * warp + i) + 4 * t,
          tc::pack_bf16(s[i][2], s[i][3]));
    }
    if (t == 0) {
      red_sum[warp * 16 + g] = ps[0];
      red_sum[warp * 16 + g + 8] = ps[1];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) sum += red_sum[w * 16 + g + 8 * r];
      l[r] = corr[r] * l[r] + sum;
    }
    if (warp < PW) {
#pragma unroll
      for (int i = 0; i < DW / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= corr[e >> 1];
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::ldsm_x4(tc::addr_a<kPCPR>(sP, 0, 2 * kk, lane), pa[kk]);
      pv_tile<CPR, DW / 16>(acc, pa, stV, warp * DW / 8, lane);
    }
  }

  // O = acc / l: this warp's DW head dims of the group's rows
  if (warp < PW) {
    const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
    bf16* ob = p.o + (long long)b * p.o_sb + (long long)h * p.o_sh;
#pragma unroll
    for (int i = 0; i < DW / 8; ++i) {
      const int col = warp * DW + i * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + g + 8 * r;
        if (row >= p.Sq) continue;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            acc[i][2 * r] / den[r], acc[i][2 * r + 1] / den[r]);
        bf16* out = ob + (long long)row * p.o_ss + col;
        if (FULL) {
          *reinterpret_cast<__nv_bfloat162*>(out) = v;
        } else {
          if (col < p.hd) out[0] = v.x;
          if (col + 1 < p.hd) out[1] = v.y;
        }
      }
    }
  }
}

// ------------------------------------------------------------- launches

template <int D, bool FULL>
__global__ void __launch_bounds__(128, 2)
flash_fwd_tc_kernel(const FwdParams p, const StridedKV kv) {
  attend<D, FULL>(p, kv);
}

template <int D, bool FULL>
__global__ void __launch_bounds__(32 * kSplitWarps)
paged_prefill_tc_kernel(FwdParams p, const PagedKV kv) {
  p.q_offset = *kv.q_offset;
  attend_split<D, FULL>(p, kv);
}

template <class KV>
cudaError_t start(void (*kern)(FwdParams, KV), size_t smem, int rows,
                  int threads, const FwdParams& p, const KV& kv, int B,
                  cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.Nq, (p.Sq + rows - 1) / rows);
  kern<<<grid, threads, smem, stream>>>(p, kv);
  return cudaGetLastError();
}

// the flash forward: q/k/v/o [B, S, N, hd] views, strides st as
// ptt_flash_attention_fwd takes them (q, k, v, o; batch, row, head)
template <int D, bool FULL>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int Nq, int Nkv, int Sq, int Sk,
                         int hd, const int* st, int causal, int q_offset,
                         float scale, cudaStream_t stream) {
  const FwdParams p{static_cast<const bf16*>(q), static_cast<bf16*>(o),
                    static_cast<float*>(lse), Nq, Nkv, Sq, Sk, hd,
                    st[0], st[1], st[2], st[9], st[10], st[11], causal,
                    q_offset, scale};
  const StridedKV kv{static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                     st[3], st[4], st[5], st[6], st[7], st[8]};
  return start(flash_fwd_tc_kernel<D, FULL>, flash_smem_bytes<D>(),
               16 * kFlashWarps, 32 * kFlashWarps, p, kv, B, stream);
}

// the chunk prefill: q [B, C, nh, hd] (strides q_sb, q_ss, q_sh), pages
// [P, ps, nh, hd], table [B, pps], out a contiguous [B, C, nh, hd];
// q_offset points at the chunk's offset on the device (the kernel reads it)
template <int D, bool FULL>
cudaError_t launch_prefill(const void* q, const void* kp, const void* vp,
                           const void* pt, void* o, int B, int C, int nh,
                           int hd, int ps, int pps, int q_sb, int q_ss,
                           int q_sh, const int* q_offset, float scale,
                           cudaStream_t stream) {
  // causal over the positions the table reaches: row i sees q_offset + i
  // and before
  const FwdParams p{static_cast<const bf16*>(q), static_cast<bf16*>(o),
                    nullptr, nh, nh, C, pps * ps, hd, q_sb, q_ss, q_sh,
                    C * nh * hd, nh * hd, hd, 1, 0, scale};
  const PagedKV kv{static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
                   static_cast<const int*>(pt), pps, ps, nh, hd, q_offset};
  return start(paged_prefill_tc_kernel<D, FULL>, split_smem_bytes<D>(), 16,
               32 * kSplitWarps, p, kv, B, stream);
}

}  // namespace attn_fwd_tc
}  // namespace ptt
