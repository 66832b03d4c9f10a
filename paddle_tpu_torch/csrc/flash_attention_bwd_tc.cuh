// FlashAttention-2 backward on Hopper's tensor cores, bf16: the dQ pass
// and the dK/dV pass.
//
// Replaces: paddle_tpu/kernels/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel for bf16 operands (the f32 instances keep the
// CUDA-core kernels of flash_attention_bwd.cuh, whose f32 sums the f32
// limits need). The functions, the mask rules and the rounding points are
// those of flash_attention_bwd.cuh:
//   P  = exp(scale * Q K^T - LSE),  dP = dO V^T,  Delta = rowsum(dO * O)
//   dS = P * (dP - Delta) * scale, rounded to bf16
//   dQ = dS K,  dK = dS^T Q,  dV = bf16(P)^T dO   (f32 accumulation)
// P is rounded to bf16 where it becomes the A operand of P^T dO, and dS
// where it becomes the A operand of dS K and dS^T Q (flash_attention.py
// :270, :324); each output is rounded once, at the end.
//
// What bounds it on an H100: at the training shape (B = 12, S = 1024, 8
// heads of 128, causal) the pair executes 90.3 GFLOP (both passes
// recompute S and dP: 7 products of the causal half of S x S x D a head)
// against ~300 MB of traffic; the least time of each pass alone is set by
// its bytes (dQ) or its 51.6 GFLOP (dK/dV) at the 989 TFLOP/s of the bf16
// tensor cores. mma.sync reaches a fraction of that rate (wgmma, TMA and
// warp specialisation are the further headroom), and this design keeps
// the tensor cores fed from shared memory without bank conflicts.
//
// Design. One block of 4 warps (128 threads) owns one 64-row output tile
// and walks the reduction in a loop: no atomics, the same bits every run.
//   dQ:  a block per (64-row query tile, batch * query head), the longest
//        walks first. Q and dO stay in shared memory; K/V tiles of 64 rows
//        stream from key tile 0 to the causal diagonal (or Sk). Each warp
//        owns 16 query rows: S = Q K^T and dP = dO V^T (16 x 64 a tile,
//        f32 in registers), P and dS in registers, dS packed to bf16 as
//        the A fragments of dQ += dS K (16 x D). The block also computes
//        Delta for its rows (two threads a row) and writes it out for the
//        dK/dV pass, launched after it on the same stream.
//   dKV: a block per (64-row key tile, batch * KV head). K and V stay in
//        shared memory; for each of the g query heads of its group it
//        streams Q, dO, LSE and Delta tiles from the first query tile that
//        reaches the diagonal to the last. Each warp owns 16 key rows and
//        computes the transposed products S^T = K Q^T and dP^T = V dO^T,
//        16 query columns at a time, so P^T and dS^T come out of the
//        accumulators already laid out as the A fragments of dV += P^T dO
//        and dK += dS^T Q (16 x D each): no pass through shared memory.
// Every product is mma.sync m16n8k16 bf16 -> f32 (tensor_core.cuh); the
// tensor cores' own additions truncate, so each 16-deep step of S and dP,
// and each tile's product of dQ, dK and dV, is added to its f32 sum on the
// CUDA cores (tc::mma_rn). Where the dK/dV pass's P lies near a bf16
// rounding tie (its low bits within tc::kTieMargin ulps of one), S is
// summed again in the plain version's order (tc::dots_in_order), so that P
// rounds for dV as there: a sum in another order flipped such roundings
// and put dv over its elementwise limit on 1 of 6 random inputs, which
// the recompute removes for +32% on the pass (PERF.md). dS is rounded for
// dQ and dK the same way in the full-width instances (D = 16, 32, 64 and
// 128 at their own width): where it lies near a tie (within
// tc::kDsTieMargin), both passes sum S and dP again in the plain order
// and round P (dP - Delta) scale as the plain version does, and Delta
// itself is summed in the plain version's order (tc::delta_in_order), so
// that dS rounds as there: flipped roundings of dS put dq and dk over
// their limit on 1 of 6 inputs each. The
// operands stay bf16 in shared memory in an XOR-swizzled layout, read by
// ldmatrix (.trans for the [k][n] operands: K in dS K, dO in P^T dO, Q in
// dS^T Q) without bank conflicts. Streamed tiles arrive by cp.async 16-byte
// copies in a ring of two stages: tile j + 1 is in flight while tile j is
// multiplied. Masks: only tiles that cross the causal diagonal (-1e30
// above q_offset + row) or run past Sq or Sk evaluate them. Rows past Sq
// or Sk are zero-filled in shared memory; a masked instance (hd < D)
// zero-fills columns hd..D-1, copies a chunk that is not whole or not
// 16-byte aligned element by element, and never stores those columns
// (tc::load_tile, tc::store_rows, shared with the forward). No
// input is padded or copied: q/k/v may be strided views of one fused QKV
// projection. Results go out through the warp's own rows of a resident
// tile (Q in dQ, K and V in dK/dV), in 16-byte stores.
// Shared memory a block: six 64 x D bf16 tiles (dQ: Q, dO, 2 x K, 2 x V;
// dK/dV: K, V, 2 x Q, 2 x dO) and the f32 rows of Delta (dQ) or of LSE
// and Delta for two stages (dK/dV): 96.25 and 97 KB at D = 128, 48.25 and
// 49 KB at D = 64, so two blocks share an SM. Registers: at most 255 a
// thread for two blocks of 128 threads an SM (__launch_bounds__(128, 2)).
// ptxas for sm_90a (chip_smoke.py prints it from the build log):
// dQ 255 registers at D = 128 and at D = 64, no spills but 60 bytes at the
// full D = 64 instance (4 before dS's guard; taking the tile's keys in two
// passes of 32 there removed them but cost more time than they do);
// dK/dV 255 at D = 128, ~180 at D = 64, no spills. Both passes sit at the
// register limit at D = 128: the guards' recompute reads its operands
// one chain after the other, 16 bytes a step, and the masked instances
// leave dS's guard out, since each wider form spilled there.
#pragma once

#include "common.cuh"
#include "tensor_core.cuh"

namespace ptt {
namespace flash_bwd_tc {

using bf16 = __nv_bfloat16;

constexpr int kB = 64;     // rows of a query or key tile
constexpr int kNT = 128;   // threads per block: 4 warps of 16 rows
constexpr int kQS = 16;    // query columns of a dK/dV sub-step

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return kB * D * sizeof(bf16);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return 6 * tile_bytes<D>() + kB * sizeof(float);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 6 * tile_bytes<D>() + 4 * kB * sizeof(float);
}

template <int D, bool FULL>
__global__ void __launch_bounds__(kNT, 2)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, bf16* __restrict__ dq,
                       int Nq, int Nkv, int Sq, int Sk, int hd, int q_sb,
                       int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                       int v_sb, int v_ss, int v_sh, int o_sb, int o_ss,
                       int o_sh, int do_sb, int do_ss, int do_sh, int dq_sb,
                       int dq_ss, int dq_sh, int causal, int q_offset,
                       float scale) {
  constexpr int CPR = D / 8;   // 16-byte chunks of a row
  constexpr int KS = D / 16;   // 16-deep steps over D
  constexpr uint32_t TB = tile_bytes<D>();
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sQ = tc::smem_addr(tc_smem);
  const uint32_t sdO = sQ + TB;
  const uint32_t sK = sdO + TB;       // two stages
  const uint32_t sV = sK + 2 * TB;    // two stages
  float* del_s = reinterpret_cast<float*>(tc_smem + 6 * TB);  // [kB]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // longest walks first
  const int b = blockIdx.y / Nq;
  const int h = blockIdx.y % Nq;
  const int hk = h / (Nq / Nkv);
  const long long row_base = ((long long)b * Nq + h) * Sq;

  const bf16* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const bf16* ob = o + (long long)b * o_sb + (long long)h * o_sh;
  const bf16* dob = dout + (long long)b * do_sb + (long long)h * do_sh;
  const bf16* kb = k + (long long)b * k_sb + (long long)hk * k_sh;
  const bf16* vb = v + (long long)b * v_sb + (long long)hk * v_sh;

  // keys any valid row of this tile can see: all of Sk, or up to the
  // causal diagonal of its last valid row
  int kv_end = Sk;
  if (causal) kv_end = min(Sk, q_offset + min(q0 + kB, Sq));
  const int ntiles = (kv_end + kB - 1) / kB;

  tc::load_tile<kB, kNT, D, FULL>(sQ, tc::Strided{qb, q_ss}, q0, Sq, hd);
  tc::load_tile<kB, kNT, D, FULL>(sdO, tc::Strided{dob, do_ss}, q0, Sq, hd);
  tc::load_tile<kB, kNT, D, FULL>(sK, tc::Strided{kb, k_ss}, 0, Sk, hd);
  tc::load_tile<kB, kNT, D, FULL>(sV, tc::Strided{vb, v_ss}, 0, Sk, hd);
  tc::cp_async_commit();

  // Delta = rowsum(dO * O) in f32, in the plain version's order
  // (tc::delta_in_order), two threads a row (adjacent lanes)
  {
    const int r = tid >> 1;
    const bool valid = q0 + r < Sq;
    const long long row = valid ? q0 + r : 0;
    const float sum = tc::delta_in_order<D, FULL>(
        dob + row * do_ss, ob + row * o_ss, hd, tid & 1);
    if ((tid & 1) == 0) {
      del_s[r] = valid ? sum : 0.f;
      if (valid) delta[row_base + q0 + r] = sum;
    }
  }

  // this thread's rows of the warp's 16: r_lo and r_lo + 8
  const int r_lo = warp * 16 + g;
  const float lse_lo = q0 + r_lo < Sq ? lse[row_base + q0 + r_lo] : 0.f;
  const float lse_hi =
      q0 + r_lo + 8 < Sq ? lse[row_base + q0 + r_lo + 8] : 0.f;
  float dl_lo = 0.f, dl_hi = 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kB;
    const uint32_t stK = sK + (j & 1) * TB;
    const uint32_t stV = sV + (j & 1) * TB;
    if (j + 1 < ntiles) {
      tc::load_tile<kB, kNT, D, FULL>(sK + ((j + 1) & 1) * TB,
                                      tc::Strided{kb, k_ss}, k0 + kB, Sk, hd);
      tc::load_tile<kB, kNT, D, FULL>(sV + ((j + 1) & 1) * TB,
                                      tc::Strided{vb, v_ss}, k0 + kB, Sk, hd);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile j (and at j = 0 Q and dO) has landed
    __syncthreads();
    if (j == 0) {
      dl_lo = del_s[r_lo];
      dl_hi = del_s[r_lo + 8];
    }

    const bool edge = (causal && k0 + kB - 1 > q_offset + q0) ||
                      k0 + kB > Sk || q0 + kB > Sq;
    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ado[4];
      tc::ldsm_x4(tc::addr_a<CPR>(sQ, warp * 16, 2 * kk, lane), aq);
      tc::ldsm_x4(tc::addr_a<CPR>(sdO, warp * 16, 2 * kk, lane), ado);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        tc::ldsm_x4(tc::addr_b<CPR>(stK, np * 16, 2 * kk, lane), bk);
        tc::mma_rn(s[2 * np], aq, bk[0], bk[1]);
        tc::mma_rn(s[2 * np + 1], aq, bk[2], bk[3]);
        tc::ldsm_x4(tc::addr_b<CPR>(stV, np * 16, 2 * kk, lane), bv);
        tc::mma_rn(dp[2 * np], ado, bv[0], bv[1]);
        tc::mma_rn(dp[2 * np + 1], ado, bv[2], bv[3]);
      }
    }

    // P and dS = P (dP - Delta) scale, dS rounded to bf16 as the A
    // fragments of dS K; where a dS lies near a bf16 rounding tie
    // (within tc::kDsTieMargin), S and dP are summed again in the plain
    // version's order and that half of the fragment is rewritten, so
    // that dS rounds as there (a masked P is 0, and so is its dS).
    // Rare: one vote a tile, then each lane walks its own flagged
    // elements. Full-width instances only: the masked ones (head dims
    // between 16, 32, 64 and 128) sit at their register limit without
    // it.
    uint32_t ads[4][4];
    uint32_t near = 0;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = r_lo + (e >> 1) * 8;
        float sv = s[nt][e] * scale;
        float p;
        if (edge) {
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = q_offset + q0 + rl;
          if ((causal && col > row) || col >= Sk) sv = kNegInf;
          p = q0 + rl < Sq ? expf(sv - (e < 2 ? lse_lo : lse_hi)) : 0.f;
        } else {
          p = expf(sv - (e < 2 ? lse_lo : lse_hi));
        }
        x[e] = p * (dp[nt][e] - (e < 2 ? dl_lo : dl_hi)) * scale;
        if constexpr (FULL)
          near |= tc::near_tie<tc::kDsTieMargin>(x[e]) ? 1u << (nt * 4 + e)
                                                       : 0u;
      }
      ads[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(x[0], x[1]);
      ads[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(x[2], x[3]);
    }
    if (__any_sync(0xffffffffu, near)) {
      for (; near != 0; near &= near - 1) {
        const int i = __ffs(near) - 1;
        const int e = i & 3;
        const int rl = r_lo + (e >> 1) * 8;
        const int key = (i >> 2) * 8 + 2 * t + (e & 1);
        float se, dpe;
        tc::dots_in_order<D>(sQ, rl, stK, key, sdO, rl, stV, key, se, dpe);
        const float p = tc::p_in_order(se, scale, e < 2 ? lse_lo : lse_hi);
        const uint32_t bits = tc::pack_bf16(
            tc::ds_in_order(p, dpe, e < 2 ? dl_lo : dl_hi, scale), 0.f);
        // element (nt, e) is half e & 1 of word (nt & 1) * 2 + (e >> 1)
        // of ads[nt >> 1]
        const int word = (i >> 3) * 4 + ((i >> 2) & 1) * 2 + (e >> 1);
        const int sh = 16 * (e & 1);
#pragma unroll
        for (int w = 0; w < 16; ++w)
          if (w == word)
            ads[w >> 2][w & 3] =
                (ads[w >> 2][w & 3] & ~(0xffffu << sh)) | (bits << sh);
      }
    }

    // dQ += dS K: K read transposed, as [key][d] = [k][n]; the tile's
    // product is summed in the tensor cores, then added to dQ in f32
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bk[4];
        tc::ldsm_x4_trans(
            tc::addr_a<CPR>(stK, kk * 16, 2 * np, lane), bk);
        tc::mma_bf16(t0, ads[kk], bk[0], bk[1]);
        tc::mma_bf16(t1, ads[kk], bk[2], bk[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * np][e] += t0[e];
        acc[2 * np + 1][e] += t1[e];
      }
    }
    __syncthreads();  // every warp is done with stage j & 1
  }
  tc::cp_async_wait<0>();

  // out through this warp's own rows of the Q tile (no other warp reads them)
  tc::store_rows<D, FULL>(acc, sQ, warp * 16,
                      dq + (long long)b * dq_sb + (long long)h * dq_sh, dq_ss,
                      q0, Sq, hd, lane);
}

template <int D, bool FULL>
__global__ void __launch_bounds__(kNT, 2)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int Nq, int Nkv, int Sq, int Sk,
                        int hd, int q_sb, int q_ss, int q_sh, int k_sb,
                        int k_ss, int k_sh, int v_sb, int v_ss, int v_sh,
                        int do_sb, int do_ss, int do_sh, int dk_sb, int dk_ss,
                        int dk_sh, int dv_sb, int dv_ss, int dv_sh, int causal,
                        int q_offset, float scale) {
  constexpr int CPR = D / 8;
  constexpr int KS = D / 16;
  constexpr uint32_t TB = tile_bytes<D>();
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sK = tc::smem_addr(tc_smem);
  const uint32_t sV = sK + TB;
  const uint32_t sQ = sV + TB;        // two stages
  const uint32_t sdO = sQ + 2 * TB;   // two stages
  float* lse_s = reinterpret_cast<float*>(tc_smem + 6 * TB);  // [2][kB]
  float* del_s = lse_s + 2 * kB;                           // [2][kB]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kB;
  const int b = blockIdx.y / Nkv;
  const int hk = blockIdx.y % Nkv;
  const int grp = Nq / Nkv;

  const bf16* kb = k + (long long)b * k_sb + (long long)hk * k_sh;
  const bf16* vb = v + (long long)b * v_sb + (long long)hk * v_sh;
  tc::load_tile<kB, kNT, D, FULL>(sK, tc::Strided{kb, k_ss}, k0, Sk, hd);
  tc::load_tile<kB, kNT, D, FULL>(sV, tc::Strided{vb, v_ss}, k0, Sk, hd);

  // the first query tile whose last row reaches this key tile's first
  // column: q_offset + 64 qt + 63 >= k0; the walk covers the query tiles
  // from there to the last, for each of the grp query heads
  const int nq = (Sq + kB - 1) / kB;
  const int qt0 =
      (causal && k0 > q_offset + kB - 1) ? (k0 - q_offset) / kB : 0;
  const int nqt = max(0, nq - qt0);
  const int n_it = grp * nqt;

  // Q, dO, LSE and Delta of walk step it into stage st
  auto issue = [&](int it, int st) {
    const int h = hk * grp + it / nqt;
    const int q0 = (qt0 + it % nqt) * kB;
    tc::load_tile<kB, kNT, D, FULL>(
        sQ + st * TB,
        tc::Strided{q + (long long)b * q_sb + (long long)h * q_sh, q_ss}, q0,
        Sq, hd);
    tc::load_tile<kB, kNT, D, FULL>(
        sdO + st * TB,
        tc::Strided{dout + (long long)b * do_sb + (long long)h * do_sh,
                    do_ss},
        q0, Sq, hd);
    const int i = tid & (kB - 1);
    const float* src = tid < kB ? lse : delta;
    float* dst = (tid < kB ? lse_s : del_s) + st * kB + i;
    const bool ok = q0 + i < Sq;
    tc::cp_async4(tc::smem_addr(dst),
                  ok ? src + ((long long)b * Nq + h) * Sq + q0 + i : src,
                  ok ? 4 : 0);
  };
  if (n_it > 0) issue(0, 0);
  tc::cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int kr_lo = k0 + warp * 16 + g;  // this thread's key rows: +0, +8

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) issue(it + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // step it (and at it = 0 K and V) has landed
    __syncthreads();
    const int q0 = (qt0 + it % nqt) * kB;
    const uint32_t stQ = sQ + st * TB;
    const uint32_t stdO = sdO + st * TB;
    const float* lse_t = lse_s + st * kB;
    const float* del_t = del_s + st * kB;
    const bool edge = (causal && k0 + kB - 1 > q_offset + q0) ||
                      q0 + kB > Sq || k0 + kB > Sk;

#pragma unroll 1
    for (int sub = 0; sub < kB; sub += kQS) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x kQS queries a warp
      float s[kQS / 8][4], dp[kQS / 8][4];
#pragma unroll
      for (int i = 0; i < kQS / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ak[4], av[4];
        tc::ldsm_x4(tc::addr_a<CPR>(sK, warp * 16, 2 * kk, lane), ak);
        tc::ldsm_x4(tc::addr_a<CPR>(sV, warp * 16, 2 * kk, lane), av);
#pragma unroll
        for (int np = 0; np < kQS / 16; ++np) {
          uint32_t bq[4], bdo[4];
          tc::ldsm_x4(tc::addr_b<CPR>(stQ, sub + np * 16, 2 * kk, lane), bq);
          tc::mma_rn(s[2 * np], ak, bq[0], bq[1]);
          tc::mma_rn(s[2 * np + 1], ak, bq[2], bq[3]);
          tc::ldsm_x4(tc::addr_b<CPR>(stdO, sub + np * 16, 2 * kk, lane),
                      bdo);
          tc::mma_rn(dp[2 * np], av, bdo[0], bdo[1]);
          tc::mma_rn(dp[2 * np + 1], av, bdo[2], bdo[3]);
        }
      }

      // P^T and dS^T, rounded to bf16 as the A fragments of the products.
      // P is rounded for dV and dS for dK: where either rounding lies near
      // a tie (tc::near_tie), S and dP are summed again in the plain
      // version's order, so that both round as there (a masked P is 0,
      // never near a tie, and so is its dS). dS's in full-width instances
      // only, as in the dQ pass.
      uint32_t ap[kQS / 16][4], ads[kQS / 16][4];
#pragma unroll
      for (int nt = 0; nt < kQS / 8; ++nt) {
        const int ql = sub + nt * 8 + 2 * t;  // query column of e = 0, 2
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + ql);
        const float2 d2 = *reinterpret_cast<const float2*>(del_t + ql);
        float p[4], x[4];
        uint32_t near = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = ql + (e & 1);
          const float l = (e & 1) ? l2.y : l2.x;
          const float dl = (e & 1) ? d2.y : d2.x;
          float sv = s[nt][e] * scale;
          if (edge) {
            const int key = kr_lo + (e >> 1) * 8;
            if ((causal && key > q_offset + q0 + qc) || key >= Sk)
              sv = kNegInf;
            p[e] = q0 + qc < Sq ? expf(sv - l) : 0.f;
          } else {
            p[e] = expf(sv - l);
          }
          x[e] = p[e] * (dp[nt][e] - dl) * scale;
          near |= tc::near_tie(p[e]) ||
                          (FULL && tc::near_tie<tc::kDsTieMargin>(x[e]))
                      ? 1u << e
                      : 0u;
        }
        if (__any_sync(0xffffffffu, near)) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!(near >> e & 1)) continue;
            const int kr = warp * 16 + g + (e >> 1) * 8;
            const int qr = ql + (e & 1);
            const float dl = (e & 1) ? d2.y : d2.x;
            if constexpr (FULL) {
              float se, dpe;
              tc::dots_in_order<D>(sK, kr, stQ, qr, sV, kr, stdO, qr, se,
                                   dpe);
              p[e] = tc::p_in_order(se, scale, (e & 1) ? l2.y : l2.x);
              x[e] = tc::ds_in_order(p[e], dpe, dl, scale);
            } else {  // P alone (as the masked dQ pass, dS is not held)
              p[e] = tc::p_in_order(tc::dot_in_order<D>(sK, kr, stQ, qr),
                                    scale, (e & 1) ? l2.y : l2.x);
              x[e] = p[e] * (dp[nt][e] - dl) * scale;
            }
          }
        }
        ap[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(p[0], p[1]);
        ap[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(p[2], p[3]);
        ads[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(x[0], x[1]);
        ads[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(x[2], x[3]);
      }

      // dV += P^T dO and dK += dS^T Q: dO and Q read transposed; each
      // sub-step's product is added to dV and dK in f32
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        float tv[2][4] = {}, tk[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kQS / 16; ++kk) {
          uint32_t bdo[4], bq[4];
          tc::ldsm_x4_trans(
              tc::addr_a<CPR>(stdO, sub + kk * 16, 2 * np, lane), bdo);
          tc::mma_bf16(tv[0], ap[kk], bdo[0], bdo[1]);
          tc::mma_bf16(tv[1], ap[kk], bdo[2], bdo[3]);
          tc::ldsm_x4_trans(
              tc::addr_a<CPR>(stQ, sub + kk * 16, 2 * np, lane), bq);
          tc::mma_bf16(tk[0], ads[kk], bq[0], bq[1]);
          tc::mma_bf16(tk[1], ads[kk], bq[2], bq[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv_acc[2 * np][e] += tv[0][e];
          dv_acc[2 * np + 1][e] += tv[1][e];
          dk_acc[2 * np][e] += tk[0][e];
          dk_acc[2 * np + 1][e] += tk[1][e];
        }
      }
    }
    __syncthreads();  // every warp is done with stage st
  }
  tc::cp_async_wait<0>();

  // out through this warp's own rows of the K and V tiles
  tc::store_rows<D, FULL>(dk_acc, sK, warp * 16,
                      dk + (long long)b * dk_sb + (long long)hk * dk_sh, dk_ss,
                      k0, Sk, hd, lane);
  tc::store_rows<D, FULL>(dv_acc, sV, warp * 16,
                      dv + (long long)b * dv_sb + (long long)hk * dv_sh, dv_ss,
                      k0, Sk, hd, lane);
}

template <int D, bool FULL>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, void* dq, int B, int Nq, int Nkv, int Sq,
                      int Sk, int hd, const int* st, int causal, int q_offset,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kern = flash_bwd_dq_tc_kernel<D, FULL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kB - 1) / kB, B * Nq);
  kern<<<grid, kNT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), Nq, Nkv, Sq, Sk, hd,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17], causal,
      q_offset, scale);
  return cudaGetLastError();
}

template <int D, bool FULL>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Nq, int Nkv, int Sq,
                       int Sk, int hd, const int* st, int causal,
                       int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kern = flash_bwd_dkv_tc_kernel<D, FULL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sk + kB - 1) / kB, B * Nkv);
  kern<<<grid, kNT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Nq, Nkv, Sq, Sk, hd,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17], causal,
      q_offset, scale);
  return cudaGetLastError();
}

}  // namespace flash_bwd_tc
}  // namespace ptt
