// The dK/dV pass of the flash backward on Hopper's warpgroup MMA, bf16
// (FlashAttention-3's backward shape, without its dQ atomics: this pass
// writes only dK and dV; the dQ pass, flash_attention_bwd_tc.cuh, runs
// before it on the same stream and writes Delta for it).
//
// Replaces, for bf16 operands that TMA can describe (attention_wg.cuh):
//   paddle_tpu/kernels/flash_attention.py::_bwd_dkv_kernel
// (ptt_flash_attention_bwd_dkv, routed by flash_attention_bwd.cuh's
// launch_dkv; other bf16 views keep flash_attention_bwd_tc.cuh's mma.sync
// kernel, f32 the CUDA-core kernel). The function and its rounding points
// are those of flash_attention_bwd_tc.cuh's header:
//   P = exp(scale * Q K^T - LSE),  dP = dO V^T,
//   dS = P * (dP - Delta) * scale,  dK = dS^T Q,  dV = bf16(P)^T dO,
// P rounded to bf16 as the A operand of P^T dO, dS as the A operand of
// dS^T Q, each output rounded once; where P lies near a bf16 rounding tie
// S is summed again in the plain version's order (tc::near_tie), so that
// P rounds for dV as there. GQA: dK/dV sum over the g query heads of a KV
// head; causal with q_offset; ragged Sq, Sk and head dims masked in the
// kernel.
//
// What bounds it on an H100: at the training shape (B = 12, S = 1024, 8
// heads of 128, causal) 51.6 GFLOP (four products of the causal half) on
// ~150 MB: its operations, 52 us at the bf16 tensor cores' 989 TFLOP/s.
//
// Design. A block owns 128 key rows of one (batch, KV head): two consumer
// warpgroups of 64 key rows each, and a producer warpgroup whose
// registers setmaxnreg lowers. The producer's first warp loads K and V
// once by TMA (each consumer's 64 rows as tiles of their own), then, for
// each of the g query heads from the first query tile that reaches the
// causal diagonal, streams the 64-row Q and dO tiles by TMA and the f32
// LSE and Delta rows (plain loads, zeros past Sq) into a ring of three
// stages: a "full" mbarrier a stage (the TMA bytes and the warp's 32
// arrivals), an "empty" one the 8 consumer warps arrive on. A consumer
// warpgroup walks each 64-row query tile in sub-steps of 32 queries:
// S^T = K Q^T and dP^T = V dO^T by wgmma m64n32k16 with both operands in
// shared memory (K-major); P^T and dS^T, rounded to bf16 in registers
// where flash_attention_bwd_tc.cuh rounds them, are the A operands of
// dV += P^T dO and dK += dS^T Q (wgmma m64n64k16 a 64-column half, dO and
// Q read MN-major from shared memory). No atomics, no workspace: the same
// bits every run. dK and dV go out through the warpgroup's own K and V
// tiles (tc::store_rows). Shared memory at D = 128: K and V 64 KB, three
// stages of Q and dO 96 KB.
//
// Precision. The tensor cores' own additions truncate. Every sub-step's
// dK and dV products are added to their f32 sums on the CUDA cores, as
// the mma.sync pass does (dK and dV chained in the wgmma accumulators
// over the whole walk raised their rms error by 25-60%, PERF.md); S^T
// and dP^T are summed kSdPSteps 16-deep steps at a time in the tensor
// cores and added in f32 between them: chained over all of D, the bf16
// roundings of dS moved enough to put dk over its elementwise limit on an
// input where the mma.sync pass held it (tools/torch_flash_bwd_stats.py,
// PERF.md). Where P lies near a bf16 tie (tc::near_tie) S is summed again
// in the plain order: the common path only keeps the least distance to a
// tie while P is computed, and one warp vote a sub-step sends the rare
// flagged elements to the recompute, so it keeps its instruction-level
// parallelism.
#include "attention_wg.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "tensor_core.cuh"

namespace ptt {
namespace attn_wg {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;        // query rows of a streamed tile
constexpr int kBStages = 3;    // stages of the Q / dO / LSE / Delta ring
constexpr int kQS = 32;        // query columns of a sub-step of S^T
// 16-deep steps of S^T and dP^T that the tensor cores sum between two
// f32 additions on the CUDA cores (at most D / 16: chained over all of D)
constexpr int kSdPSteps = 2;

struct DkvParams {
  const float* lse;
  const float* delta;
  bf16* dk;
  bf16* dv;
  int Nq, Nkv, Sq, Sk, hd;
  int dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;  // strides in elements
  int causal, q_offset;
  float scale;
};

template <int D>
struct DkvSmem {
  static constexpr uint32_t kKV = kRowsWG * D * 2;  // one consumer's K or V
  static constexpr uint32_t kT = kBQ * D * 2;       // a Q or dO tile
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = 2 * kKV;
  static constexpr uint32_t q = 4 * kKV;
  static constexpr uint32_t dO = q + kBStages * kT;
  static constexpr uint32_t lse = dO + kBStages * kT;
  static constexpr uint32_t del = lse + kBStages * kBQ * 4;
  static constexpr uint32_t bars = del + kBStages * kBQ * 4;
  static constexpr uint32_t bytes = bars + 8 * (1 + 2 * kBStages) + 1024;
  static_assert(bytes <= 232448, "shared memory of a block");
};

// two f32 at shared address a (8-byte aligned)
__device__ __forceinline__ float2 ld_shared_f2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}

__device__ __forceinline__ float ld_shared_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// sum over d of a[ra][d] * b[rb][d], rows of two 128-byte-swizzled
// [rows][D] tiles, as a sequential f32 FMA from d = 0: the plain
// versions' order (cuBLAS), bit for bit (tc::dot_in_order for these tiles)
template <int D>
__device__ __forceinline__ float dot_in_order_sw128(uint32_t a, int rows_a,
                                                    int ra, uint32_t b,
                                                    int rows_b, int rb) {
  float s = 0.f;
#pragma unroll 1
  for (int c = 0; c < D / 8; ++c) {
    const uint4 x = tc::ld_shared_v4(hop::sw128_chunk(a, rows_a, ra, c));
    const uint4 y = tc::ld_shared_v4(hop::sw128_chunk(b, rows_b, rb, c));
    const uint32_t xw[4] = {x.x, x.y, x.z, x.w}, yw[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s = fmaf(tc::bf16_lo(xw[j]), tc::bf16_lo(yw[j]), s);
      s = fmaf(tc::bf16_hi(xw[j]), tc::bf16_hi(yw[j]), s);
    }
  }
  return s;
}

// s = K Q^T and dp = V dO^T over D (K and V: a warpgroup's K-major
// [64][D] tiles; Q and dO: kQS rows from row r0 of K-major [kBQ][D]
// tiles): the tensor cores sum C = kSdPSteps 16-deep steps into fresh
// accumulators, which are added to s and dp in f32 (round to nearest);
// at C = D / 16 the sum is chained over all of D. S's and dP's chunks
// alternate as wgmma groups, so that one is in flight while the other is
// added.
template <int D>
__device__ __forceinline__ void scores_t(float (&s)[kQS / 8][4],
                                         float (&dp)[kQS / 8][4], uint32_t sK,
                                         uint32_t sV, uint32_t sQ,
                                         uint32_t sdO, int r0) {
  constexpr int C = kSdPSteps < D / 16 ? kSdPSteps : D / 16;
  constexpr int NCH = D / 16 / C;
  const uint32_t bq = sQ + r0 * 128, bdo = sdO + r0 * 128;
  float ts[kQS / 8][4], tp[kQS / 8][4];
  auto issue = [&](float (&t)[kQS / 8][4], uint32_t a, uint32_t b, int c) {
    hop::wgmma_fence();
#pragma unroll
    for (int j = 0; j < C; ++j)
      hop::wgmma_ss<kQS, 0>(t, hop::kmajor_desc(a, kRowsWG, c * C + j),
                            hop::kmajor_desc(b, kBQ, c * C + j), j > 0);
    hop::wgmma_commit();
  };
  auto add = [](float (&acc)[kQS / 8][4], float (&t)[kQS / 8][4], int c) {
    hop::fence_regs(t);
#pragma unroll
    for (int i = 0; i < kQS / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][e] = c == 0 ? t[i][e] : acc[i][e] + t[i][e];
  };
  issue(ts, sK, bq, 0);
  issue(tp, sV, bdo, 0);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    hop::wgmma_wait<1>();  // S's chunk c
    add(s, ts, c);
    if (c + 1 < NCH) {
      issue(ts, sK, bq, c + 1);
      hop::wgmma_wait<1>();  // dP's chunk c
    } else {
      hop::wgmma_wait<0>();
    }
    add(dp, tp, c);
    if (c + 1 < NCH) issue(tp, sV, bdo, c + 1);
  }
}

// dv += P^T dO and dk += dS^T Q over the sub-step's kQS queries: ap and
// ads the bf16 A operands of its kQS / 16 steps, dO and Q rows from r0 of
// MN-major [kBQ][D] tiles. Each 64-column half of each product is summed
// in the tensor cores into a fresh accumulator (one group), then added in
// f32; the groups alternate between the two products, so that one is in
// flight while the other is added.
template <int D>
__device__ __forceinline__ void accumulate(float (&dv)[D / 8][4],
                                           float (&dk)[D / 8][4],
                                           const uint32_t (&ap)[kQS / 16][4],
                                           const uint32_t (&ads)[kQS / 16][4],
                                           uint32_t sdO, uint32_t sQ, int r0) {
  float tv[8][4], tk[8][4];
  auto issue = [&](float (&t)[8][4], const uint32_t (&a)[kQS / 16][4],
                   uint32_t b, int c) {
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQS / 16; ++kk)
      hop::wgmma_rs<64, 1>(
          t, a[kk], hop::mnmajor_desc(b + c * kBQ * 128 + r0 * 128, kBQ, kk),
          kk > 0);
    hop::wgmma_commit();
  };
  auto add = [](float (&acc)[D / 8][4], float (&t)[8][4], int c) {
    hop::fence_regs(t);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c * 8 + i][e] += t[i][e];
  };
  issue(tv, ap, sdO, 0);
  issue(tk, ads, sQ, 0);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    hop::wgmma_wait<1>();  // dV's half c
    add(dv, tv, c);
    if (c + 1 < D / 64) {
      issue(tv, ap, sdO, c + 1);
      hop::wgmma_wait<1>();  // dK's half c
    } else {
      hop::wgmma_wait<0>();
    }
    add(dk, tk, c);
    if (c + 1 < D / 64) issue(tk, ads, sQ, c + 1);
  }
}

template <int D>
__device__ __forceinline__ void dkv_consumer(const DkvParams& p, uint32_t base,
                                             int wg, int k0, int qt0, int nqt,
                                             int n_it) {
  using L = DkvSmem<D>;
  const uint32_t bars = base + L::bars;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.Nkv, hk = blockIdx.x % p.Nkv;
  const uint32_t sK = base + L::k + wg * L::kKV;
  const uint32_t sV = base + L::v + wg * L::kKV;
  const int kr0 = k0 + wg * kRowsWG;         // this warpgroup's first key
  const int kr_lo = kr0 + warp * 16 + g;     // this thread's keys: + 0, + 8

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  hop::mbar_wait(bars, 0);  // K and V
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kBStages;
    const uint32_t par = (it / kBStages) & 1;
    const int q0 = (qt0 + it % nqt) * kBQ;
    const uint32_t sQ = base + L::q + st * L::kT;
    const uint32_t sdO = base + L::dO + st * L::kT;
    const uint32_t lse_t = base + L::lse + st * kBQ * 4;
    const uint32_t del_t = base + L::del + st * kBQ * 4;
    hop::mbar_wait(bars + 8 * (1 + st), par);
    // a warpgroup whose keys all lie past this tile's last visible
    // position sees none of it
    const bool none =
        p.causal && kr0 > p.q_offset + min(q0 + kBQ, p.Sq) - 1;
    const bool edge = (p.causal && kr0 + kRowsWG - 1 > p.q_offset + q0) ||
                      q0 + kBQ > p.Sq || kr0 + kRowsWG > p.Sk;
#pragma unroll 1
    for (int sub = 0; sub < (none ? 0 : kBQ); sub += kQS) {
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x kQS queries
      float s[kQS / 8][4], dp[kQS / 8][4];
      scores_t<D>(s, dp, sK, sV, sQ, sdO, sub);

      // P^T in place of S^T, dP^T - Delta in place of dP^T; tie: the least
      // distance of a P's low 16 bits above 0x8000 - kTieMargin (wrapped),
      // below 2 kTieMargin where a P lies near a bf16 rounding tie
      uint32_t tie = 0xffffu;
#pragma unroll
      for (int nt = 0; nt < kQS / 8; ++nt) {
        const int ql = sub + nt * 8 + 2 * t;  // query column of e = 0, 2
        const float2 l2 = ld_shared_f2(lse_t + ql * 4);
        const float2 d2 = ld_shared_f2(del_t + ql * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = ql + (e & 1);
          float sv = s[nt][e] * p.scale;
          float pv;
          if (edge) {
            const int key = kr_lo + (e >> 1) * 8;
            if ((p.causal && key > p.q_offset + q0 + qc) || key >= p.Sk)
              sv = kNegInf;
            pv = q0 + qc < p.Sq ? expf(sv - (e & 1 ? l2.y : l2.x)) : 0.f;
          } else {
            pv = expf(sv - (e & 1 ? l2.y : l2.x));
          }
          s[nt][e] = pv;
          dp[nt][e] -= e & 1 ? d2.y : d2.x;
          tie = min(tie, (__float_as_uint(pv) - (0x8000u - tc::kTieMargin)) &
                             0xffffu);
        }
      }
      // P is rounded to bf16 for dV: where that rounding lies near a tie
      // (tc::near_tie), S is summed again in the plain version's order, so
      // that P rounds as there (a masked P is 0, never near a tie). Rare:
      // one vote a sub-step, then each lane walks its own flagged elements.
      if (__any_sync(0xffffffffu, tie < 2 * tc::kTieMargin)) {
        uint32_t near = 0;
#pragma unroll
        for (int i = 0; i < kQS / 2; ++i)
          near |= tc::near_tie(s[i >> 2][i & 3]) ? 1u << i : 0u;
        for (; near != 0; near &= near - 1) {
          const int i = __ffs(near) - 1;
          const int nt = i >> 2, e = i & 3;
          const int qr = sub + nt * 8 + 2 * t + (e & 1);
          const float se = dot_in_order_sw128<D>(
              sK, kRowsWG, warp * 16 + g + (e >> 1) * 8, sQ, kBQ, qr);
          const float pv = expf(
              se * p.scale - ld_shared_f32(lse_t + qr * 4));
#pragma unroll
          for (int j = 0; j < kQS / 2; ++j)
            if (j == i) s[j >> 2][j & 3] = pv;
        }
      }
      // P^T and dS^T = P^T (dP^T - Delta) scale, rounded to bf16 as the A
      // operands of the products
      uint32_t ap[kQS / 16][4], ads[kQS / 16][4];
#pragma unroll
      for (int nt = 0; nt < kQS / 8; ++nt) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = s[nt][e] * dp[nt][e] * p.scale;
        ap[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(s[nt][0], s[nt][1]);
        ap[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(s[nt][2], s[nt][3]);
        ads[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(x[0], x[1]);
        ads[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(x[2], x[3]);
      }

      // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
      accumulate<D>(dv_acc, dk_acc, ap, ads, sdO, sQ, sub);
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(bars + 8 * (1 + kBStages + st));
  }

  // out through this warp's own rows of the warpgroup's K and V tiles
  // (every wgmma that read them has completed)
  tc::store_rows<D, false>(
      dk_acc, sK, warp * 16,
      p.dk + (long long)b * p.dk_sb + (long long)hk * p.dk_sh, p.dk_ss, kr0,
      p.Sk, p.hd, lane);
  tc::store_rows<D, false>(
      dv_acc, sV, warp * 16,
      p.dv + (long long)b * p.dv_sb + (long long)hk * p.dv_sh, p.dv_ss, kr0,
      p.Sk, p.hd, lane);
}

template <int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const DkvParams p) {
  using L = DkvSmem<D>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (hop::smem_u32(wg_smem) + 1023) & ~1023u;
  const uint32_t bars = base + L::bars;
  const int k0 = blockIdx.y * 2 * kRowsWG;  // key tile 0 (the longest walk)
  const int grp = p.Nq / p.Nkv;
  // the first query tile whose last row reaches this block's first key:
  // q_offset + 64 qt + 63 >= k0; the walk covers the query tiles from
  // there to the last, for each of the grp query heads
  const int nq = (p.Sq + kBQ - 1) / kBQ;
  const int qt0 = (p.causal && k0 > p.q_offset + kBQ - 1)
                      ? (k0 - p.q_offset) / kBQ
                      : 0;
  const int nqt = max(0, nq - qt0);
  const int n_it = grp * nqt;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    hop::mbar_init(bars, 1);
    for (int st = 0; st < kBStages; ++st) {
      hop::mbar_init(bars + 8 * (1 + st), 32);
      hop::mbar_init(bars + 8 * (1 + kBStages + st), 8);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    hop::setmaxnreg_dec<24>();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 256 + 32) {
      const int b = blockIdx.x / p.Nkv, hk = blockIdx.x % p.Nkv;
      if (lane == 0) {
        hop::tma_prefetch_map(&tq);
        hop::tma_prefetch_map(&tdo);
        hop::mbar_arrive_expect_tx(bars, 4 * L::kKV);
        for (int w = 0; w < 2; ++w)
          for (int c = 0; c < D / 64; ++c) {
            hop::tma_load_4d(base + L::k + w * L::kKV + c * kRowsWG * 128, &tk,
                             bars, c * 64, k0 + w * kRowsWG, hk, b);
            hop::tma_load_4d(base + L::v + w * L::kKV + c * kRowsWG * 128, &tv,
                             bars, c * 64, k0 + w * kRowsWG, hk, b);
          }
      }
      float* lse_s = reinterpret_cast<float*>(
          wg_smem + (base + L::lse - hop::smem_u32(wg_smem)));
      float* del_s = lse_s + kBStages * kBQ;
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kBStages;
        const int h = hk * grp + it / nqt;
        const int q0 = (qt0 + it % nqt) * kBQ;
        // the stage is free once the 8 consumer warps are done with step
        // it - kBStages (the first kBStages waits pass at once)
        hop::mbar_wait(bars + 8 * (1 + kBStages + st),
                       ((it / kBStages) & 1) ^ 1);
        const long long rows = ((long long)b * p.Nq + h) * p.Sq;
        for (int i = lane; i < kBQ; i += 32) {
          const bool ok = q0 + i < p.Sq;
          lse_s[st * kBQ + i] = ok ? p.lse[rows + q0 + i] : 0.f;
          del_s[st * kBQ + i] = ok ? p.delta[rows + q0 + i] : 0.f;
        }
        const uint32_t full = bars + 8 * (1 + st);
        if (lane == 0) {
          hop::mbar_arrive_expect_tx(full, 2 * L::kT);
          for (int c = 0; c < D / 64; ++c) {
            hop::tma_load_4d(base + L::q + st * L::kT + c * kBQ * 128, &tq,
                             full, c * 64, q0, h, b);
            hop::tma_load_4d(base + L::dO + st * L::kT + c * kBQ * 128, &tdo,
                             full, c * 64, q0, h, b);
          }
        } else {
          hop::mbar_arrive(full);
        }
      }
    }
  } else {
    hop::setmaxnreg_inc<240>();
    dkv_consumer<D>(p, base, wg, k0, qt0, nqt, n_it);
  }
}

template <int D>
cudaError_t start_dkv(const CUtensorMap& tq, const CUtensorMap& tk,
                      const CUtensorMap& tv, const CUtensorMap& tdo,
                      const DkvParams& p, int B, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_wg_kernel<D>;
  constexpr size_t smem = DkvSmem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  // blocks start in order of blockIdx.x fastest: every (batch, KV head)'s
  // first key tile, whose walk is the longest under the causal mask, first
  const dim3 grid(B * p.Nkv, (p.Sk + 2 * kRowsWG - 1) / (2 * kRowsWG));
  kern<<<grid, 384, smem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Nq, int Nkv, int Sq,
                       int Sk, int hd, const int* st, int causal,
                       int q_offset, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e =
      hop::bshd_map(&tq, q, B, Sq, Nq, hd, st[0], st[1], st[2], kBQ);
  if (e == cudaSuccess)
    e = hop::bshd_map(&tk, k, B, Sk, Nkv, hd, st[3], st[4], st[5], kRowsWG);
  if (e == cudaSuccess)
    e = hop::bshd_map(&tv, v, B, Sk, Nkv, hd, st[6], st[7], st[8], kRowsWG);
  if (e == cudaSuccess)
    e = hop::bshd_map(&tdo, dout, B, Sq, Nq, hd, st[9], st[10], st[11], kBQ);
  if (e != cudaSuccess) return e;
  const DkvParams p{static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                    Nq, Nkv, Sq, Sk, hd,
                    st[12], st[13], st[14], st[15], st[16], st[17],
                    causal, q_offset, scale};
  return hd <= 64 ? start_dkv<64>(tq, tk, tv, tdo, p, B, stream)
                  : start_dkv<128>(tq, tk, tv, tdo, p, B, stream);
}

}  // namespace attn_wg
}  // namespace ptt
