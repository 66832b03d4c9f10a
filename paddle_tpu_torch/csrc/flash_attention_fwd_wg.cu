// Flash forward on Hopper's warpgroup MMA, bf16 (FlashAttention-3's
// forward shape): a TMA producer warp and one or two consumer warpgroups.
//
// Replaces, for bf16 operands that TMA can describe (attention_wg.cuh):
//   paddle_tpu/kernels/flash_attention.py::_fwd_kernel
// (ptt_flash_attention_fwd, routed by flash_attention_fwd.cuh's launch;
// other bf16 views keep attention_fwd_tc.cuh's mma.sync kernel, f32 the
// CUDA-core kernel). The function and its rounding points are those of
// attention_fwd_tc.cuh's header: S = scale * q K^T summed in f32 (chained
// in the wgmma accumulators), -1e30 above the causal diagonal (query row i
// at q_offset + i) and at or past Sk; one running max per K/V tile of 128
// positions, the tiles walked in order; P = exp(S - m) rounded to bf16
// only as the A operand of P V, while l sums the unrounded P; O = acc /
// max(l, 1e-30), rounded once; LSE = m + log l in f32. P is computed as
// 2^(S log2(e) - m log2(e)) by one FMA and one ex2.approx (2 ulps; expf
// cost 13% of the training shape's time, PERF.md), LSE as
// (m log2(e) + log2 l) ln 2.
// GQA: query head h reads KV head h / (Nq / Nkv).
//
// What bounds it on an H100 (bf16 tensor cores 989 TFLOP/s, HBM 3.35
// TB/s): at the training shape (B = 12, S = 1024, 8 heads of 128, causal)
// 25.8 GFLOP on 101 MB, bound by its operations at 26 us; at the serving
// shape (B = 1) 2.15 GFLOP on 8.4 MB, bound by its bytes at 2.5 us but,
// with 128 blocks of at most 8 tiles each, by one block's walk.
//
// Design. A block owns NC * 64 query rows (NC = 2 when those blocks fill
// the card, else 1: attn_wg::fwd_warpgroups) of one (batch, head), the
// longest walks first. Warpgroup NC is the producer: its registers are
// lowered by setmaxnreg and one thread issues every TMA load: Q once (one
// box of 64 rows per consumer), then the K and V tiles of 128 positions
// into a ring of three stages, each tile completing on its own mbarrier and
// each stage freed by an "empty" mbarrier the consumer warps arrive on.
// Each consumer warpgroup (its registers raised by setmaxnreg) owns 64
// query rows: S = Q K^T by wgmma m64n128k16 with both operands in shared
// memory (K-major), the online softmax in registers (the accumulators
// are mma.sync's C fragments, so attention_fwd_tc.cuh's row reductions
// serve), P packed to bf16 in registers as the A operand of O += P V by
// wgmma m64nDk16 with V read MN-major from shared memory. Within a
// warpgroup the products of tile j + 1's S and tile j's P V are issued
// together, and tile j + 1's softmax runs while P V does (FlashAttention-
// 3's intra-warpgroup overlap). TMA writes zeros past Sq, Sk and the head
// dim hd, so a masked head dim (hd < D: the instance D = 64 or 128 above
// it) needs no code of its own. O goes out through the warpgroup's own Q
// tile (tc::store_rows), LSE from the registers. No workspace, no
// atomics: the same bits every run. Shared memory at D = 128, two
// consumers: Q 32 KB, K and V 3 x 2 x 32 KB.
#include "attention_fwd_tc.cuh"
#include "attention_wg.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "tensor_core.cuh"

namespace ptt {
namespace attn_wg {

int force_mma_sync = 0;

using bf16 = __nv_bfloat16;
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// 2^x (ex2.approx.ftz: 2 ulps; 0 at -1e30)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr int kBK = kFwdBK;

// shared memory of a block: each consumer's Q tile, the K and V rings,
// the barriers (Q; K and V of each stage; each stage's "empty")
template <int D, int NC>
struct FwdSmem {
  static constexpr uint32_t kQ = kRowsWG * D * 2;  // one consumer's Q
  static constexpr uint32_t kKV = kBK * D * 2;     // one K or V tile
  static constexpr uint32_t k = NC * kQ;
  static constexpr uint32_t v = k + kStages * kKV;
  static constexpr uint32_t bars = v + kStages * kKV;
  static constexpr uint32_t bytes = bars + 8 * (1 + 3 * kStages) + 1024;
  static_assert(bytes <= 232448, "shared memory of a block");
};

template <int D, int NC>
__device__ __forceinline__ void fwd_consumer(const attn_fwd_tc::FwdParams& p,
                                             uint32_t base, int wg, int q0,
                                             int kv_end, int ntiles) {
  using L = FwdSmem<D, NC>;
  const uint32_t bars = base + L::bars;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.Nq, h = blockIdx.x % p.Nq;
  const uint32_t sQ = base + wg * L::kQ;
  const int row0 = q0 + wg * kRowsWG;   // this warpgroup's first row
  const int w0 = row0 + warp * 16;      // this warp's first row
  const int pos0 = p.q_offset + w0;     // and its absolute position

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // this thread's rows: w0 + g (index 0) and w0 + g + 8 (index 1); m is
  // the running max of the base-2 logits S scale2
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = p.scale * kLog2e;

  // S of tile j = Q K_j^T (64 rows x 128 positions), chained over D in the
  // f32 accumulators: issued, not waited for
  auto issue_s = [&](float (&s)[kBK / 8][4], int j) {
    const int st = j % kStages;
    hop::mbar_wait(bars + 8 * (1 + st), (j / kStages) & 1);  // K of tile j
    const uint32_t sK = base + L::k + st * L::kKV;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hop::wgmma_ss<kBK, 0>(s, hop::kmajor_desc(sQ, kRowsWG, kk),
                            hop::kmajor_desc(sK, kBK, kk), kk > 0);
  };
  // O += P V_j, V read MN-major: issued, not waited for
  auto issue_pv = [&](const uint32_t (&pa)[kBK / 16][4], int j) {
    const int st = j % kStages;
    hop::mbar_wait(bars + 8 * (1 + kStages + st), (j / kStages) & 1);
    const uint32_t sV = base + L::v + st * L::kKV;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hop::wgmma_rs<D, 1>(acc, pa[kk], hop::mnmajor_desc(sV, kBK, kk), 1);
  };
  // tile j's K and V are no longer read by this warp
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(bars + 8 * (1 + 2 * kStages + j % kStages));
  };
  // the online softmax of tile j on its S (P = exp(S - m) in place, the
  // unrounded P summed into l); returns the factor the earlier O takes
  auto softmax = [&](float (&s)[kBK / 8][4], int j, float (&corr)[2]) {
    const int k0 = j * kBK;
    const bool edge = (p.causal && k0 + kBK - 1 > pos0) || k0 + kBK > kv_end;
    // the row maxima of the unscaled S (-1e30 where masked), two partial
    // maxima and sums a row so that their chains run side by side; the
    // scale (> 0) keeps the order, so max(S) scale2 = max(S scale2)
    float mx[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          if ((p.causal && col > pos0 + g + (e >> 1) * 8) || col >= kv_end)
            s[nt][e] = kNegInf;
        }
        mx[e >> 1][nt & 1] = fmaxf(mx[e >> 1][nt & 1], s[nt][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = fmaxf(mx[r][0], mx[r][1]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[r], x * scale2);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
    float ps[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = ex2(fmaf(s[nt][e], scale2, -m[e >> 1]));
      ps[0][nt & 1] += s[nt][0] + s[nt][1];
      ps[1][nt & 1] += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = ps[r][0] + ps[r][1];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      l[r] = corr[r] * l[r] + x;
    }
  };
  // P rounded to bf16 straight from S's fragments: the A operands of the
  // 8 16-deep steps of P V
  auto pack = [&](const float (&s)[kBK / 8][4], uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      pa[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(s[nt][0], s[nt][1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(s[nt][2], s[nt][3]);
    }
  };

  // FlashAttention-3's overlap within a warpgroup: while P_{j-1} V_{j-1}
  // runs on the tensor cores, the softmax of tile j does
  float s[kBK / 8][4], corr[2];
  uint32_t pa[kBK / 16][4];
  hop::mbar_wait(bars, 0);  // Q
  hop::wgmma_fence();
  issue_s(s, 0);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(s);
  softmax(s, 0, corr);
  pack(s, pa);
  for (int j = 1; j < ntiles; ++j) {
      hop::wgmma_fence();
    issue_s(s, j);
    hop::wgmma_commit();
    issue_pv(pa, j - 1);
    hop::wgmma_commit();
      hop::wgmma_wait<1>();  // S of tile j
    hop::fence_regs(s);
    softmax(s, j, corr);
    hop::wgmma_wait<0>();  // P V of tile j - 1
    hop::fence_regs(acc);
    release(j - 1);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= corr[e >> 1];
    pack(s, pa);
  }
  hop::wgmma_fence();
  issue_pv(pa, ntiles - 1);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);
  release(ntiles - 1);

  // O = acc / l, out through this warp's own rows of its Q tile (every
  // wgmma that read Q has completed)
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = acc[i][e] / den[e >> 1];
  tc::store_rows<D, false>(
      acc, sQ, warp * 16, p.o + (long long)b * p.o_sb + (long long)h * p.o_sh,
      p.o_ss, row0, p.Sq, p.hd, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + g + 8 * r;
      if (row < p.Sq)
        p.lse[((long long)b * p.Nq + h) * p.Sq + row] =
            (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// registers a thread: the producer's after setmaxnreg.dec, a consumer's
// after .inc (what the producer gives back: 168 a thread at launch for
// 384 threads, 128 for 256)
constexpr int kProducerRegs = 24;
template <int NC>
__host__ __device__ constexpr int consumer_regs() {
  return NC == 2 ? 240 : 232;
}

template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), NC == 2 ? 1 : 2)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const attn_fwd_tc::FwdParams p) {
  using L = FwdSmem<D, NC>;
  constexpr int BQ = NC * kRowsWG;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (hop::smem_u32(wg_smem) + 1023) & ~1023u;
  const uint32_t bars = base + L::bars;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest walks first
  const int kv_end = attn_fwd_tc::visible_end(p, q0, BQ);
  const int ntiles = (kv_end + kBK - 1) / kBK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    hop::mbar_init(bars, 1);
    for (int st = 0; st < kStages; ++st) {
      hop::mbar_init(bars + 8 * (1 + st), 1);
      hop::mbar_init(bars + 8 * (1 + kStages + st), 1);
      hop::mbar_init(bars + 8 * (1 + 2 * kStages + st), 4 * NC);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (wg == NC) {  // the producer
    hop::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * NC) {
      const int b = blockIdx.x / p.Nq, h = blockIdx.x % p.Nq;
      const int hk = h / (p.Nq / p.Nkv);
      hop::tma_prefetch_map(&tq);
      hop::tma_prefetch_map(&tk);
      hop::tma_prefetch_map(&tv);
      hop::mbar_arrive_expect_tx(bars, NC * L::kQ);
      for (int w = 0; w < NC; ++w)
        for (int c = 0; c < D / 64; ++c)
          hop::tma_load_4d(base + w * L::kQ + c * kRowsWG * 128, &tq, bars,
                           c * 64, q0 + w * kRowsWG, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % kStages;
        // the stage is free once every consumer warp is done with tile
        // j - kStages (the first kStages waits pass at once)
        hop::mbar_wait(bars + 8 * (1 + 2 * kStages + st),
                       ((j / kStages) & 1) ^ 1);
        const uint32_t bk = bars + 8 * (1 + st);
        const uint32_t bv = bars + 8 * (1 + kStages + st);
        hop::mbar_arrive_expect_tx(bk, L::kKV);
        for (int c = 0; c < D / 64; ++c)
          hop::tma_load_4d(base + L::k + st * L::kKV + c * kBK * 128, &tk, bk,
                           c * 64, j * kBK, hk, b);
        hop::mbar_arrive_expect_tx(bv, L::kKV);
        for (int c = 0; c < D / 64; ++c)
          hop::tma_load_4d(base + L::v + st * L::kKV + c * kBK * 128, &tv, bv,
                           c * 64, j * kBK, hk, b);
      }
    }
  } else {
    hop::setmaxnreg_inc<consumer_regs<NC>()>();
    fwd_consumer<D, NC>(p, base, wg, q0, kv_end, ntiles);
  }
}

template <int D, int NC>
cudaError_t start_fwd(const CUtensorMap& tq, const CUtensorMap& tk,
                      const CUtensorMap& tv, const attn_fwd_tc::FwdParams& p,
                      int B, cudaStream_t stream) {
  auto kern = flash_fwd_wg_kernel<D, NC>;
  constexpr size_t smem = FwdSmem<D, NC>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.Nq, (p.Sq + NC * kRowsWG - 1) / (NC * kRowsWG));
  kern<<<grid, 128 * (NC + 1), smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int Nq, int Nkv, int Sq, int Sk,
                       int hd, const int* st, int causal, int q_offset,
                       float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t e =
      hop::bshd_map(&tq, q, B, Sq, Nq, hd, st[0], st[1], st[2], kRowsWG);
  if (e == cudaSuccess)
    e = hop::bshd_map(&tk, k, B, Sk, Nkv, hd, st[3], st[4], st[5], kBK);
  if (e == cudaSuccess)
    e = hop::bshd_map(&tv, v, B, Sk, Nkv, hd, st[6], st[7], st[8], kBK);
  if (e != cudaSuccess) return e;
  const attn_fwd_tc::FwdParams p{static_cast<const bf16*>(q),
                                 static_cast<bf16*>(o),
                                 static_cast<float*>(lse),
                                 Nq, Nkv, Sq, Sk, hd,
                                 st[0], st[1], st[2], st[9], st[10], st[11],
                                 causal, q_offset, scale};
  const bool two = fwd_warpgroups(B, Nq, Sq, hop::sm_count()) == 2;
  if (hd <= 64)
    return two ? start_fwd<64, 2>(tq, tk, tv, p, B, stream)
               : start_fwd<64, 1>(tq, tk, tv, p, B, stream);
  return two ? start_fwd<128, 2>(tq, tk, tv, p, B, stream)
             : start_fwd<128, 1>(tq, tk, tv, p, B, stream);
}

}  // namespace attn_wg
}  // namespace ptt

// every bf16 attention launch on the mma.sync kernels (1), or routed by
// shapes and strides (0): attention_wg.cuh. -1 leaves the flag as it is.
// Returns the flag.
extern "C" int ptt_attention_force_mma_sync(int on) {
  if (on >= 0) ptt::attn_wg::force_mma_sync = on != 0;
  return ptt::attn_wg::force_mma_sync;
}
