// The bf16 attention kernels on Hopper's warpgroup MMA (wgmma), fed by TMA
// through an mbarrier ring by a producer warp: the flash forward
// (flash_attention_fwd_wg.cu) and the dK/dV pass of the backward
// (flash_attention_bwd_wg.cu), and the rule that routes a launch to them.
//
// Route. A bf16 launch runs the wgmma kernel when TMA can describe every
// operand it loads (hop::tma_view: a 16-byte aligned base and strides a
// multiple of 8 elements; q, k, v, and dO for the backward), and the
// mma.sync kernel of attention_fwd_tc.cuh / flash_attention_bwd_tc.cuh
// otherwise (e.g. a head dim whose rows are not 16-byte multiples). The
// rule reads shapes and strides only and never a failed launch; the
// Python mirror is kernels/flash_attention.py::kernel_route. f32 keeps the
// CUDA-core kernels. ptt_attention_force_mma_sync(1) sends every bf16
// launch to the mma.sync kernels (the yardstick the smoke, the card tests
// and the tools hold the wgmma kernels against; no launch of the program
// sets it), (0) restores the rule, (-1) reads it.
#pragma once

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace ptt {
namespace attn_wg {

extern int force_mma_sync;

// positions of the forward's K/V tiles, rows of a consumer warpgroup
constexpr int kFwdBK = 128;
constexpr int kRowsWG = 64;

// the forward's consumer warpgroups (64 query rows each) for B * Nq heads
// of Sq rows on sms SMs: two (128-row blocks) when those fill the card,
// else one (64-row blocks, twice the blocks)
inline int fwd_warpgroups(int B, int Nq, int Sq, int sms) {
  return (long long)B * Nq * ((Sq + 2 * kRowsWG - 1) / (2 * kRowsWG)) >= sms
             ? 2
             : 1;
}

// do the wgmma kernels take these [B, S, N, hd] views (pointers p[i],
// strides st[3 i .. 3 i + 2]: batch, row, head)?
inline bool takes(const void* const* p, const int* st, int n) {
  if (force_mma_sync) return false;
  for (int i = 0; i < n; ++i)
    if (!hop::tma_view(p[i], st[3 * i], st[3 * i + 1], st[3 * i + 2]))
      return false;
  return true;
}

// the flash forward: q/k/v/o [B, S, N, hd] views, strides st as
// ptt_flash_attention_fwd takes them (q, k, v, o; batch, row, head)
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int Nq, int Nkv, int Sq, int Sk,
                       int hd, const int* st, int causal, int q_offset,
                       float scale, cudaStream_t stream);

// the dK/dV pass: strides st as ptt_flash_attention_bwd_dkv takes them
// (q, k, v, do, dk, dv; batch, row, head)
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Nq, int Nkv, int Sq,
                       int Sk, int hd, const int* st, int causal,
                       int q_offset, float scale, cudaStream_t stream);

}  // namespace attn_wg
}  // namespace ptt
