// Fused MoE dispatch and combine for sm_90a.
//
// Replaces: paddle_tpu/kernels/moe_dispatch.py::_dispatch_kernel (launched by
// _dispatch_pallas through pl.pallas_call) and ::_combine_kernel (launched by
// _combine_pallas). Same functions:
//
// Dispatch. Per token s of x [S, M]: f32 logits = x[s] . gate_w + gate_b
// (gate_w [M, E] and gate_b [E], each read in its own stored dtype and
// widened to f32), the f32
// softmax over the E experts, top-k by K masked-argmax rounds over the
// logits (ties to the lowest expert index, as lax.top_k), and the combine
// weight of each choice by gate kind (naive: the logit; switch: the
// probability; gshard: p / (sum of the top-k p + 1e-9); renorm:
// p / max(sum, 1e-9)). Slots follow GShard's rule: every first choice of the
// batch claims a slot of its expert before any second choice, ties in token
// order; a choice past its expert's capacity C keeps comb_idx = E * C (the
// drop sentinel). Token rows land in expert_in [E * C, M] at e * C + slot;
// every slot no token fills is zero. me[e] = mean softmax probability and
// ce[e] = the share of tokens whose first choice is e (the aux-loss sums).
//
// Combine. y[s] = sum_k val[s, k] * eo[comb_idx[s, k]], the sentinel
// skipped, with the Pallas kernel's rounding points: val cast to y's dtype,
// each product and each add rounded to y's dtype, in k order (in f32: no
// fused multiply-add, so the sums are the ones a plain elementwise version
// computes).
//
// Design. The TPU kernel walks a sequential (priority, token block) grid and
// carries the per-expert slot counters in VMEM across it. A GPU grid has no
// order, so the dispatch is three passes on the caller's stream, issued by
// one C entry:
//   1. gate: one warp per token (a block holds 32 tokens) computes the
//      logits (lanes over M, a butterfly sum), lane 0 the softmax, the top-k
//      and val; then per block and priority each expert's count of choices,
//      and per block each expert's sum of probabilities (token order, in
//      f64);
//   2. scan: one warp per expert; an exclusive scan of the counts in
//      (priority, block) order gives each (priority, block)'s first slot of
//      each expert; me and ce are summed in block order and divided by S;
//   3. scatter: one block per (priority, token block): a choice's slot is its
//      block's first slot plus its rank among the block's earlier choices of
//      the same expert (token order); comb_idx is written and the token's row
//      copied (16-byte vectors where rows allow). Further blocks of the same
//      launch zero the rows past each expert's filled slots (slots fill from
//      0 up, so those are the empty ones).
// No atomics (the tie-break is token order) and no host sync: the same bits
// every run.
//
// What bounds them on an H100: bytes. The dispatch reads x and gate_w and
// writes the whole [E * C, M] buffer (at serving C = S, three quarters of it
// zeros for E = 8, k = 2); the combine reads k rows per token and writes y.
// The arithmetic (2 * S * M * E for the gate) is far below the ridge. This
// first version is bound by its launches and, at decode sizes, by the
// latency of each pass, not by the bytes.
#include "common.cuh"

namespace ptt {
namespace {

constexpr int kNT = 256;               // threads per block
constexpr int kWarps = kNT / 32;
constexpr int kTB = 32;                // tokens per block of the gate pass
constexpr int kRowsPerZeroBlock = kWarps;  // one warp per zeroed row

enum GateKind { kNaive = 0, kSwitch = 1, kGShard = 2, kRenorm = 3 };

// the dispatch's scratch (int32 words; the f64 sums are 8-byte aligned)
struct Work {
  int* idx;       // [S, K] chosen experts
  int* counts;    // [K, nblk, E] choices per (priority, block, expert)
  int* base;      // [K, nblk, E] first slot of each
  int* fill;      // [E] filled slots of each expert
  double* me_part;  // [nblk, E] probability sums per block
};

// --------------------------------------------------------------- pass 1

template <typename T, typename W>
__global__ void __launch_bounds__(kNT)
moe_gate_kernel(const T* __restrict__ x, const W* __restrict__ gw,
                const void* __restrict__ gb, int b_bf16,
                float* __restrict__ val, Work wk, int S, int M, int x_rs,
                int E, int K, int nblk, int kind) {
  extern __shared__ float smem[];
  float* lg = smem;                       // [kTB][E] logits
  float* pr = lg + kTB * E;               // [kTB][E] probabilities
  int* ch = reinterpret_cast<int*>(pr + kTB * E);  // [kTB][K] choices

  const int blk = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int t0 = blk * kTB;
  const int nt = min(kTB, S - t0);

  for (int t = warp; t < nt; t += kWarps) {
    const int s = t0 + t;
    const T* xr = x + (long long)s * x_rs;
    for (int e = 0; e < E; ++e) {
      float a = 0.f;
      for (int m = lane; m < M; m += 32)
        a = fmaf(to_float<T>(xr[m]), to_float<W>(gw[(long long)m * E + e]), a);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0)
        lg[t * E + e] =
            a + (b_bf16 ? to_float<__nv_bfloat16>(
                         static_cast<const __nv_bfloat16*>(gb)[e])
                        : static_cast<const float*>(gb)[e]);
    }
    __syncwarp();
    if (lane == 0) {
      float* l = lg + t * E;
      float* p = pr + t * E;
      float mx = l[0];
      for (int e = 1; e < E; ++e) mx = fmaxf(mx, l[e]);
      float sum = 0.f;
      for (int e = 0; e < E; ++e) sum += expf(l[e] - mx);
      for (int e = 0; e < E; ++e) p[e] = expf(l[e] - mx) / sum;
      // K masked-argmax rounds over the logits; a taken expert drops to
      // -1e30 (the TPU kernel's work array), ties go to the lowest index
      float denom = 0.f;
      for (int k = 0; k < K; ++k) {
        int sel = -1;
        float best = 0.f;
        for (int e = 0; e < E; ++e) {
          bool taken = false;
          for (int j = 0; j < k; ++j) taken |= ch[t * K + j] == e;
          const float v = taken ? kNegInf : l[e];
          if (sel < 0 || v > best) {
            sel = e;
            best = v;
          }
        }
        ch[t * K + k] = sel;
        denom += p[sel];
      }
      for (int k = 0; k < K; ++k) {
        const int e = ch[t * K + k];
        float v;
        if (kind == kNaive) v = l[e];
        else if (kind == kSwitch) v = p[e];
        else if (kind == kGShard) v = p[e] / (denom + 1e-9f);
        else v = p[e] / fmaxf(denom, 1e-9f);
        val[(long long)s * K + k] = v;
        wk.idx[(long long)s * K + k] = e;
      }
    }
  }
  __syncthreads();
  // per (priority, expert): this block's choices; per expert: its sum of
  // probabilities over the block's tokens, in token order
  for (int i = threadIdx.x; i < K * E; i += kNT) {
    const int k = i / E, e = i % E;
    int c = 0;
    for (int t = 0; t < nt; ++t) c += ch[t * K + k] == e;
    wk.counts[((long long)k * nblk + blk) * E + e] = c;
  }
  for (int e = threadIdx.x; e < E; e += kNT) {
    double a = 0.0;
    for (int t = 0; t < nt; ++t) a += (double)pr[t * E + e];
    wk.me_part[(long long)blk * E + e] = a;
  }
}

// --------------------------------------------------------------- pass 2

__global__ void __launch_bounds__(kNT)
moe_scan_kernel(Work wk, float* __restrict__ me, float* __restrict__ ce,
                int S, int E, int K, int nblk, int C) {
  __shared__ double part[kWarps][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n = K * nblk;  // (priority, block) in priority-major order
  for (int e = warp; e < E; e += kWarps) {
    int run = 0, first = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const int c = j < n ? wk.counts[(long long)j * E + e] : 0;
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (j < n) wk.base[(long long)j * E + e] = run + incl - c;
      if (j0 < nblk) first += __shfl_sync(0xffffffffu, incl, min(31, nblk - 1 - j0));
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
    double msum = 0.0;
    for (int j0 = 0; j0 < nblk; j0 += 32) {
      part[warp][lane] = j0 + lane < nblk ? wk.me_part[(long long)(j0 + lane) * E + e] : 0.0;
      __syncwarp();
      if (lane == 0)
        for (int i = 0; i < min(32, nblk - j0); ++i) msum += part[warp][i];
      __syncwarp();
    }
    if (lane == 0) {
      wk.fill[e] = min(run, C);
      me[e] = (float)msum / (float)S;
      ce[e] = (float)first / (float)S;
    }
  }
}

// --------------------------------------------------------------- pass 3

template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int M, bool vec, int lane) {
  if (vec) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = lane; i < M / Vec<T>::N; i += 32) d[i] = s[i];
  } else {
    for (int i = lane; i < M; i += 32) dst[i] = src[i];
  }
}

template <typename T>
__device__ __forceinline__ void zero_row(T* dst, int M, bool vec, int lane) {
  if (vec) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = lane; i < M / Vec<T>::N; i += 32) d[i] = make_uint4(0, 0, 0, 0);
  } else {
    for (int i = lane; i < M; i += 32) dst[i] = from_float<T>(0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kNT)
moe_scatter_kernel(const T* __restrict__ x, T* __restrict__ out,
                   int* __restrict__ comb, Work wk, int S, int M, int x_rs,
                   int E, int K, int C, int nblk, int vec) {
  __shared__ int ch[kTB];
  __shared__ long long dst[kTB];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (blockIdx.x >= K * nblk) {  // zero the rows past each expert's fill
    const long long row = (long long)(blockIdx.x - K * nblk) * kRowsPerZeroBlock + warp;
    if (row < (long long)E * C && row % C >= wk.fill[row / C])
      zero_row(out + row * M, M, vec, lane);
    return;
  }
  const int k = blockIdx.x / nblk;
  const int blk = blockIdx.x % nblk;
  const int t0 = blk * kTB;
  const int nt = min(kTB, S - t0);
  if (threadIdx.x < nt) ch[threadIdx.x] = wk.idx[(long long)(t0 + threadIdx.x) * K + k];
  __syncthreads();
  if (threadIdx.x < nt) {
    const int t = threadIdx.x;
    const int e = ch[t];
    int rank = 0;
    for (int u = 0; u < t; ++u) rank += ch[u] == e;
    const int slot = wk.base[((long long)k * nblk + blk) * E + e] + rank;
    const bool kept = slot < C;
    comb[(long long)(t0 + t) * K + k] = kept ? e * C + slot : E * C;
    dst[t] = kept ? (long long)e * C + slot : -1;
  }
  __syncthreads();
  for (int t = warp; t < nt; t += kWarps)
    if (dst[t] >= 0) copy_row(out + dst[t] * M, x + (long long)(t0 + t) * x_rs, M, vec, lane);
}

// ------------------------------------------------------------- combine

template <typename T>
__global__ void __launch_bounds__(kNT)
moe_combine_kernel(const T* __restrict__ eo, const float* __restrict__ val,
                   const int* __restrict__ comb, T* __restrict__ y, int S,
                   int M, int K, int EC, int vec) {
  constexpr int VEC = Vec<T>::N;
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarps + threadIdx.x / 32;
  if (s >= S) return;
  T* yr = y + (long long)s * M;
  const int step = vec ? VEC : 1;
  for (int c = lane * step; c < M; c += 32 * step) {
    const int n = vec ? VEC : 1;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      const int r = comb[(long long)s * K + k];
      if (r >= EC) continue;  // dropped: contributes nothing
      const float w = round_to<T>(val[(long long)s * K + k]);
      const T* er = eo + (long long)r * M + c;
      float e[VEC];
      if (vec) load16(er, e);
      else e[0] = to_float<T>(er[0]);
      for (int i = 0; i < n; ++i)
        acc[i] = round_to<T>(__fadd_rn(acc[i], round_to<T>(__fmul_rn(w, e[i]))));
    }
    if (vec) {
      alignas(16) T o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = from_float<T>(acc[i]);
      *reinterpret_cast<uint4*>(yr + c) = *reinterpret_cast<const uint4*>(o);
    } else {
      yr[c] = from_float<T>(acc[0]);
    }
  }
}

template <typename T, typename W>
cudaError_t launch_dispatch(const void* x, const void* gw, const void* gb,
                            int bdtype,
                            void* out, void* comb, void* val, void* me,
                            void* ce, void* work, int S, int M, int x_rs,
                            int E, int K, int C, int kind, int vec,
                            cudaStream_t stream) {
  const int nblk = (S + kTB - 1) / kTB;
  Work wk;
  int* w = static_cast<int*>(work);
  wk.idx = w;
  wk.counts = wk.idx + (long long)S * K;
  wk.base = wk.counts + (long long)K * nblk * E;
  wk.fill = wk.base + (long long)K * nblk * E;
  long long off = (long long)S * K + 2LL * K * nblk * E + E;
  off += off & 1;  // 8-byte alignment of the f64 sums
  wk.me_part = reinterpret_cast<double*>(w + off);

  const size_t smem = sizeof(float) * 2 * kTB * E + sizeof(int) * kTB * K;
  auto gate = moe_gate_kernel<T, W>;
  cudaError_t e = cudaFuncSetAttribute(
      gate, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  gate<<<nblk, kNT, smem, stream>>>(static_cast<const T*>(x),
                                    static_cast<const W*>(gw),
                                    gb, bdtype == kBF16,
                                    static_cast<float*>(val), wk, S, M, x_rs,
                                    E, K, nblk, kind);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  moe_scan_kernel<<<1, kNT, 0, stream>>>(wk, static_cast<float*>(me),
                                         static_cast<float*>(ce), S, E, K,
                                         nblk, C);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long zero_blocks =
      ((long long)E * C + kRowsPerZeroBlock - 1) / kRowsPerZeroBlock;
  const long long grid = (long long)K * nblk + zero_blocks;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  moe_scatter_kernel<T><<<(unsigned)grid, kNT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<int*>(comb),
      wk, S, M, x_rs, E, K, C, nblk, vec);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptt

// Scratch words (int32) the dispatch needs for S tokens, E experts, top-K.
static long long moe_dispatch_work_words(int S, int E, int K) {
  const long long nblk = (S + ptt::kTB - 1) / ptt::kTB;
  long long off = (long long)S * K + 2LL * K * nblk * E + E;
  off += off & 1;
  return off + 2LL * nblk * E;
}

// The dispatch. x is [S, M] with unit stride along M and row stride x_rs
// (elements); gate_w [M, E] (in wdtype) and gate_b [E] (in bdtype) are
// contiguous; out
// ([E * C, M], x's dtype), comb ([S, K] int32), val ([S, K] f32), me and ce
// ([E] f32) are contiguous; work is int32 scratch of work_words words
// (at least S*K + 2*K*nblk*E + E, rounded up to even, + 2*nblk*E, with
// nblk = ceil(S / 32)), 8-byte aligned. vec != 0: rows of out and x are
// 16-byte aligned (M * itemsize and x_rs * itemsize multiples of 16). kind:
// 0 naive, 1 switch, 2 gshard, 3 renorm. Three launches on the stream;
// returns cudaGetLastError() after the last.
extern "C" int ptt_moe_dispatch(const void* x, const void* gw, const void* gb,
                                void* out, void* comb, void* val, void* me,
                                void* ce, void* work, long long work_words,
                                int dtype, int wdtype, int bdtype, int S,
                                int M, int x_rs,
                                int E, int K, int C, int kind, int vec,
                                void* stream) {
  using namespace ptt;
  if (S < 1 || M < 1 || E < 1 || E > 512 || K < 1 || K > E || C < 1 ||
      kind < 0 || kind > 3 || (bdtype != kF32 && bdtype != kBF16) ||
      work_words < moe_dispatch_work_words(S, E, K))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == kF32 && wdtype == kF32)
    e = launch_dispatch<float, float>(x, gw, gb, bdtype, out, comb, val, me, ce, work, S, M, x_rs, E, K, C, kind, vec, s);
  else if (dtype == kF32 && wdtype == kBF16)
    e = launch_dispatch<float, __nv_bfloat16>(x, gw, gb, bdtype, out, comb, val, me, ce, work, S, M, x_rs, E, K, C, kind, vec, s);
  else if (dtype == kBF16 && wdtype == kF32)
    e = launch_dispatch<__nv_bfloat16, float>(x, gw, gb, bdtype, out, comb, val, me, ce, work, S, M, x_rs, E, K, C, kind, vec, s);
  else if (dtype == kBF16 && wdtype == kBF16)
    e = launch_dispatch<__nv_bfloat16, __nv_bfloat16>(x, gw, gb, bdtype, out, comb, val, me, ce, work, S, M, x_rs, E, K, C, kind, vec, s);
  return static_cast<int>(e);
}

// The combine. eo is a contiguous [EC, M], val [S, K] f32 and comb [S, K]
// int32 contiguous, y a contiguous [S, M] in eo's dtype; vec != 0: rows are
// 16-byte aligned. One launch; returns cudaGetLastError() after it.
extern "C" int ptt_moe_combine(const void* eo, const void* val,
                               const void* comb, void* y, int dtype, int S,
                               int M, int K, int EC, int vec, void* stream) {
  using namespace ptt;
  if (S < 1 || M < 1 || K < 1 || EC < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((S + kWarps - 1) / kWarps);
  if (dtype == kF32) {
    moe_combine_kernel<float><<<grid, kNT, 0, s>>>(
        static_cast<const float*>(eo), static_cast<const float*>(val),
        static_cast<const int*>(comb), static_cast<float*>(y), S, M, K, EC, vec);
  } else if (dtype == kBF16) {
    moe_combine_kernel<__nv_bfloat16><<<grid, kNT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(eo), static_cast<const float*>(val),
        static_cast<const int*>(comb), static_cast<__nv_bfloat16*>(y), S, M, K,
        EC, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
