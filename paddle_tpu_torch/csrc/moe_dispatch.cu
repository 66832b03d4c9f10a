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
// order, and a slot depends on every earlier choice of the batch. The
// dispatch has two routes, one C entry; the wrapper picks one from the
// shapes (kernels/moe_dispatch.py, dispatch_route):
//
// One launch (decode sizes, E <= 32). Every block routes all S tokens
// itself, in shared memory, and then writes its own share of the [E * C, M]
// rows as a gather, so no block waits on or talks to another (no cluster, no
// workspace, no atomics):
//   1. gate_w is copied once into shared memory, its rows padded to 8, 16
//      or 32 experts, where it fits beside the routing's arrays (else it is
//      read from device memory); one warp per token, lanes on consecutive
//      m, so a warp's reads of the staged rows are contiguous and free of
//      bank conflicts, E f32 sums a lane in one pass over M; a butterfly
//      sum finishes each logit;
//   2. one lane per expert: the softmax and the K arg-max rounds by warp
//      shuffles (ties to the lowest index), val by lane k;
//   3. one warp: a choice's slot is the count of its expert's earlier
//      choices in priority-major order, by __match_any_sync and popcounts
//      over 32 choices at a time; then each expert's filled slots list
//      their tokens in slot order;
//   4. each warp of the grid copies a row of x into its slot, or zeroes a
//      slot past its expert's fill (16-byte vectors where rows allow);
//   5. block 0 also writes comb_idx, val, the chosen experts, me (an f64
//      sum in token order) and ce.
// Every block computes the routing with the same instructions on the same
// inputs, so all agree bit for bit.
//
// Three passes (larger S, or E > 32), on the caller's stream:
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
// every run, on either route.
//
// The combine gives each warp one token and one chunk of 32 16-byte column
// vectors, so a decode batch spreads over several SMs; a warp reads its
// token's K indices and weights once (a lane each, broadcast by shuffles)
// and issues up to 8 row loads before its first add.
//
// What bounds them on an H100: bytes. The dispatch reads x and gate_w and
// writes the whole [E * C, M] buffer (at serving C = S, three quarters of it
// zeros for E = 8, k = 2); the combine reads k rows per token and writes y.
// The arithmetic (2 * S * M * E for the gate) is far below the ridge. At
// decode sizes both move a few tens of KB, so their time is a launch and
// the latency of a few dependent loads, which is what the one-launch route
// and the combine's grid are for.
#include <atomic>

#include "common.cuh"

namespace ptt {
namespace {

constexpr int kNT = 256;               // threads per block
constexpr int kWarps = kNT / 32;
constexpr int kTB = 32;                // tokens per block of the gate pass
constexpr int kRowsPerZeroBlock = kWarps;  // one warp per zeroed row
constexpr int kMaxE = 512;             // the gate pass keeps 2 x 32 x E floats
constexpr int kOneMaxE = 32;           // the one-launch route: a lane an expert
constexpr int kOneMaxGrid = 64;        // its blocks, each routing all S tokens
constexpr int kStaticSmem = 48 * 1024; // dynamic shared memory without opt-in
constexpr int kCombineWarps = 4;       // warps per block of the combine

enum GateKind { kNaive = 0, kSwitch = 1, kGShard = 2, kRenorm = 3 };

__device__ __forceinline__ float gate_bias(const void* gb, int b_bf16, int e) {
  return b_bf16 ? to_float<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(gb)[e])
                : static_cast<const float*>(gb)[e];
}

// the combine weight of a choice of probability p and logit l, by gate kind,
// with denom the sum of the token's top-k probabilities
__device__ __forceinline__ float gate_value(int kind, float l, float p, float denom) {
  if (kind == kNaive) return l;
  if (kind == kSwitch) return p;
  if (kind == kGShard) return p / (denom + 1e-9f);
  return p / fmaxf(denom, 1e-9f);
}

template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int M, bool vec, int lane) {
  if (vec) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (int i = lane; i < M / Vec<T>::N; i += 32) d[i] = __ldg(s + i);
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

// ------------------------------------------------------- the one launch

// 32-bit words of the one-launch kernel's routing arrays in shared memory,
// rounded up to 16 bytes: where the staged gate_w starts
__host__ __device__ inline long long one_launch_stage_at(int S, int E, int K) {
  return (3LL * S * K + (long long)S * E + 2 * kOneMaxE + 3) & ~3LL;
}

inline bool one_launch_fits(int S, int E, int K) {
  return E <= kOneMaxE && one_launch_stage_at(S, E, K) * 4 <= kStaticSmem;
}

// the expert-count instance of E: 8, 16 or 32 lanes
inline int one_launch_ep(int E) { return E <= 8 ? 8 : E <= 16 ? 16 : 32; }

// bytes of gate_w staged in shared memory, rows padded to EP experts (0
// when it does not fit beside the routing's arrays)
template <typename W>
long long one_launch_stage_bytes(int S, int M, int E, int K) {
  const long long bytes = (long long)M * one_launch_ep(E) * sizeof(W);
  return 4 * one_launch_stage_at(S, E, K) + bytes <= kStaticSmem ? bytes : 0;
}

// acc[e] += xv * gate_w[m][e] for the EP experts (0 past E): row m from the
// staged copy (STAGE, 16-byte loads of a row EP wide) or from gate_w
template <typename W, int EP, bool STAGE>
__device__ __forceinline__ void gate_fma(float xv, int m, const W* gws,
                                         const W* __restrict__ gw, int E,
                                         float* acc) {
  constexpr int VW = Vec<W>::N;
  float w[EP];
  if constexpr (STAGE) {
#pragma unroll
    for (int v = 0; v < EP / VW; ++v) {
      const uint4 raw = reinterpret_cast<const uint4*>(gws + m * EP)[v];
      const W* r = reinterpret_cast<const W*>(&raw);
#pragma unroll
      for (int j = 0; j < VW; ++j) w[v * VW + j] = to_float<W>(r[j]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < EP; ++e)
      w[e] = e < E ? to_float<W>(__ldg(gw + (long long)m * E + e)) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < EP; ++e) acc[e] = fmaf(xv, w[e], acc[e]);
}

template <typename T, typename W, int EP, bool STAGE>
__global__ void __launch_bounds__(kNT)
moe_dispatch_one_kernel(const T* __restrict__ x, const W* __restrict__ gw,
                        const void* __restrict__ gb, int b_bf16,
                        T* __restrict__ out, int* __restrict__ comb,
                        float* __restrict__ val, float* __restrict__ me,
                        float* __restrict__ ce, int* __restrict__ idx, int S,
                        int M, int x_rs, int E, int K, int C, int kind,
                        int vec, int wvec) {
  constexpr int VW = Vec<W>::N;
  const float none = __int_as_float(0xff800000);  // -inf: no expert
  extern __shared__ __align__(16) int sm[];
  int* ch = sm;                          // [S][K] chosen experts
  int* slot = ch + S * K;                // [K][S] slots, priority-major
  int* list = slot + S * K;              // filled slots' tokens, by expert
  float* pr = reinterpret_cast<float*>(list + S * K);  // [S][E] probabilities
  int* fill = reinterpret_cast<int*>(pr + S * E);      // [kOneMaxE]
  int* first = fill + kOneMaxE;          // [kOneMaxE] list offset of each expert
  W* gws = reinterpret_cast<W*>(sm + one_launch_stage_at(S, E, K));  // [M][EP]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const bool lead = blockIdx.x == 0;     // writes the small outputs

  // the bias of lane e's expert, loaded before gate_w is staged so that
  // the latencies overlap
  const float bias = lane < E ? gate_bias(gb, b_bf16, lane) : 0.f;
  if constexpr (STAGE) {                 // gate_w into shared memory, once
    if (wvec) {                          // E == EP: rows as they are
      const int n = M * EP / VW;
      for (int i = threadIdx.x; i < n; i += kNT)
        reinterpret_cast<uint4*>(gws)[i] = __ldg(reinterpret_cast<const uint4*>(gw) + i);
    } else {
      for (int i = threadIdx.x; i < M * EP; i += kNT) {
        const int m = i / EP, e = i % EP;
        gws[i] = e < E ? gw[(long long)m * E + e] : from_float<W>(0.f);
      }
    }
    __syncthreads();
  }

  // 1-2: route every token, one warp each; lanes on consecutive m, so the
  // rows of gate_w a warp reads at a step are contiguous
  for (int t = warp; t < S; t += kWarps) {
    float acc[EP];
#pragma unroll
    for (int e = 0; e < EP; ++e) acc[e] = 0.f;
    const T* xr = x + (long long)t * x_rs;
#pragma unroll 8
    for (int m = lane; m < M; m += 32)
      gate_fma<W, EP, STAGE>(to_float<T>(xr[m]), m, gws, gw, E, acc);
    float l = 0.f;                      // lane e: expert e's logit
#pragma unroll
    for (int e = 0; e < EP; ++e) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
      if (lane == e) l = acc[e];
    }
    // from here lanes e < EP hold the experts: the reductions below run
    // within groups of EP lanes, and group 0's result is the one read
    const bool mine = lane < E;
    l += bias;
    float mx = mine ? l : none;
#pragma unroll
    for (int off = EP / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float ex = mine ? expf(l - mx) : 0.f;
    float sum = ex;
#pragma unroll
    for (int off = EP / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float p = ex / sum;
    if (mine) pr[t * E + lane] = p;
    // K masked-argmax rounds over the logits; a taken expert drops to
    // -1e30 (the TPU kernel's work array), ties go to the lowest index
    float work = mine ? l : none;
    float denom = 0.f, my_p = 0.f, my_l = 0.f;
    int my_e = 0;
    for (int k = 0; k < K; ++k) {
      float bv = work;
      int bi = lane;
#pragma unroll
      for (int off = EP / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      bi = __shfl_sync(0xffffffffu, bi, 0);
      const float pk = __shfl_sync(0xffffffffu, p, bi);
      const float lk = __shfl_sync(0xffffffffu, l, bi);
      if (lane == bi) work = kNegInf;
      if (lane == k) {
        my_e = bi;
        my_p = pk;
        my_l = lk;
      }
      denom += pk;
    }
    if (lane < K) {
      ch[t * K + lane] = my_e;
      if (lead) {
        val[(long long)t * K + lane] = gate_value(kind, my_l, my_p, denom);
        idx[(long long)t * K + lane] = my_e;
      }
    }
  }
  __syncthreads();

  // 3: slots, one warp over the choices in priority-major order
  const int n = S * K;
  if (warp == 0) {
    int count = 0;                      // lane e: expert e's choices so far
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const bool ok = j < n;
      const int e = ok ? ch[(j % S) * K + j / S] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, e);
      const int before = __shfl_sync(0xffffffffu, count, ok ? e : 0);
      if (ok) slot[j] = before + __popc(peers & ((1u << lane) - 1u));
      for (int x2 = 0; x2 < E; ++x2) {
        const unsigned b = __ballot_sync(0xffffffffu, e == x2);
        if (lane == x2) count += __popc(b);
      }
    }
    const int f = lane < E ? min(count, C) : 0;
    int incl = f;                       // exclusive scan of the fills
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    fill[lane] = f;
    first[lane] = incl - f;
    __syncwarp();
    for (int j = lane; j < n; j += 32) {
      const int s = j % S, k = j / S;
      const int e = ch[s * K + k];
      const int sl = slot[j];
      if (sl < C) list[first[e] + sl] = s;
      if (lead) comb[(long long)s * K + k] = sl < C ? e * C + sl : E * C;
    }
  }
  if (lead && threadIdx.x >= 32 && threadIdx.x < 32 + E) {
    const int e = threadIdx.x - 32;
    double a = 0.0;
    int c = 0;
    for (int t = 0; t < S; ++t) {
      a += (double)pr[t * E + e];
      c += ch[t * K] == e;
    }
    me[e] = (float)a / (float)S;
    ce[e] = (float)c / (float)S;
  }
  __syncthreads();

  // 4: this block's share of the rows, a warp each
  const long long rows = (long long)E * C;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows;
       r += (long long)gridDim.x * kWarps) {
    const int e = (int)(r / C);
    const int sl = (int)(r - (long long)e * C);
    T* dst = out + r * M;
    if (sl < fill[e])
      copy_row(dst, x + (long long)list[first[e] + sl] * x_rs, M, vec, lane);
    else
      zero_row(dst, M, vec, lane);
  }
}

template <typename T, typename W, int EP>
cudaError_t launch_one(const void* x, const void* gw, const void* gb,
                       int b_bf16, void* out, void* comb, void* val, void* me,
                       void* ce, void* idx, int S, int M, int x_rs, int E,
                       int K, int C, int kind, int vec, cudaStream_t stream) {
  const long long rows = (long long)E * C;
  const long long want = (rows + kWarps - 1) / kWarps;
  const int grid = (int)(want < kOneMaxGrid ? want : kOneMaxGrid);
  const long long stage = one_launch_stage_bytes<W>(S, M, E, K);
  const size_t smem = 4 * one_launch_stage_at(S, E, K) + stage;
  // gate_w copied by 16-byte vectors: E == EP and a 16-byte aligned base
  const int wvec = E == EP && reinterpret_cast<uintptr_t>(gw) % 16 == 0;
  auto kernel = stage ? moe_dispatch_one_kernel<T, W, EP, true>
                      : moe_dispatch_one_kernel<T, W, EP, false>;
  kernel<<<grid, kNT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(gw), gb, b_bf16,
      static_cast<T*>(out), static_cast<int*>(comb), static_cast<float*>(val),
      static_cast<float*>(me), static_cast<float*>(ce), static_cast<int*>(idx),
      S, M, x_rs, E, K, C, kind, vec, wvec);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_one_e(const void* x, const void* gw, const void* gb,
                         int b_bf16, void* out, void* comb, void* val,
                         void* me, void* ce, void* idx, int S, int M,
                         int x_rs, int E, int K, int C, int kind, int vec,
                         cudaStream_t stream) {
  const int ep = one_launch_ep(E);
  if (ep == 8)
    return launch_one<T, W, 8>(x, gw, gb, b_bf16, out, comb, val, me, ce, idx,
                               S, M, x_rs, E, K, C, kind, vec, stream);
  if (ep == 16)
    return launch_one<T, W, 16>(x, gw, gb, b_bf16, out, comb, val, me, ce, idx,
                                S, M, x_rs, E, K, C, kind, vec, stream);
  return launch_one<T, W, 32>(x, gw, gb, b_bf16, out, comb, val, me, ce, idx,
                              S, M, x_rs, E, K, C, kind, vec, stream);
}

// ------------------------------------------------------ three passes

// the three-pass dispatch's scratch (int32 words; the f64 sums are 8-byte
// aligned)
struct Work {
  int* idx;       // [S, K] chosen experts (the caller's output)
  int* counts;    // [K, nblk, E] choices per (priority, block, expert)
  int* base;      // [K, nblk, E] first slot of each
  int* fill;      // [E] filled slots of each expert
  double* me_part;  // [nblk, E] probability sums per block
};

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
        // written out: through gate_value this kernel ran ~10% slower on an
        // H100 (tools/torch_moe_stats.py, variant gate_helpers)
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

// Lift a kernel's dynamic shared memory limit to what E = kMaxE needs,
// once per device (a function attribute holds per device) and only when
// `bytes` needs it; `done` is the kernel's own set of devices.
cudaError_t allow_smem_once(const void* kernel, int bytes,
                            std::atomic<unsigned long long>& done) {
  if (bytes <= kStaticSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev % 64);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)(sizeof(float) * 2 * kTB * kMaxE + sizeof(int) * kTB * kMaxE));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <typename T, typename W>
cudaError_t launch_three(const void* x, const void* gw, const void* gb,
                         int b_bf16, void* out, void* comb, void* val,
                         void* me, void* ce, void* idx, void* work, int S,
                         int M, int x_rs, int E, int K, int C, int kind,
                         int vec, cudaStream_t stream) {
  const int nblk = (S + kTB - 1) / kTB;
  Work wk;
  int* w = static_cast<int*>(work);
  wk.idx = static_cast<int*>(idx);
  wk.counts = w;
  wk.base = wk.counts + (long long)K * nblk * E;
  wk.fill = wk.base + (long long)K * nblk * E;
  long long off = 2LL * K * nblk * E + E;
  off += off & 1;  // 8-byte alignment of the f64 sums
  wk.me_part = reinterpret_cast<double*>(w + off);

  const size_t smem = sizeof(float) * 2 * kTB * E + sizeof(int) * kTB * K;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t e = allow_smem_once(reinterpret_cast<const void*>(moe_gate_kernel<T, W>),
                                  (int)smem, smem_set);
  if (e != cudaSuccess) return e;
  moe_gate_kernel<T, W><<<nblk, kNT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(gw), gb, b_bf16,
      static_cast<float*>(val), wk, S, M, x_rs, E, K, nblk, kind);
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

// ------------------------------------------------------------- combine

template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
moe_combine_kernel(const T* __restrict__ eo, const float* __restrict__ val,
                   const int* __restrict__ comb, T* __restrict__ y, int S,
                   int M, int K, int EC, int vec, int chunks) {
  constexpr int VEC = Vec<T>::N;
  constexpr int G = 8;                  // row loads in flight per warp
  const int lane = threadIdx.x % 32;
  const long long wid = (long long)blockIdx.x * kCombineWarps + threadIdx.x / 32;
  if (wid >= (long long)S * chunks) return;
  const int s = (int)(wid / chunks);
  const int per = vec ? VEC : 1;
  const int c = ((int)(wid % chunks) * 32 + lane) * per;  // this lane's column
  const bool live = c < M;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int nk = min(32, K - k0);
    int r_l = EC;                       // lane k: choice k0 + k's row, weight
    float w_l = 0.f;
    if (lane < nk) {
      r_l = comb[(long long)s * K + k0 + lane];
      w_l = val[(long long)s * K + k0 + lane];
    }
    for (int g = 0; g < nk; g += G) {
      float e[G][VEC];
      int r[G];
      float w[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        r[i] = __shfl_sync(0xffffffffu, r_l, (g + i) & 31);
        w[i] = round_to<T>(__shfl_sync(0xffffffffu, w_l, (g + i) & 31));
        const bool use = g + i < nk && r[i] < EC && live;
        const T* er = eo + (long long)(use ? r[i] : 0) * M + c;
        if (use && vec) {
          load16(er, e[i]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) e[i][j] = 0.f;
          if (use) e[i][0] = to_float<T>(er[0]);
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (g + i >= nk || r[i] >= EC) continue;  // dropped: adds nothing
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[j] = round_to<T>(__fadd_rn(acc[j], round_to<T>(__fmul_rn(w[i], e[i][j]))));
      }
    }
  }
  if (!live) return;
  T* yr = y + (long long)s * M + c;
  if (vec) {
    alignas(16) T o[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = from_float<T>(acc[i]);
    *reinterpret_cast<uint4*>(yr) = *reinterpret_cast<const uint4*>(o);
  } else {
    yr[0] = from_float<T>(acc[0]);
  }
}

}  // namespace
}  // namespace ptt

// Scratch words (int32) the three-pass dispatch needs for S tokens, E
// experts, top-K; the one-launch route needs none.
static long long moe_dispatch_work_words(int S, int E, int K) {
  const long long nblk = (S + ptt::kTB - 1) / ptt::kTB;
  long long off = 2LL * K * nblk * E + E;
  off += off & 1;
  return off + 2LL * nblk * E;
}

// The dispatch. x is [S, M] with unit stride along M and row stride x_rs
// (elements); gate_w [M, E] (in wdtype) and gate_b [E] (in bdtype) are
// contiguous; out ([E * C, M], x's dtype), comb and idx ([S, K] int32), val
// ([S, K] f32), me and ce ([E] f32) are contiguous; idx receives the chosen
// experts. route 0: one launch, no scratch (E <= 32 and its shared memory
// within 48 KB, else cudaErrorInvalidValue); route 1: three launches over
// work, int32 scratch of work_words words (at least
// 2*K*nblk*E + E, rounded up to even, + 2*nblk*E, with nblk = ceil(S / 32)),
// 8-byte aligned. vec != 0: rows of out and x are 16-byte aligned (M *
// itemsize and x_rs * itemsize multiples of 16). kind: 0 naive, 1 switch,
// 2 gshard, 3 renorm. Returns cudaGetLastError() after the last launch.
extern "C" int ptt_moe_dispatch(const void* x, const void* gw, const void* gb,
                                void* out, void* comb, void* val, void* me,
                                void* ce, void* idx, void* work,
                                long long work_words, int dtype, int wdtype,
                                int bdtype, int S, int M, int x_rs, int E,
                                int K, int C, int kind, int vec, int route,
                                void* stream) {
  using namespace ptt;
  if (S < 1 || M < 1 || E < 1 || E > kMaxE || K < 1 || K > E || C < 1 ||
      kind < 0 || kind > 3 || (bdtype != kF32 && bdtype != kBF16) ||
      (route == 0 && !one_launch_fits(S, E, K)) ||
      (route == 1 && work_words < moe_dispatch_work_words(S, E, K)) ||
      route < 0 || route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int bb = bdtype == kBF16;
  auto go = [&](auto tx, auto tw) -> cudaError_t {
    using T = typename decltype(tx)::type;
    using W = typename decltype(tw)::type;
    if (route == 0)
      return launch_one_e<T, W>(x, gw, gb, bb, out, comb, val, me, ce, idx, S,
                                M, x_rs, E, K, C, kind, vec, s);
    return launch_three<T, W>(x, gw, gb, bb, out, comb, val, me, ce, idx,
                              work, S, M, x_rs, E, K, C, kind, vec, s);
  };
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == kF32 && wdtype == kF32)
    e = go(Tag<float>{}, Tag<float>{});
  else if (dtype == kF32 && wdtype == kBF16)
    e = go(Tag<float>{}, Tag<__nv_bfloat16>{});
  else if (dtype == kBF16 && wdtype == kF32)
    e = go(Tag<__nv_bfloat16>{}, Tag<float>{});
  else if (dtype == kBF16 && wdtype == kBF16)
    e = go(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
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
  auto go = [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    const int per = vec ? Vec<T>::N : 1;
    const int chunks = (M + 32 * per - 1) / (32 * per);
    const long long warps = (long long)S * chunks;
    const long long grid = (warps + kCombineWarps - 1) / kCombineWarps;
    if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    moe_combine_kernel<T><<<(unsigned)grid, kCombineWarps * 32, 0, s>>>(
        static_cast<const T*>(eo), static_cast<const float*>(val),
        static_cast<const int*>(comb), static_cast<T*>(y), S, M, K, EC, vec,
        chunks);
    return cudaGetLastError();
  };
  if (dtype == kF32) return static_cast<int>(go(Tag<float>{}));
  if (dtype == kBF16) return static_cast<int>(go(Tag<__nv_bfloat16>{}));
  return static_cast<int>(cudaErrorInvalidValue);
}
