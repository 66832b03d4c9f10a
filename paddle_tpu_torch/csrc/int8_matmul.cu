// Weight-only int8 dequant-matmul for sm_90a.
//
// Replaces: paddle_tpu/kernels/int8_matmul.py::_mm_kernel (launched by
// int8_matmul through pl.pallas_call). Same function:
// out[M, N] = round_to_T((x[M, K] . float(w)) * scale[N]), x in f32 or
// bf16, w int8, scale f32: the int8 weight is widened in registers, the
// products accumulate in f32, the f32 per-column scale multiplies the f32
// sum, and the result is rounded once to x's dtype.
//
// Two layouts of w, as the serving engine stores its weights:
//   "kn": w[K, N], contiguous along N (wqkv, wo, w1, w2);
//   "nk": w[N, K], contiguous along K (the logits against wte[V, H]).
//
// What bounds it on an H100: at decode (M <= 8) the int8 weight bytes, one
// read of K * N bytes against 2 * M * K * N operations, far below the
// ridge: a weight-streaming kernel. Its design:
//   kn: a block of 256 threads owns 128 columns and one 8-row tile of x;
//       each thread reads 16 columns of one weight row with one 16-byte
//       load (8 threads cover 128 contiguous bytes of a row), widens them
//       and does 8 x 16 FMAs against x rows kept in shared memory as f32.
//       32 k-lanes per block split K; warp shuffles and shared memory sum
//       them. When the grid of column and row tiles is smaller than the
//       card, K is also split across blocks (blockIdx.z): each block writes
//       its f32 partial tile, and the last block to finish a tile (a ticket
//       from an atomic counter, after a memory fence) sums the partials in
//       split order, so the result is the same bits every run.
//   nk: a warp owns 4 output columns (weight rows); its lanes read 16
//       consecutive bytes each along K (512 bytes a warp step), and x is
//       staged in shared memory permuted so that the lanes of a warp read
//       consecutive words. A warp reduces its sums with shuffles.
// Ragged M, N and K are masked in the kernel; a weight that is not 16-byte
// aligned along its contiguous axis is read byte by byte. The CUDA cores do
// the arithmetic in f32 (no tensor cores), so at M = 256 the kernel is
// bound by FMA issue, far from its bound: decode is the path it is for.
#include "common.cuh"

namespace ptt {
namespace {

constexpr int kNT = 256;               // threads per block
constexpr int kMT = 8;                 // rows of x per block
constexpr int kWarps = kNT / 32;
// kn
constexpr int kCG = 8;                 // 16-column groups across a tile
constexpr int kBN = kCG * 16;          // columns per block (128)
constexpr int kKL = kNT / kCG;         // k-lanes per block (32)
// nk
constexpr int kRPW = 4;                // output columns per warp
constexpr int kBNT = kWarps * kRPW;    // output columns per block (32)
constexpr int kKC = 1024;              // K staged in shared memory at a time

// 16 int8 at src (16-byte aligned when vec), widened to f32; bytes at or
// past `valid` read as 0
__device__ __forceinline__ void load_w16(const int8_t* src, bool vec,
                                         int valid, float* dst) {
  if (vec && valid >= 16) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(src));
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      dst[i] = i < valid ? static_cast<float>(src[i]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kNT)
int8_mm_kn_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, T* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters, int M,
                  int N, int K, int x_stride, int chunk, int vec) {
  extern __shared__ float smem[];
  float* xs = smem;                    // [kMT][chunk]
  float* red = xs + kMT * chunk;       // [kWarps][kMT][kBN]
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int cg = tid % kCG;
  const int kl = tid / kCG;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kMT;
  const int ksplit = gridDim.z;
  const int kb = blockIdx.z * chunk;
  const int klen = max(0, min(K, kb + chunk) - kb);

  for (int idx = tid; idx < kMT * chunk; idx += kNT) {
    const int m = idx / chunk, kk = idx % chunk;
    xs[idx] = (m0 + m < M && kk < klen)
                  ? to_float<T>(x[(long long)(m0 + m) * x_stride + kb + kk])
                  : 0.f;
  }
  __syncthreads();

  float acc[kMT][16];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[m][i] = 0.f;

  const int nc = n0 + cg * 16;
  const int valid = min(16, N - nc);   // <= 0: a column group past N
  if (valid > 0) {
    for (int kk = kl; kk < klen; kk += kKL) {
      float wv[16];
      load_w16(w + (long long)(kb + kk) * N + nc, vec, valid, wv);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const float xv = xs[m * chunk + kk];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[m][i] = fmaf(xv, wv[i], acc[m][i]);
      }
    }
  }
  // the 4 k-lanes of a warp that share a column group: lanes cg, cg + 8,
  // cg + 16, cg + 24
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float v = acc[m][i];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][i] = v;
    }
  if (lane < kCG) {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int i = 0; i < 16; ++i)
        red[(warp * kMT + m) * kBN + cg * 16 + i] = acc[m][i];
  }
  __syncthreads();

  const int Mp = gridDim.y * kMT;
  for (int idx = tid; idx < kMT * kBN; idx += kNT) {
    const int m = idx / kBN, c = idx % kBN;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) v += red[(wp * kMT + m) * kBN + c];
    if (m0 + m >= M || n0 + c >= N) continue;
    if (ksplit == 1)
      out[(long long)(m0 + m) * N + n0 + c] = from_float<T>(v * scale[n0 + c]);
    else
      ws[((long long)blockIdx.z * Mp + m0 + m) * N + n0 + c] = v;
  }
  if (ksplit == 1) return;

  // split K: the last block of this tile sums the partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + blockIdx.y * gridDim.x + blockIdx.x;
    const int ticket = atomicAdd(ctr, 1);
    is_last = ticket == ksplit - 1;
    if (is_last) *ctr = 0;             // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int idx = tid; idx < kMT * kBN; idx += kNT) {
    const int m = idx / kBN, c = idx % kBN;
    if (m0 + m >= M || n0 + c >= N) continue;
    float v = 0.f;
    for (int sp = 0; sp < ksplit; ++sp)
      v += __ldcg(ws + ((long long)sp * Mp + m0 + m) * N + n0 + c);
    out[(long long)(m0 + m) * N + n0 + c] = from_float<T>(v * scale[n0 + c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kNT)
int8_mm_nk_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, T* __restrict__ out, int M,
                  int N, int K, int x_stride, int vec) {
  // xs[m][(j * 16 + i) * 32 + lane] holds x[m][kc + j * 512 + lane * 16 + i]
  __shared__ float xs[kMT * kKC];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nw = blockIdx.x * kBNT + warp * kRPW;
  const int m0 = blockIdx.y * kMT;

  float acc[kRPW][kMT];
#pragma unroll
  for (int r = 0; r < kRPW; ++r)
#pragma unroll
    for (int m = 0; m < kMT; ++m) acc[r][m] = 0.f;

  for (int kc = 0; kc < K; kc += kKC) {
    const int klen = min(kKC, K - kc);
    __syncthreads();                   // the previous chunk's readers are done
    for (int idx = tid; idx < kMT * kKC; idx += kNT) {
      const int m = idx / kKC, d = idx % kKC;
      const int j = d / 512, rem = d % 512;
      const int k = j * 512 + (rem % 32) * 16 + rem / 32;
      xs[idx] = (m0 + m < M && k < klen)
                    ? to_float<T>(x[(long long)(m0 + m) * x_stride + kc + k])
                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      const int n = nw + r;
      if (n >= N) break;
      const int8_t* wrow = w + (long long)n * K + kc;
      for (int j = 0; j * 512 < klen; ++j) {
        const int kk = j * 512 + lane * 16;
        if (kk >= klen) continue;
        float wv[16];
        load_w16(wrow + kk, vec, klen - kk, wv);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int off = (j * 16 + i) * 32 + lane;
#pragma unroll
          for (int m = 0; m < kMT; ++m)
            acc[r][m] = fmaf(xs[m * kKC + off], wv[i], acc[r][m]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRPW; ++r)
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      float v = acc[r][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][m] = v;
    }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      const int n = nw + r;
      if (n >= N) break;
      const float sc = scale[n];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        if (m0 + m < M)
          out[(long long)(m0 + m) * N + n] = from_float<T>(acc[r][m] * sc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* s, void* out,
                   void* ws, void* counters, int layout, int M, int N, int K,
                   int x_stride, int ksplit, int vec, cudaStream_t stream) {
  const int mtiles = (M + kMT - 1) / kMT;
  if (layout == 0) {
    const int chunk = (K + ksplit - 1) / ksplit;
    const size_t smem =
        sizeof(float) * ((size_t)kMT * chunk + (size_t)kWarps * kMT * kBN);
    auto kern = int8_mm_kn_kernel<T>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((N + kBN - 1) / kBN, mtiles, ksplit);
    kern<<<grid, kNT, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(s), static_cast<T*>(out),
        static_cast<float*>(ws), static_cast<int*>(counters), M, N, K,
        x_stride, chunk, vec);
  } else {
    const dim3 grid((N + kBNT - 1) / kBNT, mtiles);
    int8_mm_nk_kernel<T><<<grid, kNT, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(s), static_cast<T*>(out), M, N, K, x_stride,
        vec);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptt

// x is [M, K] with unit stride along K (row stride x_stride, in elements);
// w is a contiguous int8 [K, N] (layout 0) or [N, K] (layout 1); scale is
// a contiguous f32 [N]; out is a contiguous [M, N] of x's dtype. Layout 0
// with ksplit > 1 needs ws, an f32 scratch of ksplit * ceil(M / 8) * 8 * N,
// and counters, ceil(M / 8) * ceil(N / 128) int32 that are 0 (the kernel
// leaves them 0). vec says w's rows are 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int ptt_int8_matmul(const void* x, const void* w, const void* s,
                               void* out, void* ws, void* counters, int dtype,
                               int layout, int M, int N, int K, int x_stride,
                               int ksplit, int vec, void* stream) {
  using namespace ptt;
  if (M < 1 || N < 1 || K < 1 || ksplit < 1 || (layout != 0 && layout != 1) ||
      (layout == 1 && ksplit != 1) || (ksplit > 1 && (!ws || !counters)) ||
      (M + kMT - 1) / kMT > 65535 || ksplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(launch<float>(x, w, s, out, ws, counters, layout,
                                          M, N, K, x_stride, ksplit, vec, st));
  if (dtype == kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(
        x, w, s, out, ws, counters, layout, M, N, K, x_stride, ksplit, vec,
        st));
  return static_cast<int>(cudaErrorInvalidValue);
}
