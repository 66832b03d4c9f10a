// Warp-level tensor-core building blocks for sm_90a (inline PTX): bf16
// mma.sync m16n8k16 with f32 accumulators, ldmatrix fragment loads from an
// XOR-swizzled shared-memory tile, and cp.async copies into it.
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

}  // namespace tc
}  // namespace ptt
