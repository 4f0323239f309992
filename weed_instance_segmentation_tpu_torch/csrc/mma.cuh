// Warp-level tensor-core helpers for sm_90a, as inline PTX: ldmatrix from
// shared memory, mma.sync m16n8k16 in bf16 with f32 accumulation, cp.async
// copies into shared memory, bf16x2 packing, and the two products of a warp's
// 16 rows with rows staged in shared memory (mma_rows_t, mma_rows) that the
// attention kernels share.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4); each 32-bit
// register holds two adjacent columns, the lower column in the low half:
//   A (16 x 16, row major):  a0 (g, 2t)  a1 (g + 8, 2t)  a2 (g, 2t + 8)  a3 (g + 8, 2t + 8)
//   B (16 x 8, k x n):       b0 (2t, g)  b1 (2t + 8, g)
//   C (16 x 8, f32):         c0, c1 (g, 2t and 2t + 1)   c2, c3 (g + 8, 2t and 2t + 1)
// So the C fragments of two adjacent n8 tiles, packed to bf16x2, are the A
// fragment of one k16 step: a0 = (c0, c1) and a1 = (c2, c3) of the first tile,
// a2 and a3 the same of the second.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16_t = __nv_bfloat16;

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16-byte aligned); r[i] receives the lane's pair of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for a 16 x 16 bf16 A fragment and a 16 x 8 bf16 B fragment (b0, b1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// asynchronous copies global → shared (cp.async): 16 or 4 bytes, or zeros
// where `full` is false (then nothing is read); complete in commit-group order
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool full) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool full) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x by the SFU (ex2.approx.ftz: relative error about 2^-22; 0 for x below -126)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two adjacent bf16 values from device memory (4-byte aligned)
__device__ __forceinline__ uint32_t load_bf16x2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c[j] += A B_j for NT n8 tiles, B_j^T being shared rows [8j, 8j + 8) (row
// stride D + 8): 8 keys (or queries) by D, read by ldmatrix without transpose
template <int D, int NT>
__device__ __forceinline__ void mma_rows_t(float (&c)[NT][4], const uint32_t (&a)[D / 16][4],
                                           const bf16_t* s, int lane) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, s + ((j + lane / 16) * 8 + lane % 8) * (D + 8) + kk * 16 +
                         ((lane / 8) & 1) * 8);
      mma_bf16(c[j], a[kk], b[0], b[1]);
      mma_bf16(c[j + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc += A B for the KS k16 steps' A fragments in `a` and B = shared rows
// [0, 16 KS) (row stride D + 8), read by ldmatrix.trans
template <int D, int KS>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4], const uint32_t (&a)[KS][4],
                                         const bf16_t* s, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int nd = 0; nd < D / 8; nd += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, s + (kk * 16 + ((lane / 8) & 1) * 8 + lane % 8) * (D + 8) +
                               (nd + lane / 16) * 8);
      mma_bf16(acc[nd], a[kk], b[0], b[1]);
      mma_bf16(acc[nd + 1], a[kk], b[2], b[3]);
    }
  }
}

}  // namespace
