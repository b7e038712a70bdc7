// PTX wrappers for the warp-level tensor-core kernel (attention.cu) and the
// CUDA-core convs of conv3d.cu: asynchronous copies into shared memory,
// `ldmatrix` fragment loads and the bf16 x bf16 -> float32 warp product
// `mma.sync.m16n8k16`.
//
// Fragment layout of one m16n8k16 product, lane = 4 * g + t:
//   A (16 x 16, row-major), four registers of two bf16 (low half = lower
//     column): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//     a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8): b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g);
//   C/D (16 x 8 float32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// `ldmatrix.x4` loads four 8 x 8 matrices of bf16: lanes 8i .. 8i+7 give
// the addresses of the eight 16-byte rows of matrix i, and every lane
// receives in register i the elements (row g, cols 2t, 2t+1) of matrix i
// (with `.trans`: rows 2t, 2t+1 of column g).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared without passing through registers; the
// bytes from `src_bytes` (0 .. 16) on are filled with zeros. `src` must be
// 16-byte aligned even when nothing is read from it.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The same for 8 bytes (sources that are only 8-byte aligned).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The same for 4 bytes (sources that are only 4-byte aligned).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16 bf16) * b (16 x 8 bf16), float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 rounded to bf16 in one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x on the special-function unit; 2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
