// PTX wrappers for Hopper's asynchronous pipeline (conv3d.cu): `mbarrier`s
// that count arrivals and the bytes of bulk copies, TMA (a 5-D tiled tensor
// copy and a 1-D bulk copy, both into shared memory, both completing on an
// `mbarrier`), and the warpgroup product `wgmma.mma_async` with both
// operands read from shared memory through matrix descriptors.
//
// A descriptor (64 bits) names a matrix in shared memory in 16-byte units:
// bits 0-13 its start address, 16-29 the leading byte offset (LBO), 32-45
// the stride byte offset (SBO), 62-63 the layout (0: no swizzle). Without a
// swizzle a K-major operand is made of core matrices of 8 rows x 16 bytes
// (8 bf16 of K), each 128 contiguous bytes (row i at +16 i); the core
// matrix of the next 8 rows lies SBO bytes on, that of the next 8 of K LBO
// bytes on. Any 16-byte aligned start is allowed, so a view shifted by
// whole 16-byte rows is one added constant.
//
// Accumulator layout of m64nNk16 (float32, N / 2 registers a thread):
// thread 32 w + 4 g + t of the warpgroup holds, for each 8-column block i,
// d[4i], d[4i+1] at row 16 w + g, columns 8i + 2t, 8i + 2t + 1, and
// d[4i+2], d[4i+3] at row 16 w + g + 8, the same columns.
#pragma once

#include <cstdint>
#include <cuda.h>

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Order this thread's generic-proxy writes to shared memory before later
// reads by the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A box of a 5-D tensor map at coordinates (c0 innermost .. c4) into shared
// memory; elements outside the tensor read as zeros. Completes on `bar`.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes into shared memory, both ends
// 16-byte aligned. Completes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

// Before the first wgmma of a batch: the accumulators and shared memory
// written before are visible to it.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warp are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 32, float32, the warpgroup's 16 registers a thread) +=
// A (64 x 16) * B (16 x 32), both bf16 in shared memory (descriptors).
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16],
                                                uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, float32, the warpgroup's 32 registers a thread) +=
// A (64 x 16) * B (16 x 64), both bf16 in shared memory (descriptors).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128, float32, the warpgroup's 64 registers a thread) +=
// A (64 x 16) * B (16 x 128), both bf16 in shared memory (descriptors).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}


template <int N>
struct Wgmma;
template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    wgmma_m64n32k16(d, a, b);
  }
};
template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    wgmma_m64n64k16(d, a, b);
  }
};
template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    wgmma_m64n128k16(d, a, b);
  }
};
