// Shared helpers for the bdm_tpu_torch Hopper kernels.
//
// Every kernel is exported through a plain C function that launches on the
// stream it is given and returns cudaGetLastError(), so the Python wrapper
// (bdm_tpu_torch/ops/cuda/) can raise on a refused launch. Element types
// are passed as an int code: 0 = float32, 1 = bfloat16.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define BDM_EXPORT extern "C" __attribute__((visibility("default")))

enum BdmDtype { BDM_F32 = 0, BDM_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Squared distance evaluated as (dx*dx + dy*dy) + dz*dz with every
// operation rounded on its own. nvcc would otherwise contract the products
// into FMAs, which changes the last bit and flips argmin ties and the
// d2 < r2 boundary against the plain PyTorch version (and the JAX
// reference, which evaluates in this order).
__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t bdm_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
