// Three-neighbour weighted blend of bf16 centre features.
//
// Replaces the TPU kernel `_interp_mm_kernel` / `_interp_mm_fwd_pallas`
// (bdm_tpu/ops/pallas/interp_mm.py). Semantics: out[n] = sum_k
// bf16(w_k[n]) * F[idx_k[n]], the weights rounded once to bf16, the
// products accumulated in float32 in k order and rounded once to bf16 at
// the store. The TPU kernel writes this as a one-hot (N, M) matrix times F
// because the TPU gathers badly; the card gathers well, so the rows are
// read directly and the 2*N*M*C operations of the one-hot product shrink
// to the 6*N*C of the blend.
//
// Bound on the H100: bytes. A call reads idx, w and F once and writes
// (B, N, C) bf16; F (<= 4 MB on the main path) stays in L2 while every row
// is read about 3*N/M times.
// Design: a thread owns `VEC` consecutive channels of one output row
// (VEC = 8: one 16-byte load a neighbour and one 16-byte store), channel
// groups fastest, so a warp reads whole feature rows and writes
// contiguously. A bf16 x bf16 product is exact in float32, so an FMA and a
// separate multiply and add give the same bits and the result does not
// depend on nvcc's contraction. Indices are clamped to [0, M) so a bad
// index cannot read outside F (three_nn never produces one).
#include "common.cuh"

namespace {

constexpr int kInterpThreads = 256;

template <int VEC>
struct alignas(2 * VEC) Bf16Vec {
  __nv_bfloat16 v[VEC];
};

template <int VEC>
__global__ void __launch_bounds__(kInterpThreads)
    interp_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                  const __nv_bfloat16* __restrict__ feats,
                  __nv_bfloat16* __restrict__ out, int n, int m, int c,
                  long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= total) return;
  const int groups = c / VEC;
  const long long row = e / groups;                 // b * n + point
  const int c0 = static_cast<int>(e % groups) * VEC;
  const long long b = row / n;
  const int* ip = idx + row * 3;
  const float* wp = w + row * 3;
  const __nv_bfloat16* fb = feats + b * m * c + c0;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float wk = __bfloat162float(__float2bfloat16_rn(wp[k]));
    const int i = min(max(ip[k], 0), m - 1);
    const Bf16Vec<VEC> f = *reinterpret_cast<const Bf16Vec<VEC>*>(
        fb + static_cast<long long>(i) * c);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      acc[j] = fmaf(wk, __bfloat162float(f.v[j]), acc[j]);
  }
  Bf16Vec<VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) o.v[j] = __float2bfloat16_rn(acc[j]);
  *reinterpret_cast<Bf16Vec<VEC>*>(out + row * c + c0) = o;
}

template <int VEC>
int launch(const int* idx, const float* w, const __nv_bfloat16* feats,
           __nv_bfloat16* out, int b, int n, int m, int c,
           cudaStream_t stream) {
  const long long total = static_cast<long long>(b) * n * (c / VEC);
  if (total == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks =
      static_cast<unsigned>((total + kInterpThreads - 1) / kInterpThreads);
  interp_kernel<VEC><<<blocks, kInterpThreads, 0, stream>>>(
      idx, w, feats, out, n, m, c, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

BDM_EXPORT int bdm_interp(const int* idx, const float* w, const void* feats,
                          void* out, int b, int n, int m, int c,
                          cudaStream_t stream) {
  const auto* f = static_cast<const __nv_bfloat16*>(feats);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte accesses need rows of a multiple of 8 channels (torch
  // allocations are 256-byte aligned); other widths go a channel a thread
  if (c % 8 == 0) return launch<8>(idx, w, f, o, b, n, m, c, stream);
  return launch<1>(idx, w, f, o, b, n, m, c, stream);
}
