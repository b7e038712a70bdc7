// Voxel scatter-mean from the sorted voxel context.
//
// Replaces the TPU kernels `_scatter_sorted_padded_kernel` /
// `scatter_sum_sorted_padded_pallas` (bf16, D-padded) and
// `_scatter_sorted_kernel` / `scatter_sum_sorted_pallas` (float32,
// unpadded) of bdm_tpu/ops/pallas/voxelize.py.
// Semantics: each voxel holds the mean of the features of its points, as
// the sum of contributions already divided by the voxel's count, summed in
// voxel-sorted point order in float32 and rounded once to the output type
// at the store; empty voxels are zero. With `divide` = 0 the contributions
// are not divided and each voxel holds the raw sum (the contract of
// `scatter_sum_sorted_pallas`, whose callers divide themselves or append a
// count channel). The TPU kernels' one-hot matmul and D-padded layout work
// around Mosaic; here the output is the plain channel-last
// (B, R, R, R, C) grid that conv3d.cu reads.
//
// Bound on the H100: bytes. Every output element is written once and
// every input feature is read once (through the sort permutation).
// Design: one thread per (voxel, channel), channel fastest, so a warp
// reads one point's feature row and writes one voxel's row contiguously.
// The thread walks its voxel's run [voxel_lo[v], voxel_lo[v + 1]) of the
// sorted order. No atomics, so the result is deterministic and the sum
// order is the reference's.
#include "common.cuh"

namespace {

template <typename TI, typename TO>
__global__ void scatter_mean_kernel(const TI* __restrict__ feats,
                                    const int* __restrict__ order,
                                    const int* __restrict__ voxel_lo,
                                    TO* __restrict__ out, int n, int c,
                                    int r3, int divide, long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= total) return;
  const int ch = static_cast<int>(e % c);
  const long long bv = e / c;
  const int v = static_cast<int>(bv % r3);
  const int b = static_cast<int>(bv / r3);
  const int* lo_b = voxel_lo + static_cast<size_t>(b) * (r3 + 1);
  const int lo = lo_b[v];
  const int hi = lo_b[v + 1];
  float acc = 0.0f;
  if (hi > lo) {
    // x / 1.0f is x: the raw sum shares the loop
    const float cnt = divide ? static_cast<float>(hi - lo) : 1.0f;
    const int* ord = order + static_cast<size_t>(b) * n;
    const TI* f = feats + static_cast<size_t>(b) * n * c + ch;
    for (int p = lo; p < hi; ++p) {
      acc = __fadd_rn(acc, __fdiv_rn(to_f32(f[static_cast<size_t>(ord[p]) * c]),
                                     cnt));
    }
  }
  out[e] = from_f32<TO>(acc);
}

template <typename TI, typename TO>
int launch(const void* feats, const int* order, const int* voxel_lo,
           void* out, int b, int n, int c, int r3, int divide,
           cudaStream_t stream) {
  const long long total = static_cast<long long>(b) * r3 * c;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  scatter_mean_kernel<TI, TO><<<blocks, threads, 0, stream>>>(
      static_cast<const TI*>(feats), order, voxel_lo, static_cast<TO*>(out),
      n, c, r3, divide, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

BDM_EXPORT int bdm_scatter_mean(const void* feats, const int* order,
                                const int* voxel_lo, void* out, int b, int n,
                                int c, int r3, int divide, int in_dtype,
                                int out_dtype, cudaStream_t stream) {
  if (in_dtype == BDM_F32 && out_dtype == BDM_F32)
    return launch<float, float>(feats, order, voxel_lo, out, b, n, c, r3,
                                divide, stream);
  if (in_dtype == BDM_F32 && out_dtype == BDM_BF16)
    return launch<float, __nv_bfloat16>(feats, order, voxel_lo, out, b, n, c,
                                        r3, divide, stream);
  if (in_dtype == BDM_BF16 && out_dtype == BDM_F32)
    return launch<__nv_bfloat16, float>(feats, order, voxel_lo, out, b, n, c,
                                        r3, divide, stream);
  if (in_dtype == BDM_BF16 && out_dtype == BDM_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(feats, order, voxel_lo, out,
                                                b, n, c, r3, divide, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
