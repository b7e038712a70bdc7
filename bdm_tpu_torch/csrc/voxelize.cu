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
// Bound on the H100: bytes, and nearly all of them the store: at N 4096 and
// R 32 most voxels are empty, and every output element is written once.
// Design: the sum over runs of `runs.cuh`, with the voxels as segments: the
// sorted voxel context is the CSR (`order`, `voxel_lo`). A group of lanes
// owns one voxel row and walks its channels in vectors; both numbers are
// picked from the types and C alone (`bdm_scatter_mean_vec`,
// `bdm_scatter_mean_lanes`, mirrored by ops/cuda/voxelize.py::kernel_path).
// No atomics: the sum is taken in the run's order, so the result is
// deterministic and float32 equals the reference bit for bit.
#include "runs.cuh"

namespace {

template <typename TI, typename TO, int V, int U>
__global__ void __launch_bounds__(bdm_runs::kThreads)
    scatter_mean_kernel(const TI* __restrict__ feats,
                        const int* __restrict__ order,
                        const int* __restrict__ voxel_lo,
                        TO* __restrict__ out, int n, int c, int r3,
                        int voxels, int lanes_log2, int divide) {
  bdm_runs::run_rows<TI, TO, V, U>(feats, order, voxel_lo, out, n, c, r3,
                                   voxels, lanes_log2, divide);
}

template <typename TI, typename TO, int V, int U>
struct MeanKernel {
  static constexpr auto kernel = &scatter_mean_kernel<TI, TO, V, U>;
};

}  // namespace

BDM_EXPORT int bdm_scatter_mean(const void* feats, const int* order,
                                const int* voxel_lo, void* out, int b, int n,
                                int c, int r3, int divide, int in_dtype,
                                int out_dtype, cudaStream_t stream) {
  using bdm_runs::launch;
  const bool in32 = in_dtype == BDM_F32, out32 = out_dtype == BDM_F32;
  if ((!in32 && in_dtype != BDM_BF16) || (!out32 && out_dtype != BDM_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (in32 && out32)
    return launch<MeanKernel, float, float>(feats, order, voxel_lo, out, b,
                                            n, c, r3, divide, in_dtype,
                                            out_dtype, stream);
  if (in32)
    return launch<MeanKernel, float, __nv_bfloat16>(
        feats, order, voxel_lo, out, b, n, c, r3, divide, in_dtype,
        out_dtype, stream);
  if (out32)
    return launch<MeanKernel, __nv_bfloat16, float>(
        feats, order, voxel_lo, out, b, n, c, r3, divide, in_dtype,
        out_dtype, stream);
  return launch<MeanKernel, __nv_bfloat16, __nv_bfloat16>(
      feats, order, voxel_lo, out, b, n, c, r3, divide, in_dtype, out_dtype,
      stream);
}

// The source's choice for a (type, type, C): elements a vector and lanes a
// voxel.
BDM_EXPORT int bdm_scatter_mean_vec(int in_dtype, int out_dtype, int c) {
  return bdm_runs::vec_elems(in_dtype, out_dtype, c);
}

BDM_EXPORT int bdm_scatter_mean_lanes(int in_dtype, int out_dtype, int c) {
  return bdm_runs::lanes_for(in_dtype, out_dtype, c);
}
