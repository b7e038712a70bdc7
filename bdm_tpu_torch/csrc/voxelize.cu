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
// Design: a group of `lanes` lanes owns one voxel row and walks its
// channels in vectors of `vec` elements (16 bytes where the row allows it,
// else 8, 4 or one element); both are picked from the types and C alone
// (`bdm_scatter_mean_vec`, `bdm_scatter_mean_lanes`, mirrored by
// ops/cuda/voxelize.py::kernel_path). A narrow row puts several voxels in a
// warp, so a block always writes one contiguous span of the grid. The
// group reads its voxel's run [voxel_lo[v], voxel_lo[v + 1]) once; an
// empty voxel is a vector store of zeros; an occupied one loads the
// indices of a chunk of its run and then their parts of the feature rows,
// all before the first add, so a run costs a few memory round trips, not
// two a point. A row wider than a group's registers (16 floats a lane) is
// walked in passes. No atomics: the sum is taken in the run's order, so the
// result is deterministic and float32 equals the reference bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kAccFloats = 16;   // accumulator registers a lane
// registers a lane holds for the features of one chunk of a run
constexpr int kLoadFloats = 16;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// Elements a vector: the most (8, 4, 2, 1) that divides C and keeps the
// wider of the two element types at 16 bytes a load or store.
int vec_elems(int in_dtype, int out_dtype, int c) {
  const int widest =
      (in_dtype == BDM_F32 || out_dtype == BDM_F32) ? 4 : 2;
  for (int v = 16 / widest; v > 1; v /= 2)
    if (c % v == 0) return v;
  return 1;
}

// Lanes a voxel: the row's vectors rounded up to a power of two, at most a
// warp.
int lanes_for(int in_dtype, int out_dtype, int c) {
  const int nvec = c / vec_elems(in_dtype, out_dtype, c);
  int g = 1;
  while (g < nvec && g < 32) g *= 2;
  return g;
}

// One voxel row: U vectors a lane a pass (1 when the row fits one vector a
// lane, else as many as kAccFloats allows).
template <typename TI, typename TO, int V, int U>
__device__ __forceinline__ void voxel_row(const TI* __restrict__ fb,
                                          const int* __restrict__ ord,
                                          TO* __restrict__ row, int c,
                                          int lanes, int lane, int lo, int hi,
                                          int divide) {
  // x / 1.0f is x: the raw sum shares the loop
  const float cnt = divide ? static_cast<float>(hi - lo) : 1.0f;
  const int nvec = c / V;
  // points of a run whose loads are in flight together
  constexpr int P = kLoadFloats / (U * V) > 8 ? 8
                    : (kLoadFloats / (U * V) < 1 ? 1 : kLoadFloats / (U * V));
  for (int base = lane; base < nvec; base += lanes * U) {
    float acc[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[u][i] = 0.0f;
    for (int p0 = lo; p0 < hi; p0 += P) {
      // the chunk's point indices, then their parts of the rows, all loads in
      // flight before the first add; the adds keep the run's order
      int q[P];
#pragma unroll
      for (int k = 0; k < P; ++k) q[k] = p0 + k < hi ? ord[p0 + k] : -1;
      Vec<TI, V> x[P][U];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const TI* f = fb + static_cast<size_t>(q[k]) * c;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = base + u * lanes;
          if (q[k] >= 0 && (U == 1 || e < nvec))
            x[k][u] = *reinterpret_cast<const Vec<TI, V>*>(f + e * V);
        }
      }
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (q[k] < 0) break;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = base + u * lanes;
          if (U == 1 || e < nvec) {
#pragma unroll
            for (int i = 0; i < V; ++i)
              acc[u][i] = __fadd_rn(acc[u][i],
                                    __fdiv_rn(to_f32(x[k][u].v[i]), cnt));
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * lanes;
      if (U == 1 || e < nvec) {
        Vec<TO, V> y;
#pragma unroll
        for (int i = 0; i < V; ++i) y.v[i] = from_f32<TO>(acc[u][i]);
        *reinterpret_cast<Vec<TO, V>*>(row + e * V) = y;
      }
    }
  }
}

// One voxel a group; a block's voxels are consecutive, so it writes one
// contiguous span of the output.
template <typename TI, typename TO, int V, int U>
__global__ void __launch_bounds__(kThreads)
    scatter_mean_kernel(const TI* __restrict__ feats,
                        const int* __restrict__ order,
                        const int* __restrict__ voxel_lo,
                        TO* __restrict__ out, int n, int c, int r3,
                        int voxels, int lanes_log2, int divide) {
  const int vg = (blockIdx.x * kThreads + threadIdx.x) >> lanes_log2;
  if (vg >= voxels) return;
  const int lanes = 1 << lanes_log2;
  const int b = vg / r3;
  const int* lo_b = voxel_lo + vg + b;       // b * (r3 + 1) + v
  voxel_row<TI, TO, V, U>(feats + static_cast<size_t>(b) * n * c,
                          order + static_cast<size_t>(b) * n,
                          out + static_cast<size_t>(vg) * c, c, lanes,
                          threadIdx.x & (lanes - 1), lo_b[0], lo_b[1], divide);
}

template <typename TI, typename TO, int V, int U>
int launch_vu(const void* feats, const int* order, const int* voxel_lo,
              void* out, int n, int c, int r3, int voxels, int lanes,
              int divide, cudaStream_t stream) {
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  const int per_block = kThreads / lanes;
  const unsigned blocks =
      static_cast<unsigned>((voxels + per_block - 1) / per_block);
  scatter_mean_kernel<TI, TO, V, U><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TI*>(feats), order, voxel_lo, static_cast<TO*>(out),
      n, c, r3, voxels, lanes_log2, divide);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI, typename TO, int V>
int launch_v(const void* feats, const int* order, const int* voxel_lo,
             void* out, int n, int c, int r3, int voxels, int lanes,
             int divide, cudaStream_t stream) {
  if (c / V <= lanes)
    return launch_vu<TI, TO, V, 1>(feats, order, voxel_lo, out, n, c, r3,
                                   voxels, lanes, divide, stream);
  return launch_vu<TI, TO, V, kAccFloats / V>(
      feats, order, voxel_lo, out, n, c, r3, voxels, lanes, divide, stream);
}

template <typename TI, typename TO>
int launch(const void* feats, const int* order, const int* voxel_lo,
           void* out, int b, int n, int c, int r3, int divide, int in_dtype,
           int out_dtype, cudaStream_t stream) {
  const long long voxels = static_cast<long long>(b) * r3;
  if (voxels > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = lanes_for(in_dtype, out_dtype, c);
  const int v = static_cast<int>(voxels);
  switch (vec_elems(in_dtype, out_dtype, c)) {
    case 1:
      return launch_v<TI, TO, 1>(feats, order, voxel_lo, out, n, c, r3, v,
                                 lanes, divide, stream);
    case 2:
      return launch_v<TI, TO, 2>(feats, order, voxel_lo, out, n, c, r3, v,
                                 lanes, divide, stream);
    case 4:
      return launch_v<TI, TO, 4>(feats, order, voxel_lo, out, n, c, r3, v,
                                 lanes, divide, stream);
    case 8:   // two-byte types only
      if constexpr (sizeof(TI) == 2 && sizeof(TO) == 2)
        return launch_v<TI, TO, 8>(feats, order, voxel_lo, out, n, c, r3, v,
                                   lanes, divide, stream);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

BDM_EXPORT int bdm_scatter_mean(const void* feats, const int* order,
                                const int* voxel_lo, void* out, int b, int n,
                                int c, int r3, int divide, int in_dtype,
                                int out_dtype, cudaStream_t stream) {
  if (in_dtype == BDM_F32 && out_dtype == BDM_F32)
    return launch<float, float>(feats, order, voxel_lo, out, b, n, c, r3,
                                divide, in_dtype, out_dtype, stream);
  if (in_dtype == BDM_F32 && out_dtype == BDM_BF16)
    return launch<float, __nv_bfloat16>(feats, order, voxel_lo, out, b, n, c,
                                        r3, divide, in_dtype, out_dtype,
                                        stream);
  if (in_dtype == BDM_BF16 && out_dtype == BDM_F32)
    return launch<__nv_bfloat16, float>(feats, order, voxel_lo, out, b, n, c,
                                        r3, divide, in_dtype, out_dtype,
                                        stream);
  if (in_dtype == BDM_BF16 && out_dtype == BDM_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        feats, order, voxel_lo, out, b, n, c, r3, divide, in_dtype,
        out_dtype, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The source's choice for a (type, type, C): elements a vector and lanes a
// voxel.
BDM_EXPORT int bdm_scatter_mean_vec(int in_dtype, int out_dtype, int c) {
  return vec_elems(in_dtype, out_dtype, c);
}

BDM_EXPORT int bdm_scatter_mean_lanes(int in_dtype, int out_dtype, int c) {
  return lanes_for(in_dtype, out_dtype, c);
}
