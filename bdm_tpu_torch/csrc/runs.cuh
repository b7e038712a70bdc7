// Sums over the runs of a CSR: the device code that voxelize.cu (the voxel
// scatter-mean) and scatter_sum.cu (the unsorted segment sum) share.
//
// A CSR here is `order` (B, N), the row indices of a batch element grouped
// by segment, and `lo` (B, S + 1), where segment s of element b owns
// order[b, lo[b, s] : lo[b, s + 1]]. Each segment's sum is taken over its
// run in the run's order, in float32, and rounded once to the output type
// at the store; an empty segment is zero. With `divide` each contribution
// is first divided by the run's length (a mean; x / 1.0f is x, so the raw
// sum shares the loop).
//
// Design: a group of `lanes` lanes owns one segment row and walks its
// channels in vectors of `vec` elements (16 bytes where the row allows it,
// else 8, 4 or one element); both are picked from the types and C alone
// (`vec_elems`, `lanes_for`). A narrow row puts several segments in a
// warp, so a block always writes one contiguous span of the output. The
// group reads its segment's run once; an empty segment is a vector store
// of zeros; an occupied one loads the indices of a chunk of its run and
// then their parts of the feature rows, all before the first add, so a run
// costs a few memory round trips, not two a row. A row wider than a
// group's registers (16 floats a lane) is walked in passes. No atomics:
// the result is deterministic, and float32 sums equal a sequential sum in
// the run's order bit for bit.
#pragma once

#include "common.cuh"

namespace bdm_runs {

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
inline int vec_elems(int in_dtype, int out_dtype, int c) {
  const int widest =
      (in_dtype == BDM_F32 || out_dtype == BDM_F32) ? 4 : 2;
  for (int v = 16 / widest; v > 1; v /= 2)
    if (c % v == 0) return v;
  return 1;
}

// Lanes a segment: the row's vectors rounded up to a power of two, at most
// a warp.
inline int lanes_for(int in_dtype, int out_dtype, int c) {
  const int nvec = c / vec_elems(in_dtype, out_dtype, c);
  int g = 1;
  while (g < nvec && g < 32) g *= 2;
  return g;
}

// One segment row: U vectors a lane a pass (`pick_u`).
template <typename TI, typename TO, int V, int U>
__device__ __forceinline__ void run_row(const TI* __restrict__ fb,
                                        const int* __restrict__ ord,
                                        TO* __restrict__ row, int c,
                                        int lanes, int lane, int lo, int hi,
                                        int divide) {
  const float cnt = divide ? static_cast<float>(hi - lo) : 1.0f;
  const int nvec = c / V;
  // rows of a run whose loads are in flight together
  constexpr int P = kLoadFloats / (U * V) > 8 ? 8
                    : (kLoadFloats / (U * V) < 1 ? 1 : kLoadFloats / (U * V));
  for (int base = lane; base < nvec; base += lanes * U) {
    float acc[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[u][i] = 0.0f;
    for (int p0 = lo; p0 < hi; p0 += P) {
      // the chunk's row indices, then their parts of the rows, all loads in
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

// The body of a kernel over all B * S segment rows: one row a group; a
// block's rows are consecutive. `segs` is S, `rows` B * S.
template <typename TI, typename TO, int V, int U>
__device__ __forceinline__ void run_rows(const TI* __restrict__ feats,
                                         const int* __restrict__ order,
                                         const int* __restrict__ lo,
                                         TO* __restrict__ out, int n, int c,
                                         int segs, int rows, int lanes_log2,
                                         int divide) {
  const int vg = (blockIdx.x * kThreads + threadIdx.x) >> lanes_log2;
  if (vg >= rows) return;
  const int lanes = 1 << lanes_log2;
  const int b = vg / segs;
  const int* lo_b = lo + vg + b;       // b * (segs + 1) + s
  run_row<TI, TO, V, U>(feats + static_cast<size_t>(b) * n * c,
                        order + static_cast<size_t>(b) * n,
                        out + static_cast<size_t>(vg) * c, c, lanes,
                        threadIdx.x & (lanes - 1), lo_b[0], lo_b[1], divide);
}

// The kernel with U vectors a lane a pass: the least power of two that
// covers the row's `u` vectors a lane, at most kAccFloats / V (a wider row
// takes passes). An unused accumulator would take the registers of rows in
// flight (`run_row`'s P).
template <template <typename, typename, int, int> class Kernel, typename TI,
          typename TO, int V, int U = 1>
auto pick_u(int u) {
  if constexpr (U >= kAccFloats / V)
    return Kernel<TI, TO, V, U>::kernel;
  else
    return u <= U ? Kernel<TI, TO, V, U>::kernel
                  : pick_u<Kernel, TI, TO, V, 2 * U>(u);
}

// Launches `Kernel<TI, TO, V, U>::kernel`, a __global__ function that runs
// `run_rows` with the same arguments, with U picked for C: the caller names
// its own kernel, so a profile tells the two sources apart.
template <template <typename, typename, int, int> class Kernel, typename TI,
          typename TO, int V>
int launch_v(const void* feats, const int* order, const int* lo, void* out,
             int n, int c, int segs, int rows, int lanes, int divide,
             cudaStream_t stream) {
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  const int per_block = kThreads / lanes;
  const unsigned blocks =
      static_cast<unsigned>((rows + per_block - 1) / per_block);
  const auto* f = static_cast<const TI*>(feats);
  auto* o = static_cast<TO*>(out);
  const auto kernel = pick_u<Kernel, TI, TO, V>((c / V + lanes - 1) / lanes);
  kernel<<<blocks, kThreads, 0, stream>>>(f, order, lo, o, n, c, segs, rows,
                                          lanes_log2, divide);
  return static_cast<int>(cudaGetLastError());
}

template <template <typename, typename, int, int> class Kernel, typename TI,
          typename TO>
int launch(const void* feats, const int* order, const int* lo, void* out,
           int b, int n, int c, int segs, int divide, int in_dtype,
           int out_dtype, cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * segs;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const int lanes = lanes_for(in_dtype, out_dtype, c);
  const int r = static_cast<int>(rows);
  switch (vec_elems(in_dtype, out_dtype, c)) {
    case 1:
      return launch_v<Kernel, TI, TO, 1>(feats, order, lo, out, n, c, segs,
                                         r, lanes, divide, stream);
    case 2:
      return launch_v<Kernel, TI, TO, 2>(feats, order, lo, out, n, c, segs,
                                         r, lanes, divide, stream);
    case 4:
      return launch_v<Kernel, TI, TO, 4>(feats, order, lo, out, n, c, segs,
                                         r, lanes, divide, stream);
    case 8:   // two-byte types only
      if constexpr (sizeof(TI) == 2 && sizeof(TO) == 2)
        return launch_v<Kernel, TI, TO, 8>(feats, order, lo, out, n, c,
                                           segs, r, lanes, divide, stream);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace bdm_runs
