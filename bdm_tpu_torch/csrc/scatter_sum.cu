// Unsorted segment sum: out[b, s, :] = sum of feats[b, n, :] over the rows
// n with ids[b, n] == s.
//
// Replaces the TPU kernel `_scatter_kernel` / `scatter_sum_pallas`
// (bdm_tpu/ops/pallas/voxelize.py). Semantics: features (B, N, C) in
// float32 or bfloat16, ids (B, N) int32, float32 accumulation, (B, S, C)
// float32 out; a segment no row names is zero and a row whose id lies
// outside [0, S) is dropped, as the TPU kernel's one-hot product drops it.
// Each segment's rows are added in index order, so the result equals a
// sequential `index_add_` bit for bit. The caller on the training path is
// the backward of the three-neighbour blend (interp.cu): the 3N weighted
// cotangent rows are summed into the M centres they were read from.
//
// Bound on the H100: bytes (one read of the rows and ids, one write of the
// sums; one add a feature).
// Design: build a stable CSR of the ids with integer work only, then sum
// each segment's run with the device code of `runs.cuh`. Five kernels, one
// after the other on the stream:
//   count  one warp a tile of `tile` ids of one batch element, with a row of
//          S counters (in shared memory where S <= kSharedSegs, else its
//          row of the table `counts` (B, tiles, S)). It walks its tile in
//          index order, 32 ids a step, the ids of eight steps loaded before
//          the first: `__match_any_sync` groups the lanes of one id, the
//          group's highest lane takes the group's next counts with one
//          integer atomic, and each lane's rank in (tile, segment) is that
//          plus the lanes of its group below it (`rank`, (B, N)). The row
//          ends as the tile's counts.
//   tiles  a thread a (batch element, segment): an exclusive scan of the
//          segment's counts over the tiles, in place, and its total.
//   scan   a block a batch element: an exclusive scan of the totals over
//          the segments, `lo` (B, S + 1).
//   place  a thread a row: order[lo[id] + rows of id in the tiles before
//          + rank] = row. So every run of `order` (B, N) lists its rows in
//          index order. Rows with out-of-range ids get no slot.
//   run    `runs.cuh`: a group of lanes a segment, its channels in 16-byte
//          vectors, a chunk of the run's indices and then their rows loaded
//          before the first add, the adds in the run's order. No float
//          atomics, and a crowded segment is one long run.
// The wrapper allocates `order`, `lo`, `rank` and `counts` and picks the
// tile (ops/cuda/scatter_sum.py::tile), so that tiles * S stays within a few
// times N + S for any S and N.
#include "runs.cuh"

namespace {

constexpr int kSteps = 8;                // steps of 32 ids loaded at once
constexpr int kSharedSegs = 12 * 1024;   // counters kept in 48 KB of shared
constexpr int kTileThreads = 256;
constexpr int kTileLoads = 16;           // tiles' counts loaded at once
constexpr int kPlaceThreads = 256;
constexpr int kScanThreads = 1024;
constexpr unsigned kAll = 0xffffffffu;

// The id of row i of a tile that ends at hi, or -1 past the tile or out of
// [0, S).
__device__ __forceinline__ int tile_id(const int* ids_b, int i, int hi,
                                       int s) {
  const int id = i < hi ? ids_b[i] : -1;
  return static_cast<unsigned>(id) < static_cast<unsigned>(s) ? id : -1;
}

template <bool kShared>
__global__ void __launch_bounds__(32)
    scatter_sum_count_kernel(const int* __restrict__ ids,
                             int* __restrict__ counts, int* __restrict__ rank,
                             int n, int s, int tile, int tiles) {
  extern __shared__ int shared_row[];
  const int w = blockIdx.x;                   // b * tiles + t
  const int lane = threadIdx.x;
  const int b = w / tiles;
  int* out_row = counts + static_cast<size_t>(w) * s;
  int* row = kShared ? shared_row : out_row;
  for (int i = lane; i < s; i += 32) row[i] = 0;
  __syncwarp();
  const int* ids_b = ids + static_cast<size_t>(b) * n;
  int* rank_b = rank + static_cast<size_t>(b) * n;
  const int lo = (w % tiles) * tile;
  const int hi = min(n, lo + tile);
  const unsigned below = (1u << lane) - 1;
  for (int i0 = lo; i0 < hi; i0 += 32 * kSteps) {
    int id[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k)
      id[k] = tile_id(ids_b, i0 + 32 * k + lane, hi, s);
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const unsigned peers = __match_any_sync(kAll, id[k]);
      const int leader = 31 - __clz(peers);
      int first = 0;
      if (id[k] >= 0 && lane == leader)
        first = atomicAdd(row + id[k], __popc(peers));
      first = __shfl_sync(kAll, first, leader);
      if (id[k] >= 0)
        rank_b[i0 + 32 * k + lane] = first + __popc(peers & below);
      // the next step's counts follow this step's
      __syncwarp();
    }
  }
  if (kShared)
    for (int i = lane; i < s; i += 32) out_row[i] = row[i];
}

// In place, a thread a (batch element, segment): counts[b][t][s] -> the
// rows of segment s in the tiles before t; lo[b][s] -> the segment's total.
__global__ void __launch_bounds__(kTileThreads)
    scatter_sum_tiles_kernel(int* __restrict__ counts, int* __restrict__ lo,
                             int s, int tiles, int segments) {
  const int g = blockIdx.x * kTileThreads + threadIdx.x;
  if (g >= segments) return;
  const int b = g / s;
  const int seg = g - b * s;
  int* col = counts + static_cast<size_t>(b) * tiles * s + seg;
  int total = 0;
  for (int t0 = 0; t0 < tiles; t0 += kTileLoads) {
    int c[kTileLoads];
#pragma unroll
    for (int k = 0; k < kTileLoads; ++k)
      c[k] = t0 + k < tiles ? col[static_cast<size_t>(t0 + k) * s] : 0;
#pragma unroll
    for (int k = 0; k < kTileLoads && t0 + k < tiles; ++k) {
      col[static_cast<size_t>(t0 + k) * s] = total;
      total += c[k];
    }
  }
  lo[static_cast<size_t>(b) * (s + 1) + seg] = total;
}

// In place, a block a batch element: lo[b][:S] from the totals to the
// starts of the runs (an exclusive scan), lo[b][S] the rows kept.
__global__ void __launch_bounds__(kScanThreads)
    scatter_sum_scan_kernel(int* __restrict__ lo, int s) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int* lo_b = lo + static_cast<size_t>(blockIdx.x) * (s + 1);
  int carry = 0;
  for (int s0 = 0; s0 < s; s0 += kScanThreads) {
    const int seg = s0 + threadIdx.x;
    const int total = seg < s ? lo_b[seg] : 0;
    // inclusive scan of the totals over the block
    int x = total;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int y = __shfl_up_sync(kAll, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int v = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int y = __shfl_up_sync(kAll, v, d);
        if (lane >= d) v += y;
      }
      warp_sums[lane] = v;
    }
    __syncthreads();
    if (seg < s)
      lo_b[seg] = carry + x - total + (warp ? warp_sums[warp - 1] : 0);
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();   // warp_sums is read above before the next chunk
  }
  if (threadIdx.x == 0) lo_b[s] = carry;
}

__global__ void __launch_bounds__(kPlaceThreads)
    scatter_sum_place_kernel(const int* __restrict__ ids,
                             const int* __restrict__ rank,
                             const int* __restrict__ lo,
                             const int* __restrict__ before,
                             int* __restrict__ order, int n, int s, int tile,
                             int tiles, int rows) {
  const int r = blockIdx.x * kPlaceThreads + threadIdx.x;
  if (r >= rows) return;
  const int id = ids[r];
  if (static_cast<unsigned>(id) >= static_cast<unsigned>(s)) return;
  const int b = r / n;
  const int i = r - b * n;
  const size_t t = static_cast<size_t>(b) * tiles + i / tile;
  const int slot = lo[static_cast<size_t>(b) * (s + 1) + id] +
                   before[t * s + id] + rank[r];
  order[static_cast<size_t>(b) * n + slot] = i;
}

template <typename TI, typename TO, int V, int U>
__global__ void __launch_bounds__(bdm_runs::kThreads)
    scatter_sum_run_kernel(const TI* __restrict__ feats,
                           const int* __restrict__ order,
                           const int* __restrict__ lo, TO* __restrict__ out,
                           int n, int c, int s, int rows, int lanes_log2,
                           int divide) {
  bdm_runs::run_rows<TI, TO, V, U>(feats, order, lo, out, n, c, s, rows,
                                   lanes_log2, divide);
}

template <typename TI, typename TO, int V, int U>
struct RunKernel {
  static constexpr auto kernel = &scatter_sum_run_kernel<TI, TO, V, U>;
};

template <typename T>
int launch(const void* feats, const int* ids, float* out, int* order,
           int* lo, int* rank, int* counts, int b, int n, int c, int s,
           int tile, int dtype, cudaStream_t stream) {
  if (b == 0 || s == 0 || c == 0) return static_cast<int>(cudaSuccess);
  if (tile <= 0 || tile % 32) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = n > tile ? (n + tile - 1) / tile : 1;
  const long long warps = static_cast<long long>(b) * tiles;
  const long long rows = static_cast<long long>(b) * n;
  if (warps > 0x7fffffffLL || rows > 0x7fffffffLL - kPlaceThreads ||
      static_cast<long long>(b) * s > 0x7fffffffLL - kTileThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (s <= kSharedSegs)
    scatter_sum_count_kernel<true><<<static_cast<unsigned>(warps), 32,
                                     s * sizeof(int), stream>>>(
        ids, counts, rank, n, s, tile, tiles);
  else
    scatter_sum_count_kernel<false><<<static_cast<unsigned>(warps), 32, 0,
                                      stream>>>(ids, counts, rank, n, s,
                                                tile, tiles);
  const long long segments = static_cast<long long>(b) * s;
  scatter_sum_tiles_kernel<<<static_cast<unsigned>(
                                 (segments + kTileThreads - 1) / kTileThreads),
                             kTileThreads, 0, stream>>>(
      counts, lo, s, tiles, static_cast<int>(segments));
  scatter_sum_scan_kernel<<<b, kScanThreads, 0, stream>>>(lo, s);
  if (rows > 0)
    scatter_sum_place_kernel<<<static_cast<unsigned>(
                                   (rows + kPlaceThreads - 1) / kPlaceThreads),
                               kPlaceThreads, 0, stream>>>(
        ids, rank, lo, counts, order, n, s, tile, tiles,
        static_cast<int>(rows));
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return bdm_runs::launch<RunKernel, T, float>(feats, order, lo, out, b, n, c,
                                               s, 0, dtype, BDM_F32, stream);
}

}  // namespace

BDM_EXPORT int bdm_scatter_sum(const void* feats, const int* ids, float* out,
                               int* order, int* lo, int* rank, int* counts,
                               int b, int n, int c, int s, int tile, int dtype,
                               cudaStream_t stream) {
  if (dtype == BDM_F32)
    return launch<float>(feats, ids, out, order, lo, rank, counts, b, n, c, s,
                         tile, dtype, stream);
  if (dtype == BDM_BF16)
    return launch<__nv_bfloat16>(feats, ids, out, order, lo, rank, counts, b,
                                 n, c, s, tile, dtype, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
