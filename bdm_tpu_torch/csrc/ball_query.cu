// Ball query: the first U points in scan order with d2 < r2.
//
// Replaces the TPU kernel `_bq_kernel` / `ball_query_pallas`
// (bdm_tpu/ops/pallas/ball_query.py). Slots after the last hit repeat the
// first hit; a centre with no hit gets index 0 in every slot. r2 arrives
// already squared in float32 (the wrapper squares float32(radius)), the
// same boundary the JAX reference compares against.
//
// Bound on the H100: compute and latency, not bytes. Each centre scans the
// cloud until it has U hits; at the coarse stages (r = 0.4, 0.8) most
// centres stop early, at stage 0 (r = 0.1) many scan all N points.
// Design: one thread per centre, a block of 128 centres of one cloud.
// Points stream through shared memory in tiles of 1024, so a warp reads
// each point once from device memory and every thread reads it from shared
// memory as a broadcast. The block leaves the tile loop as soon as all of
// its centres are full.
#include "common.cuh"

namespace {

constexpr int kBqThreads = 128;
constexpr int kBqTile = 1024;

__global__ void __launch_bounds__(kBqThreads)
    ball_query_kernel(const float* __restrict__ centers,
                      const float* __restrict__ points, int* __restrict__ out,
                      int m, int n, int u, float r2) {
  __shared__ float sx[kBqTile], sy[kBqTile], sz[kBqTile];
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = c < m;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (active) {
    const float* cp = centers + (static_cast<size_t>(b) * m + c) * 3;
    cx = cp[0];
    cy = cp[1];
    cz = cp[2];
  }
  int* o = out + (static_cast<size_t>(b) * m + (active ? c : 0)) * u;
  const float* pb = points + static_cast<size_t>(b) * n * 3;

  int count = 0;
  int first = 0;
  bool done = !active;
  for (int t0 = 0; t0 < n; t0 += kBqTile) {
    // also the barrier that protects the previous tile's reads
    if (__syncthreads_and(done)) break;
    const int lim = min(kBqTile, n - t0);
    for (int i = threadIdx.x; i < lim; i += blockDim.x) {
      const float* q = pb + static_cast<size_t>(t0 + i) * 3;
      sx[i] = q[0];
      sy[i] = q[1];
      sz[i] = q[2];
    }
    __syncthreads();
    if (!done) {
      for (int i = 0; i < lim; ++i) {
        if (sqdist(cx, cy, cz, sx[i], sy[i], sz[i]) < r2) {
          if (count == 0) first = t0 + i;
          o[count] = t0 + i;
          if (++count == u) {
            done = true;
            break;
          }
        }
      }
    }
  }
  if (active) {
    for (int s = count; s < u; ++s) o[s] = first;
  }
}

}  // namespace

BDM_EXPORT int bdm_ball_query(const float* centers, const float* points,
                              int* out, int b, int m, int n, int u, float r2,
                              cudaStream_t stream) {
  const dim3 grid((m + kBqThreads - 1) / kBqThreads, b);
  ball_query_kernel<<<grid, kBqThreads, 0, stream>>>(centers, points, out, m,
                                                     n, u, r2);
  return static_cast<int>(cudaGetLastError());
}
