// Ball query: the first U points in scan order with d2 < r2.
//
// Replaces the TPU kernel `_bq_kernel` / `ball_query_pallas`
// (bdm_tpu/ops/pallas/ball_query.py). Slots after the last hit repeat the
// first hit; a centre with no hit gets index 0 in every slot; any N works,
// N < U too. r2 arrives already squared in float32 (the wrapper squares
// float32(radius)), the same boundary the JAX reference compares against;
// d2 is `common.cuh::sqdist`, every operation rounded on its own.
//
// Bound on the H100: operations and instruction throughput, not bytes.
// Each centre scans the cloud until it has U hits; at the coarse stages
// (r = 0.4, 0.8) most centres stop early, at stage 0 (r = 0.1) many scan
// all N points.
// Design: one warp a centre, eight centres a block, so stage 0 (B 8,
// M 1024) runs 8,192 warps. Lane l tests point p0 + l; a ballot collects
// the hits of the 32 points in scan order. A hit's slot is the count so far
// plus the hits of the lanes below it, so the slots follow scan order in
// any split; the first hit is the lowest lane of the first ballot that has
// one. A step tests kGroups groups of 32 points, their loads all in flight
// before the first compare, and takes their ballots in ascending order.
// The warp stops at the step in which its count reaches U, on its own: the
// points come from L1 / L2 (a block's centres share a cloud), with no
// block barrier. Then its lanes fill the slots [count, U) with the first
// hit, a coalesced row.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;    // centres a block
constexpr int kGroups = 8;   // groups of 32 points a step

__global__ void __launch_bounds__(kWarps * 32)
    ball_query_kernel(const float* __restrict__ centers,
                      const float* __restrict__ points, int* __restrict__ out,
                      int m, int n, int u, int centres, float r2) {
  const int cg = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (cg >= centres) return;
  const int b = cg / m;
  const float* cp = centers + static_cast<size_t>(cg) * 3;
  const float cx = cp[0], cy = cp[1], cz = cp[2];
  const float* pb = points + static_cast<size_t>(b) * n * 3;
  int* o = out + static_cast<size_t>(cg) * u;
  const unsigned below = (1u << lane) - 1;

  int count = 0;
  int first = -1;
  for (int p0 = 0; p0 < n && count < u; p0 += 32 * kGroups) {
    float x[kGroups], y[kGroups], z[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int p = p0 + 32 * g + lane;
      if (p < n) {
        const float* q = pb + static_cast<size_t>(p) * 3;
        x[g] = __ldg(q);
        y[g] = __ldg(q + 1);
        z[g] = __ldg(q + 2);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int p = p0 + 32 * g + lane;
      const bool hit = p < n && sqdist(cx, cy, cz, x[g], y[g], z[g]) < r2;
      const unsigned hits = __ballot_sync(0xffffffffu, hit);
      if (hits == 0) continue;
      if (first < 0) first = p0 + 32 * g + __ffs(hits) - 1;
      const int slot = count + __popc(hits & below);
      if (hit && slot < u) o[slot] = p;
      count += __popc(hits);
    }
  }
  const int fill = first < 0 ? 0 : first;
  for (int s = min(count, u) + lane; s < u; s += 32) o[s] = fill;
}

}  // namespace

BDM_EXPORT int bdm_ball_query(const float* centers, const float* points,
                              int* out, int b, int m, int n, int u, float r2,
                              cudaStream_t stream) {
  const long long centres = static_cast<long long>(b) * m;
  if (centres == 0 || u == 0) return static_cast<int>(cudaSuccess);
  if (centres > 0x7fffffffLL - kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((centres + kWarps - 1) / kWarps);
  ball_query_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      centers, points, out, m, n, u, static_cast<int>(centres), r2);
  return static_cast<int>(cudaGetLastError());
}
