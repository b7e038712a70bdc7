// Furthest point sampling.
//
// Replaces the TPU kernel `_fps_kernel` / `furthest_point_sample_pallas`
// (bdm_tpu/ops/pallas/fps.py). Semantics: start from index 0; each of the
// M-1 rounds lowers every point's running min squared distance (from 1e38)
// by its distance to the last pick and picks the argmax, lowest index on
// ties.
//
// Bound on the H100: the M-1 rounds are sequential and each one ends in a
// block-wide argmax, so the kernel is bound by the length of one round (its
// latency and its instruction count), not by bytes (a (4096, 3) cloud is
// 48 KB) or operations.
// `bdm_fps_round_floor` runs the same rounds with the distance work left
// out: the floor this design can reach.
// Design: one block per cloud of T threads, T sized from N
// (`bdm_fps_threads`); thread t owns the K points t, t + T, ... in
// registers (x, y, z and the running distance), so a round reads no memory
// but the last winner's coordinates (from a float4 copy of the cloud in
// shared memory). A thread keeps its first maximum (a pairwise tree in
// which the higher indices win only by a strict >); a warp takes the max
// of the distances' bits (distances are >= +0, so their bits order as
// unsigned integers) and then the min of the indices over the lanes
// holding it: with strided ownership the lowest lane is not the lowest
// index. Each warp writes its (bits, index) to a slot of a double-buffered
// array; after the round's single barrier every warp reduces the slots
// itself, so no second barrier and no serial step. Padding points (index
// >= N) sit at distance 0 with an index above every real point's, so they
// never win: if the maximum is 0, a real point holds it with a lower index.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kFpsMaxThreads = 1024;
constexpr int kPointsAThread = 8;   // points a thread aims at

// Threads a cloud of n points gets: n / kPointsAThread rounded up to a warp,
// at most 1024 (ops/cuda/fps.py::threads is the same rule).
int fps_threads(int n) {
  const int t = (n + kPointsAThread - 1) / kPointsAThread;
  return std::min(kFpsMaxThreads, std::max(32, (t + 31) / 32 * 32));
}

// Points a thread holds: ceil(n / threads) rounded up to a power of two.
int fps_points(int n) {
  const int t = fps_threads(n);
  const int k = (n + t - 1) / t;
  int p = 1;
  while (p < k) p *= 2;
  return p;
}

template <int K, bool kFloor>
__global__ void __launch_bounds__(kFpsMaxThreads)
    fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n,
               int m) {
  extern __shared__ float4 cloud[];       // the winner's coordinates
  __shared__ uint2 slots[2][32];          // (bits, index) a warp, per parity
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * m;

  float x[K], y[K], z[K], dist[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t + k * nt;
    x[k] = y[k] = z[k] = 0.0f;
    dist[k] = 0.0f;                       // padding
    if (i < n) {
      x[k] = p[3 * i];
      y[k] = p[3 * i + 1];
      z[k] = p[3 * i + 2];
      dist[k] = 1e38f;
      cloud[i] = make_float4(x[k], y[k], z[k], 0.0f);
    }
  }
  // slots of warps the block does not have stay at a key that never wins
  for (int i = t; i < 64; i += nt)
    slots[i >> 5][i & 31] = make_uint2(0u, UINT_MAX);
  if (t == 0) o[0] = 0;
  __syncthreads();

  float4 last = cloud[0];
  unsigned picked = 0;
  for (int j = 1; j < m; ++j) {
    float d[K];
    int di[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (kFloor) {
        // no distance work; the xor ties the round to the last pick so
        // the compiler cannot hoist the scan out of the loop
        d[k] = __uint_as_float(__float_as_uint(dist[k]) ^ (picked & 1u));
      } else {
        d[k] = fminf(dist[k],
                     sqdist(x[k], y[k], z[k], last.x, last.y, last.z));
        dist[k] = d[k];
      }
      di[k] = t + k * nt;
    }
    // the thread's argmax as a pairwise tree (log2 K steps, not K): the
    // right side, whose indices are higher, wins only by a strict >
#pragma unroll
    for (int w = 1; w < K; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < K; k += 2 * w) {
        if (d[k + w] > d[k]) {
          d[k] = d[k + w];
          di[k] = di[k + w];
        }
      }
    }
    const float best = d[0];
    const int best_i = di[0];
    const unsigned bits = __float_as_uint(best);
    const unsigned wmax = __reduce_max_sync(0xffffffffu, bits);
    const unsigned widx = __reduce_min_sync(
        0xffffffffu, bits == wmax ? static_cast<unsigned>(best_i) : UINT_MAX);
    // every lane stores the same key and reads one slot: no branch
    uint2* slot = slots[j & 1];
    slot[warp] = make_uint2(wmax, widx);
    __syncthreads();
    const uint2 s = slot[lane];
    const unsigned bmax = __reduce_max_sync(0xffffffffu, s.x);
    picked = __reduce_min_sync(0xffffffffu, s.x == bmax ? s.y : UINT_MAX);
    // the floor's xor may let a padding point win: stay inside the cloud
    last = cloud[kFloor ? min(picked, static_cast<unsigned>(n - 1)) : picked];
    if (t == 0) o[j] = static_cast<int>(picked);
  }
}

template <bool kFloor>
int launch(const float* xyz, int* out, int b, int n, int m,
           cudaStream_t stream) {
  const int threads = fps_threads(n);
  const size_t smem = sizeof(float4) * static_cast<size_t>(n);
  cudaError_t err = cudaSuccess;
  switch (fps_points(n)) {
#define BDM_FPS_CASE(K)                                                  \
  case K:                                                                \
    err = bdm_allow_smem(fps_kernel<K, kFloor>, smem);                   \
    if (err != cudaSuccess) return static_cast<int>(err);                \
    fps_kernel<K, kFloor><<<b, threads, smem, stream>>>(xyz, out, n, m); \
    break;
    BDM_FPS_CASE(1)
    BDM_FPS_CASE(2)
    BDM_FPS_CASE(4)
    BDM_FPS_CASE(8)
    BDM_FPS_CASE(16)
#undef BDM_FPS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

BDM_EXPORT int bdm_fps(const float* xyz, int* out, int b, int n, int m,
                       cudaStream_t stream) {
  return launch<false>(xyz, out, b, n, m, stream);
}

// The same block and rounds without the distance work (a measurement of
// the barrier and the reductions alone; its indices mean nothing).
BDM_EXPORT int bdm_fps_round_floor(const float* xyz, int* out, int b, int n,
                                   int m, cudaStream_t stream) {
  return launch<true>(xyz, out, b, n, m, stream);
}

BDM_EXPORT int bdm_fps_threads(int n) { return fps_threads(n); }
