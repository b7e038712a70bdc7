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
// Design: one block per cloud of T threads, T sized from N
// (`bdm_fps_threads`); thread t owns the K points t, t + T, ... in
// registers (x, y, z and the running distance), so a round reads no memory
// but the last winner's coordinates. A thread keeps its first maximum (a
// pairwise tree in which the higher indices win only by a strict >); a
// warp takes the max of the distances' bits (distances are >= +0, so their
// bits order as unsigned integers) and then the min of the indices over
// the lanes holding it: with strided ownership the lowest lane is not the
// lowest index. Each warp writes its (bits, index) to a slot of a
// double-buffered array; after the round's single barrier every warp
// reduces the slots itself, so no second barrier and no serial step.
// Padding points (index >= N) sit at distance 0 with an index above every
// real point's, so they never win: if the maximum is 0, a real point holds
// it with a lower index.
// N has no limit. The winner's coordinates come from a float4 copy of the
// cloud in shared memory where it fits (N <= 14,496), else from `xyz`
// itself (an L1 hit, whose latency lengthens every round; carrying the
// coordinates through the argmax tree and the slots instead costs more
// issue than it saves, on the card). Registers hold up to K 16
// points a thread (N 16,384 at T 1,024); from K 32 on `fps_stream_kernel`
// keeps the running distances in a scratch array the wrapper allocates and
// streams the points from L1 / L2 every round, the same reduction after.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kFpsMaxThreads = 1024;
constexpr int kPointsAThread = 8;   // points a thread aims at
// the largest cloud whose float4 copy fits in a block's shared memory
constexpr int kCloudMaxPoints = (227 * 1024 - 512) / 16;

// Threads a cloud of n points gets: n / kPointsAThread rounded up to a warp,
// at most 1024 (ops/cuda/fps.py::threads is the same rule).
int fps_threads(int n) {
  const int t = (n + kPointsAThread - 1) / kPointsAThread;
  return std::min(kFpsMaxThreads, std::max(32, (t + 31) / 32 * 32));
}

// Points a thread holds: ceil(n / threads) rounded up to a power of two;
// up to 16 in registers, above it streamed (ops/cuda/fps.py::points is the
// same rule).
int fps_points(int n) {
  const int t = fps_threads(n);
  const int k = (n + t - 1) / t;
  int p = 1;
  while (p < k) p *= 2;
  return p;
}

// The winner's coordinates, read from the cloud itself (L1 / L2).
__device__ __forceinline__ float3 point_at(const float* p, unsigned i) {
  return make_float3(__ldg(p + 3 * i), __ldg(p + 3 * i + 1),
                     __ldg(p + 3 * i + 2));
}

// The warp's and then the block's (bits, index) argmax of one round, over
// the double-buffered slots; -> the pick.
__device__ __forceinline__ unsigned block_argmax(uint2 (*slots)[32], int j,
                                                 float best, unsigned best_i,
                                                 int warp, int lane) {
  const unsigned bits = __float_as_uint(best);
  const unsigned wmax = __reduce_max_sync(0xffffffffu, bits);
  const unsigned widx =
      __reduce_min_sync(0xffffffffu, bits == wmax ? best_i : UINT_MAX);
  // every lane stores the same key and reads one slot: no branch
  uint2* slot = slots[j & 1];
  slot[warp] = make_uint2(wmax, widx);
  __syncthreads();
  const uint2 s = slot[lane];
  const unsigned bmax = __reduce_max_sync(0xffffffffu, s.x);
  return __reduce_min_sync(0xffffffffu, s.x == bmax ? s.y : UINT_MAX);
}

// kCloud: a float4 copy of the cloud in shared memory, from which the
// winner's coordinates are read (clouds up to kCloudMaxPoints); else they
// are read from `xyz` (any N).
template <int K, bool kCloud>
__global__ void __launch_bounds__(kFpsMaxThreads)
    fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n,
               int m) {
  extern __shared__ float4 cloud[];
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
      if (kCloud) cloud[i] = make_float4(x[k], y[k], z[k], 0.0f);
    }
  }
  // slots of warps the block does not have stay at a key that never wins
  for (int i = t; i < 64; i += nt)
    slots[i >> 5][i & 31] = make_uint2(0u, UINT_MAX);
  if (t == 0) o[0] = 0;
  __syncthreads();

  float3 last = point_at(p, 0);
  unsigned picked = 0;
  for (int j = 1; j < m; ++j) {
    float d[K];
    int di[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      d[k] = fminf(dist[k], sqdist(x[k], y[k], z[k], last.x, last.y, last.z));
      dist[k] = d[k];
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
    picked = block_argmax(slots, j, d[0], static_cast<unsigned>(di[0]), warp,
                          lane);
    if (kCloud) {
      const float4 c = cloud[picked];
      last = make_float3(c.x, c.y, c.z);
    } else {
      last = point_at(p, picked);
    }
    if (t == 0) o[j] = static_cast<int>(picked);
  }
}

// Above K 16: the running distances in `dist_g` ((B, N) float32 scratch),
// the points streamed from L1 / L2 every round; a thread walks its points
// in increasing index, so its first maximum is its lowest index.
__global__ void __launch_bounds__(kFpsMaxThreads)
    fps_stream_kernel(const float* __restrict__ xyz, float* __restrict__ dist_g,
                      int* __restrict__ out, int n, int m) {
  __shared__ uint2 slots[2][32];
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  float* dist = dist_g + static_cast<size_t>(blockIdx.x) * n;
  int* o = out + static_cast<size_t>(blockIdx.x) * m;
  for (int i = t; i < n; i += nt) dist[i] = 1e38f;
  for (int i = t; i < 64; i += nt)
    slots[i >> 5][i & 31] = make_uint2(0u, UINT_MAX);
  if (t == 0) o[0] = 0;
  __syncthreads();

  float3 last = point_at(p, 0);
  unsigned picked = 0;
  for (int j = 1; j < m; ++j) {
    float best = -1.0f;   // every thread owns a point: n > 16 * 1024
    unsigned best_i = 0;
#pragma unroll 4
    for (int i = t; i < n; i += nt) {
      const float3 q = point_at(p, i);
      const float d =
          fminf(dist[i], sqdist(q.x, q.y, q.z, last.x, last.y, last.z));
      dist[i] = d;
      if (d > best) {
        best = d;
        best_i = i;
      }
    }
    picked = block_argmax(slots, j, best, best_i, warp, lane);
    last = point_at(p, picked);
    if (t == 0) o[j] = static_cast<int>(picked);
  }
}

int launch(const float* xyz, float* dist, int* out, int b, int n, int m,
           cudaStream_t stream) {
  const int threads = fps_threads(n);
  // the cloud's float4 copy where it fits in shared memory
  const bool in_smem = n <= kCloudMaxPoints;
  const size_t smem = in_smem ? sizeof(float4) * static_cast<size_t>(n) : 0;
  cudaError_t err = cudaSuccess;
  switch (fps_points(n)) {
#define BDM_FPS_CASE(K)                                                     \
  case K:                                                                   \
    if (in_smem) {                                                          \
      err = bdm_allow_smem(fps_kernel<K, true>, smem);                      \
      if (err != cudaSuccess) return static_cast<int>(err);                 \
      fps_kernel<K, true><<<b, threads, smem, stream>>>(xyz, out, n, m);    \
    } else {                                                                \
      fps_kernel<K, false><<<b, threads, 0, stream>>>(xyz, out, n, m);      \
    }                                                                       \
    break;
    BDM_FPS_CASE(1)
    BDM_FPS_CASE(2)
    BDM_FPS_CASE(4)
    BDM_FPS_CASE(8)
    BDM_FPS_CASE(16)
#undef BDM_FPS_CASE
    default: {   // K 32 and above
      if (dist == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      fps_stream_kernel<<<b, threads, 0, stream>>>(xyz, dist, out, n, m);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `dist`: (B, N) float32 scratch for the streamed variant
// (`bdm_fps_points(n)` > 16), else unused and may be null.
BDM_EXPORT int bdm_fps(const float* xyz, float* dist, int* out, int b, int n,
                       int m, cudaStream_t stream) {
  return launch(xyz, dist, out, b, n, m, stream);
}

BDM_EXPORT int bdm_fps_threads(int n) { return fps_threads(n); }

BDM_EXPORT int bdm_fps_points(int n) { return fps_points(n); }
