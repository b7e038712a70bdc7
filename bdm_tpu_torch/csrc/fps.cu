// Furthest point sampling.
//
// Replaces the TPU kernel `_fps_kernel` / `furthest_point_sample_pallas`
// (bdm_tpu/ops/pallas/fps.py). Semantics: start from index 0; each of the
// M-1 rounds lowers every point's running min squared distance by its
// distance to the last pick and picks the argmax, lowest index on ties.
//
// Bound on the H100: the M-1 rounds are sequential and each one ends in a
// block-wide argmax, so the kernel is latency bound (one barrier pair per
// round), not bandwidth bound: a (4096, 3) cloud is 48 KB.
// Design: one block per cloud; coordinates and running distances live in
// dynamic shared memory (16 bytes a point, 64 KB at N = 4096), so no round
// touches device memory except the one index it writes. The argmax is a
// warp-shuffle reduction over (value, index) pairs and a second one over
// the per-warp winners.
#include "common.cuh"

namespace {

constexpr int kFpsThreads = 512;

__device__ __forceinline__ void argmax_pair(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kFpsThreads)
    fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n,
               int m) {
  extern __shared__ float smem[];
  float* px = smem;
  float* py = px + n;
  float* pz = py + n;
  float* dist = pz + n;
  __shared__ float warp_val[kFpsThreads / 32];
  __shared__ int warp_idx[kFpsThreads / 32];
  __shared__ int picked;

  const int b = blockIdx.x;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  int* o = out + static_cast<size_t>(b) * m;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    px[i] = p[3 * i];
    py[i] = p[3 * i + 1];
    pz[i] = p[3 * i + 2];
    dist[i] = 1e38f;
  }
  if (threadIdx.x == 0) o[0] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int last = 0;
  for (int j = 1; j < m; ++j) {
    const float lx = px[last], ly = py[last], lz = pz[last];
    float best = -1.0f;
    int best_i = n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float d = fminf(dist[i], sqdist(px[i], py[i], pz[i], lx, ly, lz));
      dist[i] = d;
      if (d > best) {  // indices rise within a thread: strict > keeps lowest
        best = d;
        best_i = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      argmax_pair(best, best_i, __shfl_down_sync(0xffffffffu, best, off),
                  __shfl_down_sync(0xffffffffu, best_i, off));
    }
    if (lane == 0) {
      warp_val[warp] = best;
      warp_idx[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? warp_val[lane] : -1.0f;
      best_i = lane < nwarps ? warp_idx[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        argmax_pair(best, best_i, __shfl_down_sync(0xffffffffu, best, off),
                    __shfl_down_sync(0xffffffffu, best_i, off));
      }
      if (lane == 0) {
        picked = best_i;
        o[j] = best_i;
      }
    }
    __syncthreads();
    last = picked;
  }
}

}  // namespace

BDM_EXPORT int bdm_fps(const float* xyz, int* out, int b, int n, int m,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(n);
  cudaError_t err = bdm_allow_smem(fps_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<b, kFpsThreads, smem, stream>>>(xyz, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
