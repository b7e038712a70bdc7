// Three nearest centres and their inverse-distance weights.
//
// Replaces the TPU kernel `_tnn_kernel` / `three_nn_pallas`
// (bdm_tpu/ops/pallas/three_nn.py). Semantics: for each query point the
// three centres with the smallest squared distance, ordered by (distance,
// index), so the lower index wins a tie; distances clamped to
// [1e-10, 1e10]; weights w_i = prod_{j != i} d_j / (d0*d1 + d0*d2 + d1*d2).
//
// Bound on the H100: compute. Every query scans all M centres (M <= 1024
// on the main path), 8 flops a pair.
// Design: one thread per query point; centres stream through shared memory
// in tiles of 1024 and are read as broadcasts. The running best three are
// kept in registers with strict `<` insertion, which yields the same
// (distance, index) order as three masked argmins. The clamp and the
// weights are computed in the kernel with every operation rounded on its
// own, in the reference's order.
#include "common.cuh"

namespace {

constexpr int kTnnThreads = 256;
constexpr int kTnnTile = 1024;

__global__ void __launch_bounds__(kTnnThreads)
    three_nn_kernel(const float* __restrict__ points,
                    const float* __restrict__ centers, int* __restrict__ idx,
                    float* __restrict__ weight, int n, int m) {
  __shared__ float sx[kTnnTile], sy[kTnnTile], sz[kTnnTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = q < n;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (active) {
    const float* pp = points + (static_cast<size_t>(b) * n + q) * 3;
    px = pp[0];
    py = pp[1];
    pz = pp[2];
  }
  const float* cb = centers + static_cast<size_t>(b) * m * 3;
  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int t0 = 0; t0 < m; t0 += kTnnTile) {
    const int lim = min(kTnnTile, m - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < lim; i += blockDim.x) {
      const float* c = cb + static_cast<size_t>(t0 + i) * 3;
      sx[i] = c[0];
      sy[i] = c[1];
      sz[i] = c[2];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < lim; ++i) {
      const float d = sqdist(px, py, pz, sx[i], sy[i], sz[i]);
      const int j = t0 + i;
      if (d < d0) {
        d2 = d1; i2 = i1;
        d1 = d0; i1 = i0;
        d0 = d;  i0 = j;
      } else if (d < d1) {
        d2 = d1; i2 = i1;
        d1 = d;  i1 = j;
      } else if (d < d2) {
        d2 = d;  i2 = j;
      }
    }
  }
  if (!active) return;
  d0 = fminf(fmaxf(d0, 1e-10f), 1e10f);
  d1 = fminf(fmaxf(d1, 1e-10f), 1e10f);
  d2 = fminf(fmaxf(d2, 1e-10f), 1e10f);
  const float p12 = __fmul_rn(d1, d2);
  const float p02 = __fmul_rn(d0, d2);
  const float p01 = __fmul_rn(d0, d1);
  const float denom = __fadd_rn(__fadd_rn(p01, p02), p12);
  const size_t o = (static_cast<size_t>(b) * n + q) * 3;
  idx[o] = i0;
  idx[o + 1] = i1;
  idx[o + 2] = i2;
  weight[o] = __fdiv_rn(p12, denom);
  weight[o + 1] = __fdiv_rn(p02, denom);
  weight[o + 2] = __fdiv_rn(p01, denom);
}

}  // namespace

BDM_EXPORT int bdm_three_nn(const float* points, const float* centers,
                            int* idx, float* weight, int b, int n, int m,
                            cudaStream_t stream) {
  const dim3 grid((n + kTnnThreads - 1) / kTnnThreads, b);
  three_nn_kernel<<<grid, kTnnThreads, 0, stream>>>(points, centers, idx,
                                                    weight, n, m);
  return static_cast<int>(cudaGetLastError());
}
