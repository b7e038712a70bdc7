// Unsorted segment sum: out[b, s, :] = sum of feats[b, n, :] over the rows
// n with ids[b, n] == s.
//
// Replaces the TPU kernel `_scatter_kernel` / `scatter_sum_pallas`
// (bdm_tpu/ops/pallas/voxelize.py). Semantics: features (B, N, C) in
// float32 or bfloat16, ids (B, N) int32, float32 accumulation, (B, S, C)
// float32 out; a segment no row names is zero and a row whose id lies
// outside [0, S) is dropped, as the TPU kernel's one-hot product drops it.
// The caller on the training path is the backward of the three-neighbour
// blend (interp.cu): the 3N weighted cotangent rows are summed into the M
// centres they were read from.
//
// Bound on the H100: bytes (one read of the rows and ids, one write of the
// sums; two operations a feature).
// Design: like the one-hot product, every segment looks at every id, so no
// sort, no atomics, and the rows of a segment are added in index order:
// the result is deterministic and equals a sequential `index_add_` bit for
// bit. A warp owns one segment. The block stages the ids of its batch
// element in shared memory a chunk at a time; each lane compares one id of
// a group of 32 with the warp's segment, a ballot collects the hits, and
// for every hit, lowest index first, the lanes add that row's channels
// (lane-strided, so a row is read in 128-byte pieces). The compares cost
// N / 32 ballots a segment, far below the reads they select.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;          // segments a block
constexpr int kChunk = 2048;       // ids staged at a time
constexpr int kAcc = 8;            // channels a lane holds a pass (256 wide)

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    scatter_sum_kernel(const T* __restrict__ feats,
                       const int* __restrict__ ids, float* __restrict__ out,
                       int n, int c, int s) {
  __shared__ int ids_s[kChunk];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int seg = blockIdx.x * kWarps + warp;
  const int* ids_b = ids + static_cast<size_t>(b) * n;
  const T* feats_b = feats + static_cast<size_t>(b) * n * c;

  // a pass covers 32 * kAcc channels; wider rows take another scan
  for (int c0 = 0; c0 < c; c0 += 32 * kAcc) {
    float acc[kAcc];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;
    for (int n0 = 0; n0 < n; n0 += kChunk) {
      const int len = min(kChunk, n - n0);
      __syncthreads();           // the previous chunk is consumed
      for (int i = threadIdx.x; i < len; i += blockDim.x)
        ids_s[i] = ids_b[n0 + i];
      __syncthreads();
      if (seg >= s) continue;    // the warp still takes part in the barriers
      for (int i0 = 0; i0 < len; i0 += 32) {
        const int i = i0 + lane;
        unsigned hits = __ballot_sync(0xffffffffu,
                                      i < len && ids_s[i] == seg);
        while (hits) {
          const int k = __ffs(hits) - 1;
          hits &= hits - 1;
          const T* row = feats_b + static_cast<size_t>(n0 + i0 + k) * c + c0;
#pragma unroll
          for (int j = 0; j < kAcc; ++j) {
            const int ch = lane + 32 * j;
            if (c0 + ch < c) acc[j] = __fadd_rn(acc[j], to_f32(row[ch]));
          }
        }
      }
    }
    if (seg < s) {
      float* o = out + (static_cast<size_t>(b) * s + seg) * c + c0;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int ch = lane + 32 * j;
        if (c0 + ch < c) o[ch] = acc[j];
      }
    }
  }
}

template <typename T>
int launch(const void* feats, const int* ids, float* out, int b, int n,
           int c, int s, cudaStream_t stream) {
  if (b == 0 || s == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((s + kWarps - 1) / kWarps, b);
  scatter_sum_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(feats), ids, out, n, c, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

BDM_EXPORT int bdm_scatter_sum(const void* feats, const int* ids, float* out,
                               int b, int n, int c, int s, int dtype,
                               cudaStream_t stream) {
  if (dtype == BDM_F32)
    return launch<float>(feats, ids, out, b, n, c, s, stream);
  if (dtype == BDM_BF16)
    return launch<__nv_bfloat16>(feats, ids, out, b, n, c, s, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
