// 3x3x3 SAME voxel convolution with bias, channel-last.
//
// Replaces the TPU kernels `_conv_ms_kernel` / `conv3d_ms_pallas` (narrow
// inputs, Cin <= 256) and `_conv_mm_kernel` / `conv3d_mm_pallas` (the
// 390-channel PC2 stage-0 input) in bdm_tpu/ops/pallas/conv3d.py. One
// kernel serves every width. Input (B, R, R, R, Cin) and weights
// (27 * Cin, Cout) in float32 or bfloat16, float32 accumulation, bias added
// in float32, one rounding to the input type at the store.
//
// Bound on the H100: arithmetic. The stage-0 conv alone is
// 2 * B * R^3 * Cout * 27 * Cin = 22 GFLOP a cloud, far above the bytes it
// reads. This first version runs on the CUDA cores in float32 (the tensor
// cores, through wgmma, are later work).
// Design: an implicit GEMM. Rows are the B * R^3 output voxels, columns
// the Cout channels, the reduction runs over 27 taps x Cin. A block of 256
// threads computes a 64 x 64 output tile, 4 x 4 per thread, and stages
// 64 x 16 slices of the implicit im2col matrix and 16 x 64 slices of the
// weights in shared memory. Borders come from bounds checks while the
// input slice is staged, so there is no pad pass and no im2col buffer.
#include "common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kConvThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
    conv3d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, int b,
                  int r, int cin, int cout) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int r3 = r * r * r;
  const long long mtot = static_cast<long long>(b) * r3;
  const int k_total = 27 * cin;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // the four im2col rows this thread stages: m = tid / kBK + 16 * i
  const int a_k = tid % kBK;
  int row_b[4], row_z[4], row_y[4], row_x[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + tid / kBK + 16 * i;
    row_ok[i] = m < mtot;
    const long long mm = row_ok[i] ? m : 0;
    const int p = static_cast<int>(mm % r3);
    row_b[i] = static_cast<int>(mm / r3);
    row_z[i] = p / (r * r);
    row_y[i] = (p / r) % r;
    row_x[i] = p % r;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k_total; k0 += kBK) {
    const int kg = k0 + a_k;
    const int tap = kg / cin;
    const int ci = kg - tap * cin;
    const int dz = tap / 9 - 1;
    const int dy = (tap / 3) % 3 - 1;
    const int dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.0f;
      const int zz = row_z[i] + dz, yy = row_y[i] + dy, xx = row_x[i] + dx;
      if (kg < k_total && row_ok[i] && zz >= 0 && zz < r && yy >= 0 &&
          yy < r && xx >= 0 && xx < r) {
        const size_t off =
            ((((static_cast<size_t>(row_b[i]) * r + zz) * r + yy) * r + xx) *
             cin) + ci;
        v = to_f32(x[off]);
      }
      As[a_k][tid / kBK + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + kConvThreads * i;
      const int bk = e / kBN;
      const int bn = e % kBN;
      const int kk = k0 + bk;
      const int nn = n0 + bn;
      Bs[bk][bn] = (kk < k_total && nn < cout)
                       ? to_f32(w[static_cast<size_t>(kk) * cout + nn])
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= mtot) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx * 4 + j;
      if (nn < cout)
        out[m * cout + nn] = from_f32<T>(acc[i][j] + bias[nn]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const float* bias, void* out, int b,
           int r, int cin, int cout, cudaStream_t stream) {
  const long long mtot = static_cast<long long>(b) * r * r * r;
  const dim3 grid(static_cast<unsigned>((mtot + kBM - 1) / kBM),
                  (cout + kBN - 1) / kBN);
  conv3d_kernel<T><<<grid, kConvThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(out), b, r, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

BDM_EXPORT int bdm_conv3d(const void* x, const void* w, const float* bias,
                          void* out, int b, int r, int cin, int cout,
                          int dtype, cudaStream_t stream) {
  if (dtype == BDM_F32)
    return launch<float>(x, w, bias, out, b, r, cin, cout, stream);
  if (dtype == BDM_BF16)
    return launch<__nv_bfloat16>(x, w, bias, out, b, r, cin, cout, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
