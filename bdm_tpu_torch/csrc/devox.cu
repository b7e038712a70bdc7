// Trilinear devoxelization of a channel-last voxel grid at the points,
// gated by the squeeze-excitation scale and added to the point branch: the
// whole output of a PVConv after its voxel layers, in one launch.
//
// Replaces no TPU kernel: `bdm_tpu/ops/voxelize.py::trilinear_devoxelize`
// is jnp, which XLA fuses on the TPU with the gate and the residual. Eager
// PyTorch ran it as 8 gathers with their own index and weight arithmetic,
// summed in float32, then a cast, a multiply and an add: 143 launches a
// call, 2,002 a PVCNN2 forward (14 calls).
//
// Semantics (`ops/cuda/devox.py::gated_devoxelize_plain`), with dt() one
// rounding to the compute type T (bf16 or float32) and x in [0, R-1]:
//   out[b, n, c] = dt( dt( dt(sum_k w_k * grid[b, corner_k, c])
//                          * dt(gate[b, c]) ) + dt(pf[b, n, c]) )
// Per axis lo = floor(x) and frac = x - lo in float32; the upper corner
// along an axis is lo + 1 only where frac > 0, else lo again, and every
// one of the 8 corners is read (a zero weight times a non-finite value
// gives NaN, as in the plain version). A corner's weight is (wx * wy) * wz,
// w = frac on the upper side and 1 - frac on the lower; the sum starts from
// +0 and adds the corners dx outer, dy, dz inner. Every product and sum is
// rounded on its own (`__fmul_rn`, `__fadd_rn`: nvcc contracts no FMA), so
// the output is the plain version's bit for bit. At float32 the three
// roundings are exact float32 operations.
//
// Bound on the H100: bytes. A call writes out and reads pf (B*N*C*e each),
// the coordinates (B*N*12), the gate (B*C*4) and the grid rows its points'
// corners touch: at B 64 the 14 calls of a PVCNN2 forward hold
// sum N*C = 1,392,640 elements a cloud, 89.1 M in all, so out, pf and the
// coordinates alone are 0.37 GB in bf16 (0.11 ms at 3.35 TB/s); a sample's
// grid is 0.26-4 MB and its corner reads mostly hit L2. Measured on an H100
// 80GB HBM3 at 700 W (`chip_smoke.py` phase a), those 14 calls take 0.302 ms
// back to back, 56.5 % of their bound with the distinct grid rows counted.
//
// Design: thread t of a block of T = 256 takes 16 bytes of channels
// (W = 8 bf16 or 4 float32), group j = t % (C / W), of point
// p = t / (C / W): the C / W lanes of a point read its coordinates once
// (one broadcast request), compute its corners and weights, then issue all
// 8 corner loads, the pf load and the gate load before the first product,
// and store 16 bytes. Points on x, the batch element on y; offsets inside
// a sample are 32-bit (the wrapper refuses N*C or R^3*C of 2^31 or more).
// C must be a multiple of W: every width of the models is a multiple of 8,
// and the wrapper refuses any other.
// Corners are clamped to [0, R-1] so that no coordinate reads outside the
// grid (the wrapper's coordinates are clamped already).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // a block

// The VEC float32 gate values of channels [c0, c0 + VEC), each rounded to
// T (16-byte loads: VEC is a multiple of 4 and the wrapper checks the
// gate's alignment)
template <typename T, int VEC>
__device__ __forceinline__ void load_gate(const float* __restrict__ g,
                                          float (&out)[VEC]) {
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(g) + q);
    out[4 * q] = to_f32(from_f32<T>(v.x));
    out[4 * q + 1] = to_f32(from_f32<T>(v.y));
    out[4 * q + 2] = to_f32(from_f32<T>(v.z));
    out[4 * q + 3] = to_f32(from_f32<T>(v.w));
  }
}

// VEC = 16 / sizeof(T) channels a thread
template <typename T, int VEC = static_cast<int>(16 / sizeof(T))>
__global__ void __launch_bounds__(kThreads)
    devox_kernel(const T* __restrict__ grid, const float* __restrict__ coords,
                 const float* __restrict__ gate, const T* __restrict__ pf,
                 T* __restrict__ out, int n, int r, int c) {
  using Vec = uint4;
  const int groups = c / VEC;
  const int t = static_cast<int>(blockIdx.x) * kThreads +
                static_cast<int>(threadIdx.x);
  if (t >= n * groups) return;
  const long long b = blockIdx.y;
  const int p = t / groups;
  const int j = t - p * groups;

  const float* xyz = coords + (b * n + p) * 3;
  int lo[3], up[3];
  float w0[3], w1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x = __ldg(xyz + a);
    const float f = floorf(x);
    const float frac = __fsub_rn(x, f);
    lo[a] = min(max(static_cast<int>(f), 0), r - 1);
    up[a] = frac > 0.0f ? min(lo[a] + 1, r - 1) : lo[a];
    w0[a] = __fsub_rn(1.0f, frac);
    w1[a] = frac;
  }

  const Vec* gb = reinterpret_cast<const Vec*>(grid) +
                  b * r * r * r * groups + j;
  Vec corner[8];
  float w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const int id = ((dx ? up[0] : lo[0]) * r + (dy ? up[1] : lo[1])) * r +
                   (dz ? up[2] : lo[2]);
    corner[k] = __ldg(gb + id * groups);
    w[k] = __fmul_rn(__fmul_rn(dx ? w1[0] : w0[0], dy ? w1[1] : w0[1]),
                     dz ? w1[2] : w0[2]);
  }
  const long long row = (b * n + p) * groups + j;
  const Vec res = __ldg(reinterpret_cast<const Vec*>(pf) + row);
  float g[VEC];
  load_gate<T, VEC>(gate + b * c + j * VEC, g);

  const T* rv = reinterpret_cast<const T*>(&res);
  Vec o;
  T* ov = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc = __fadd_rn(
          acc, __fmul_rn(w[k], to_f32(reinterpret_cast<const T*>(
                                   &corner[k])[v])));
    const float d = to_f32(from_f32<T>(acc));
    const float m = to_f32(from_f32<T>(__fmul_rn(d, g[v])));
    ov[v] = from_f32<T>(__fadd_rn(m, to_f32(rv[v])));
  }
  reinterpret_cast<Vec*>(out)[row] = o;
}

template <typename T>
int launch(const void* grid, const float* coords, const float* gate,
           const void* pf, void* out, int b, int n, int r, int c,
           cudaStream_t stream) {
  const long long threads = static_cast<long long>(n) * c * sizeof(T) / 16;
  const dim3 blocks(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                    b);
  devox_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(grid), coords, gate, static_cast<const T*>(pf),
      static_cast<T*>(out), n, r, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grid (B, R, R, R, C) and pf, out (B, N, C) of type `dtype`; coords
// (B, N, 3) and gate (B, C) float32
BDM_EXPORT int bdm_devox(const void* grid, const float* coords,
                         const float* gate, const void* pf, void* out, int b,
                         int n, int r, int c, int dtype,
                         cudaStream_t stream) {
  if (b < 0 || n < 0 || r < 1 || c < 1 || b > 65535 ||
      static_cast<long long>(n) * c >= (1LL << 31) ||
      static_cast<long long>(r) * r * r * c >= (1LL << 31) ||
      (dtype != BDM_F32 && dtype != BDM_BF16) ||
      c % (dtype == BDM_BF16 ? 8 : 4) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * n == 0) return static_cast<int>(cudaSuccess);
  if (dtype == BDM_BF16)
    return launch<__nv_bfloat16>(grid, coords, gate, pf, out, b, n, r, c,
                                 stream);
  return launch<float>(grid, coords, gate, pf, out, b, n, r, c, stream);
}
