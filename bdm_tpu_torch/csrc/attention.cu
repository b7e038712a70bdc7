// Voxel self-attention: softmax(q k^T) v with NO 1/sqrt(C) scale.
//
// Replaces the TPU kernel `_attn_kernel` / `_attention_pallas_fwd_only`
// (bdm_tpu/ops/pallas/attention.py). q, k, v are (B, S, C) float32 or
// bfloat16 with C <= 128; logits and softmax in float32; under bfloat16
// the probabilities are rounded to bfloat16 before the product with v, as
// the reference casts its weights to v's type; float32 accumulation; the
// output has v's type.
//
// Bound on the H100: arithmetic, 4 * S^2 * C flops a cloud (34 GFLOP at
// B = 8, S = 4096, C = 64) against a few MB of operands. This first
// version runs on the CUDA cores (the tensor cores are later work).
// Design: one block of 256 threads per (cloud, 64-query tile). The block
// walks the keys in tiles of 64 with an online softmax, so the S x S
// logits never reach device memory: the query tile, the key and value
// tiles and the 64 x 64 probability tile live in shared memory; each
// thread keeps a quarter of one query's output row in registers.
#include "common.cuh"

namespace {

constexpr int kAQ = 64;
constexpr int kAK = 64;
constexpr int kAttnThreads = 256;
constexpr int kMaxC = 128;
constexpr int kPerThread = kMaxC / 4;

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int s,
                     int c) {
  extern __shared__ float sm[];
  const int ld = c + 1;
  float* qs = sm;
  float* ks = qs + kAQ * ld;
  float* vs = ks + kAK * ld;
  float* ps = vs + kAK * ld;            // [kAQ][kAK + 1]
  float* row_max = ps + kAQ * (kAK + 1);
  float* row_sum = row_max + kAQ;
  float* row_scale = row_sum + kAQ;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kAQ;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(b) * s * c;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int e = tid; e < kAQ * c; e += kAttnThreads) {
    const int qi = e / c, ch = e % c;
    qs[qi * ld + ch] =
        q0 + qi < s ? to_f32(qb[static_cast<size_t>(q0 + qi) * c + ch]) : 0.f;
  }
  if (tid < kAQ) {
    row_max[tid] = -INFINITY;
    row_sum[tid] = 0.0f;
  }
  const int my_q = tid >> 2;
  const int part = tid & 3;
  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.0f;

  for (int k0 = 0; k0 < s; k0 += kAK) {
    __syncthreads();  // the previous tile's products are done
    for (int e = tid; e < kAK * c; e += kAttnThreads) {
      const int kj = e / c, ch = e % c;
      const bool ok = k0 + kj < s;
      const size_t off = static_cast<size_t>(k0 + kj) * c + ch;
      ks[kj * ld + ch] = ok ? to_f32(kb[off]) : 0.f;
      vs[kj * ld + ch] = ok ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kAQ * kAK; e += kAttnThreads) {
      const int qi = e / kAK, kj = e % kAK;
      float dot = 0.0f;
      for (int ch = 0; ch < c; ++ch)
        dot = fmaf(qs[qi * ld + ch], ks[kj * ld + ch], dot);
      ps[qi * (kAK + 1) + kj] = k0 + kj < s ? dot : -INFINITY;
    }
    __syncthreads();
    if (tid < kAQ) {
      float* prow = ps + tid * (kAK + 1);
      float tile_max = -INFINITY;
      for (int kj = 0; kj < kAK; ++kj) tile_max = fmaxf(tile_max, prow[kj]);
      const float m_old = row_max[tid];
      const float m_new = fmaxf(m_old, tile_max);
      const float scale = expf(m_old - m_new);  // 0 on the first tile
      float l = row_sum[tid] * scale;
      for (int kj = 0; kj < kAK; ++kj) {
        const float p = expf(prow[kj] - m_new);
        l += p;
        prow[kj] = to_f32(from_f32<T>(p));  // weights in v's type
      }
      row_max[tid] = m_new;
      row_sum[tid] = l;
      row_scale[tid] = scale;
    }
    __syncthreads();
    const float scale = row_scale[my_q];
    const float* prow = ps + my_q * (kAK + 1);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int ch = part + 4 * j;
      if (ch < c) {
        float a = acc[j] * scale;
        for (int kj = 0; kj < kAK; ++kj)
          a = fmaf(prow[kj], vs[kj * ld + ch], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();
  if (q0 + my_q >= s) return;
  const float inv = 1.0f / row_sum[my_q];
  T* ob = out + base + static_cast<size_t>(q0 + my_q) * c;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int ch = part + 4 * j;
    if (ch < c) ob[ch] = from_f32<T>(acc[j] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int c, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(3) * kAQ * (c + 1) +
                       kAQ * (kAK + 1) + 3 * kAQ);
  cudaError_t err = bdm_allow_smem(attention_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kAQ - 1) / kAQ, b);
  attention_kernel<T><<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

BDM_EXPORT int bdm_attention(const void* q, const void* k, const void* v,
                             void* out, int b, int s, int c, int dtype,
                             cudaStream_t stream) {
  if (c > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == BDM_F32)
    return launch<float>(q, k, v, out, b, s, c, stream);
  if (dtype == BDM_BF16)
    return launch<__nv_bfloat16>(q, k, v, out, b, s, c, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
