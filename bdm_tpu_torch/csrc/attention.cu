// Voxel self-attention: softmax(q k^T) v with NO 1/sqrt(C) scale.
//
// Replaces the TPU kernel `_attn_kernel` / `_attention_pallas_fwd_only`
// (bdm_tpu/ops/pallas/attention.py). q, k, v are (B, S, C) float32 or
// bfloat16 with C <= 128; logits and softmax in float32; under bfloat16
// the probabilities are rounded to bfloat16 before the product with v, as
// the reference casts its weights to v's type, while the row sum is taken
// over the unrounded float32 probabilities; float32 accumulation; one
// rounding at the store; the output has v's type.
//
// Bound on the H100: arithmetic, 4 * S^2 * C flops a cloud (34 GFLOP at
// B = 8, S = 4096, C = 64) against a few MB of operands. Two kernels, chosen
// by type and shape alone (`bdm_attention_path`, mirrored by
// `kernel_path` of ops/cuda/attention.py):
//
// `attention_tc_kernel`: bfloat16 with C a multiple of 8. Flash-style on
// the tensor cores (`mma.sync.m16n8k16`, bf16 operands, float32
// accumulators). One block of four warps per (cloud, 128-query tile); a
// warp owns 32 query rows, so every K or V fragment it loads from shared
// memory feeds two products. Q is staged once; K and V tiles of 64 keys
// arrive in a two-stage ring of 16-byte `cp.async` copies while the
// previous tile is multiplied. Rows of shared memory are padded by 16 bytes
// so the eight rows of an `ldmatrix` fall into different banks. S = Q K^T
// lands in accumulator registers; the row maximum and sum are reduced by
// shuffles inside the four lanes that hold a row; P is rounded to bf16 in
// registers, where the accumulator layout of two neighbouring 8-key tiles
// is already the A-operand layout of one 16-key step, and multiplied with V
// read through `ldmatrix.trans` (V is (S, C) row-major, key-major for that
// product); O is rescaled in registers by the online-softmax factor. The
// S x S logits never reach shared or device memory. A ragged S is masked
// with -inf on the key side (zero-filled K and V rows) and by skipped
// stores on the query side; C below the padded width is zero-filled.
//
// `attention_simt_kernel`: float32 (the plain version multiplies in full
// float32 and is held to 1e-4, which one TF32 product does not meet) and
// any bfloat16 C that is not a multiple of 8. float32 FMAs on the CUDA
// cores: one block of 256 threads per (cloud, 64-query tile) walks the keys
// in tiles of 64 with an online softmax; the query tile, the key and value
// tiles and the 64 x 64 probability tile live in shared memory; each thread
// keeps a quarter of one query's output row in registers.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxC = 128;

// ---------------------------------------------------------------- tensor cores

constexpr int kTcQ = 128;        // queries a block: 4 warps x 32 rows
constexpr int kTcK = 64;         // keys a tile
constexpr int kTcThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// Stage `nrows` rows of CP channels (16-byte pieces; rows from `s` on and
// channels from `c` on become zeros) at `dst`, row pitch PITCH bytes.
template <int CP, int PITCH>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const __nv_bfloat16* src, int row0,
                                           int nrows, int s, int c, int tid) {
  constexpr int kPieces = CP / 8;
  for (int e = tid; e < nrows * kPieces; e += kTcThreads) {
    const int rr = e / kPieces, piece = e % kPieces;
    const int row = row0 + rr;
    const bool ok = row < s && piece * 8 < c;
    const __nv_bfloat16* from =
        ok ? src + static_cast<size_t>(row) * c + piece * 8 : src;
    cp_async16(smem_u32(dst + rr * PITCH + piece * 16), from, ok ? 16 : 0);
  }
}

template <int CP>   // the channel width the tile is padded to
__global__ void __launch_bounds__(kTcThreads, 2)
    attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out, int s, int c) {
  constexpr int PITCH = CP * 2 + 16;   // bytes; 16 * odd: no bank conflicts
  constexpr int KS = CP / 16;          // 16-channel steps of q k^T
  constexpr int NT = kTcK / 8;         // 8-key tiles of the logits
  constexpr int CT = CP / 8;           // 8-channel tiles of the output
  constexpr bool kQInRegs = CP <= 64;  // else re-read from shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_s = smem;                      // [kTcQ][PITCH]
  unsigned char* k_s = q_s + kTcQ * PITCH;        // [2][kTcK][PITCH]
  unsigned char* v_s = k_s + 2 * kTcK * PITCH;    // [2][kTcK][PITCH]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTcQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * c;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;

  stage_rows<CP, PITCH>(q_s, qb, q0, kTcQ, s, c, tid);
  stage_rows<CP, PITCH>(k_s, kb, 0, kTcK, s, c, tid);
  stage_rows<CP, PITCH>(v_s, vb, 0, kTcK, s, c, tid);
  cp_async_commit();

  // ldmatrix row addresses of this lane (see mma.cuh): Q as A operand, K as
  // B operand of q k^T (rows are keys), V as B operand of p v (transposed)
  const uint32_t q_lane = smem_u32(q_s) +
                          (warp * 32 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              PITCH + (lane >> 4) * 16;
  const uint32_t k_lane = smem_u32(k_s) +
                          ((lane & 7) + (lane >> 4) * 8) * PITCH +
                          ((lane >> 3) & 1) * 16;
  const uint32_t v_lane = smem_u32(v_s) +
                          ((lane & 7) + ((lane >> 3) & 1) * 8) * PITCH +
                          (lane >> 4) * 16;

  float o[2][CT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][ct][e] = 0.0f;
  // running maximum and (this lane's share of the) sum of rows g and g + 8
  // of both 16-row tiles
  float row_max[2][2], row_sum[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row_max[mt][h] = -INFINITY;
      row_sum[mt][h] = 0.0f;
    }
  uint32_t qf[2][kQInRegs ? KS : 1][4];

  const int ntiles = (s + kTcK - 1) / kTcK;
  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1;
    const int k0 = it * kTcK;
    if (it + 1 < ntiles) {
      // the other stage was read in the previous iteration, which ended in
      // a barrier
      stage_rows<CP, PITCH>(k_s + (stage ^ 1) * kTcK * PITCH, kb, k0 + kTcK,
                            kTcK, s, c, tid);
      stage_rows<CP, PITCH>(v_s + (stage ^ 1) * kTcK * PITCH, vb, k0 + kTcK,
                            kTcK, s, c, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kQInRegs && it == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int ks = 0; ks < (kQInRegs ? KS : 1); ++ks)
          ldmatrix_x4(qf[mt][ks], q_lane + mt * 16 * PITCH + ks * 32);
    }

    // logits of 32 queries x 64 keys
    float sc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][nt][e] = 0.0f;
    const uint32_t k_st = k_lane + stage * kTcK * PITCH;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = qf[mt][kQInRegs ? ks : 0][e];
        } else {
          ldmatrix_x4(a[mt], q_lane + mt * 16 * PITCH + ks * 32);
        }
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, k_st + np * 16 * PITCH + ks * 32);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(sc[mt][2 * np], a[mt], bf[0], bf[1]);
          mma_bf16(sc[mt][2 * np + 1], a[mt], bf[2], bf[3]);
        }
      }
    }
    if (k0 + kTcK > s) {   // the ragged last tile: keys from s on
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + nt * 8 + 2 * t + (e & 1) >= s) sc[mt][nt][e] = -INFINITY;
    }

    // online softmax; every tile holds a key below s, so the new maximum
    // is finite and exp2(-inf - m) = 0 on the first tile
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mx = fmaxf(mx, fmaxf(sc[mt][nt][2 * h], sc[mt][nt][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(row_max[mt][h], mx);
        const float scale = fast_exp2((row_max[mt][h] - m_new) * kLog2e);
        row_max[mt][h] = m_new;
        const float mb = m_new * kLog2e;
        float sum = 0.0f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float p0 = fast_exp2(fmaf(sc[mt][nt][2 * h], kLog2e, -mb));
          const float p1 =
              fast_exp2(fmaf(sc[mt][nt][2 * h + 1], kLog2e, -mb));
          sum += p0 + p1;
          sc[mt][nt][2 * h] = p0;
          sc[mt][nt][2 * h + 1] = p1;
        }
        row_sum[mt][h] = row_sum[mt][h] * scale + sum;
#pragma unroll
        for (int ct = 0; ct < CT; ++ct) {
          o[mt][ct][2 * h] *= scale;
          o[mt][ct][2 * h + 1] *= scale;
        }
      }

    // O += P V, P rounded to bf16 in registers
    const uint32_t v_st = v_lane + stage * kTcK * PITCH;
#pragma unroll
    for (int ks = 0; ks < kTcK / 16; ++ks) {
      uint32_t pa[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        pa[mt][0] = pack_bf16(sc[mt][2 * ks][0], sc[mt][2 * ks][1]);
        pa[mt][1] = pack_bf16(sc[mt][2 * ks][2], sc[mt][2 * ks][3]);
        pa[mt][2] = pack_bf16(sc[mt][2 * ks + 1][0], sc[mt][2 * ks + 1][1]);
        pa[mt][3] = pack_bf16(sc[mt][2 * ks + 1][2], sc[mt][2 * ks + 1][3]);
      }
#pragma unroll
      for (int cp = 0; cp < CT / 2; ++cp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, v_st + ks * 16 * PITCH + cp * 32);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(o[mt][2 * cp], pa[mt], bf[0], bf[1]);
          mma_bf16(o[mt][2 * cp + 1], pa[mt], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();   // this stage is free for the tile after the next
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = row_sum[mt][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + warp * 32 + mt * 16 + g + 8 * h;
      if (row >= s) continue;
      const float inv = 1.0f / l;
      __nv_bfloat16* orow = out + base + static_cast<size_t>(row) * c;
#pragma unroll
      for (int ct = 0; ct < CT; ++ct) {
        const int col = ct * 8 + 2 * t;
        if (col < c)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[mt][ct][2 * h] * inv,
                                    o[mt][ct][2 * h + 1] * inv);
      }
    }
}

template <int CP>
int launch_tc(const void* q, const void* k, const void* v, void* out, int b,
              int s, int c, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTcQ + 4 * kTcK) * (CP * 2 + 16);
  cudaError_t err = bdm_allow_smem(attention_tc_kernel<CP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kTcQ - 1) / kTcQ, b);
  attention_tc_kernel<CP><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      s, c);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ CUDA cores

constexpr int kAQ = 64;
constexpr int kAK = 64;
constexpr int kAttnThreads = 256;
constexpr int kPerThread = kMaxC / 4;

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
int launch_simt(const void* q, const void* k, const void* v, void* out, int b,
                int s, int c, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(3) * kAQ * (c + 1) +
                       kAQ * (kAK + 1) + 3 * kAQ);
  cudaError_t err = bdm_allow_smem(attention_simt_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kAQ - 1) / kAQ, b);
  attention_simt_kernel<T><<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, c);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Which kernel a call takes: 1 the tensor-core kernel, 0 the CUDA-core one.
// A rule on type and shape alone.
BDM_EXPORT int bdm_attention_path(int dtype, int s, int c) {
  (void)s;
  return dtype == BDM_BF16 && c % 8 == 0 && c <= kMaxC ? 1 : 0;
}

BDM_EXPORT int bdm_attention(const void* q, const void* k, const void* v,
                             void* out, int b, int s, int c, int dtype,
                             cudaStream_t stream) {
  if (c > kMaxC || c < 1 || s < 1 || b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bdm_attention_path(dtype, s, c) == 1) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out)))
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (c <= 32) return launch_tc<32>(q, k, v, out, b, s, c, stream);
    if (c <= 64) return launch_tc<64>(q, k, v, out, b, s, c, stream);
    return launch_tc<128>(q, k, v, out, b, s, c, stream);
  }
  if (dtype == BDM_F32)
    return launch_simt<float>(q, k, v, out, b, s, c, stream);
  if (dtype == BDM_BF16)
    return launch_simt<__nv_bfloat16>(q, k, v, out, b, s, c, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
