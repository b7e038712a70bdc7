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
// any bfloat16 C that is not a multiple of 8. Exact float32 FMAs on the
// CUDA cores, the FlashAttention-2 dataflow. Bound, as it is written, by
// shared-memory loads and FMA issue: its design is that every 16-byte load
// from shared memory feeds 10-16 FMAs. Eight lanes share a query row: a
// lane computes the logits of TQ queries x 8 keys (keys tk + 8j, so the
// eight lanes' float4 reads of K fall 4 banks apart) from float4 reads of
// row-major Q and K tiles (8 + TQ loads a 4-channel step for 32 TQ FMAs);
// the row maximum and sum are reduced by three shuffles over the eight
// lanes, so every thread works in the softmax; P goes once to shared
// memory, key-major, and O += P V is a micro-tile of TQ queries x C / 8
// channels a lane (channels 4 tk + 32 ct). TQ 8 and 256 threads (256
// queries a block) up to C 64; TQ 4 and 128 threads at C 128, where a
// lane's output rows would not fit in registers. K and V tiles of 64 keys
// arrive in a two-stage ring of 16-byte `cp.async` copies (4-byte ones when
// C % 4 != 0; bfloat16 is widened through registers) under the products of
// the tile before: two barriers a tile. Rounding, masking and the row sum
// are those of the tensor-core kernel, the probability rounded to v's type
// (the identity at float32).
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

constexpr int kSimtK = 64;                      // keys a tile
constexpr int kRowLanes = 8;                    // lanes that share a query row
constexpr int kLaneKeys = kSimtK / kRowLanes;   // keys a lane: tk + 8 j

// The block by the padded channel width CP: TQ queries a thread, THREADS
// threads, so TQ * THREADS / 8 queries a block. At CP 128 a thread's output
// rows (TQ x CP / 8 floats) would not fit in registers with TQ 8.
template <int CP>
struct SimtShape {
  static constexpr int TQ = CP <= 64 ? 8 : 4;
  static constexpr int THREADS = CP <= 64 ? 256 : 128;
  static constexpr int BQ = TQ * THREADS / kRowLanes;
};

template <int CP>
constexpr size_t simt_smem_bytes() {
  constexpr int BQ = SimtShape<CP>::BQ;
  return sizeof(float) * (static_cast<size_t>(BQ) * CP +
                          2 * kSimtK * (CP + 4) + 2 * kSimtK * CP +
                          kSimtK * (BQ + 4));
}

// Stage `nrows` rows of CP float32 channels at `dst` (row pitch PITCH
// floats); rows from `s` on and channels from `c` on become zeros. float32
// by 16-byte `cp.async` where every row is 16-byte aligned (`vec16`), else
// by 4-byte ones; bfloat16 through registers, widened to float32.
template <int CP, int PITCH, int THREADS, typename T>
__device__ __forceinline__ void stage_simt(float* dst, const T* src, int row0,
                                           int nrows, int s, int c,
                                           bool vec16, int tid) {
  if constexpr (sizeof(T) == 4) {
    if (vec16) {
      constexpr int kPieces = CP / 4;
      for (int e = tid; e < nrows * kPieces; e += THREADS) {
        const int rr = e / kPieces, piece = e % kPieces;
        const int row = row0 + rr;
        const bool ok = row < s && piece * 4 < c;
        cp_async16(smem_u32(dst + rr * PITCH + piece * 4),
                   ok ? src + static_cast<size_t>(row) * c + piece * 4 : src,
                   ok ? 16 : 0);
      }
      return;
    }
  }
  for (int e = tid; e < nrows * CP; e += THREADS) {
    const int rr = e / CP, ch = e % CP;
    const int row = row0 + rr;
    const bool ok = row < s && ch < c;
    const T* from = ok ? src + static_cast<size_t>(row) * c + ch : src;
    if constexpr (sizeof(T) == 4)
      cp_async4(smem_u32(dst + rr * PITCH + ch), from, ok ? 4 : 0);
    else
      dst[rr * PITCH + ch] = ok ? to_f32(*from) : 0.0f;
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <typename T, int CP>
__global__ void __launch_bounds__(SimtShape<CP>::THREADS, 1)
    attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out,
                          int s, int c, int vec16) {
  constexpr int TQ = SimtShape<CP>::TQ;
  constexpr int THREADS = SimtShape<CP>::THREADS;
  constexpr int BQ = SimtShape<CP>::BQ;
  constexpr int KP = CP + 4;    // K rows: the 8 lanes of a row group read
                                // 8 keys, 4 banks apart
  constexpr int PP = BQ + 4;    // P rows (one a key): the same
  constexpr int CT = CP / 32;   // float4s of V (and of O) a lane, 32 apart
  extern __shared__ __align__(16) float sm[];
  float* q_s = sm;                          // [BQ][CP]
  float* k_s = q_s + BQ * CP;               // [2][kSimtK][KP]
  float* v_s = k_s + 2 * kSimtK * KP;       // [2][kSimtK][CP]
  float* p_s = v_s + 2 * kSimtK * CP;       // [kSimtK][PP], key-major

  const int tid = threadIdx.x;
  // keys tk + 8 j and channels 4 tk + 32 ct; rows q0 .. q0 + TQ - 1
  const int tk = tid & (kRowLanes - 1);
  const int q0 = (tid / kRowLanes) * TQ;
  const int qb = blockIdx.x * BQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * c;
  const T* kb = k + base;
  const T* vb = v + base;

  stage_simt<CP, CP, THREADS>(q_s, q + base, qb, BQ, s, c, vec16, tid);
  stage_simt<CP, KP, THREADS>(k_s, kb, 0, kSimtK, s, c, vec16, tid);
  stage_simt<CP, CP, THREADS>(v_s, vb, 0, kSimtK, s, c, vec16, tid);
  const float* q_rows = q_s + q0 * CP;
  cp_async_commit();

  float o[TQ][CT][4];
  float row_max[TQ], row_sum[TQ];   // row_sum: this lane's share
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    row_max[i] = -INFINITY;
    row_sum[i] = 0.0f;
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][ct][e] = 0.0f;
  }

  const int ntiles = (s + kSimtK - 1) / kSimtK;
  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1;
    const int k0 = it * kSimtK;
    cp_async_wait<0>();
    // tile `it` has landed for every thread, and every thread is done with
    // tile it - 1: its stage and P may be written again
    __syncthreads();
    if (it + 1 < ntiles) {
      stage_simt<CP, KP, THREADS>(k_s + (stage ^ 1) * kSimtK * KP, kb,
                                  k0 + kSimtK, kSimtK, s, c, vec16, tid);
      stage_simt<CP, CP, THREADS>(v_s + (stage ^ 1) * kSimtK * CP, vb,
                                  k0 + kSimtK, kSimtK, s, c, vec16, tid);
    }
    cp_async_commit();

    // logits of TQ queries x 8 keys: per 4 channels, 8 + TQ float4 loads
    // feed 32 TQ FMAs
    float sc[TQ][kLaneKeys];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < kLaneKeys; ++j) sc[i][j] = 0.0f;
    const float* ks = k_s + stage * kSimtK * KP + tk * KP;
#pragma unroll 2
    for (int cc = 0; cc < CP / 4; ++cc) {
      float4 kv[kLaneKeys];
#pragma unroll
      for (int j = 0; j < kLaneKeys; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + 8 * j * KP + 4 * cc);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_rows + i * CP + 4 * cc);
#pragma unroll
        for (int j = 0; j < kLaneKeys; ++j) {
          sc[i][j] = fmaf(qv.x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv.y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv.z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv.w, kv[j].w, sc[i][j]);
        }
      }
    }
    if (k0 + kSimtK > s) {   // the ragged last tile: keys from s on
#pragma unroll
      for (int j = 0; j < kLaneKeys; ++j)
        if (k0 + tk + 8 * j >= s)
#pragma unroll
          for (int i = 0; i < TQ; ++i) sc[i][j] = -INFINITY;
    }

    // online softmax; the row's maximum is reduced over its 8 lanes, so
    // every thread works in it. Every tile holds a key below s, so the new
    // maximum is finite and exp2(-inf - m) = 0 on the first tile
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < kLaneKeys; ++j) mx = fmaxf(mx, sc[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(row_max[i], mx);
      const float scale = fast_exp2((row_max[i] - m_new) * kLog2e);
      row_max[i] = m_new;
      const float mb = m_new * kLog2e;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kLaneKeys; ++j) {
        const float p = fast_exp2(fmaf(sc[i][j], kLog2e, -mb));
        sum += p;
        sc[i][j] = to_f32(from_f32<T>(p));   // weights in v's type
      }
      row_sum[i] = row_sum[i] * scale + sum;
#pragma unroll
      for (int ct = 0; ct < CT; ++ct)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][ct][e] *= scale;
    }
    // P to shared memory, key-major: a lane's TQ queries are contiguous
#pragma unroll
    for (int j = 0; j < kLaneKeys; ++j)
#pragma unroll
      for (int h = 0; h < TQ / 4; ++h)
        *reinterpret_cast<float4*>(p_s + (tk + 8 * j) * PP + q0 + 4 * h) =
            make_float4(sc[4 * h][j], sc[4 * h + 1][j], sc[4 * h + 2][j],
                        sc[4 * h + 3][j]);
    __syncthreads();

    // O += P V: a lane's TQ queries x CP / 8 channels; per key TQ / 4 + CT
    // float4 loads feed 4 TQ CT FMAs
    const float* vs = v_s + stage * kSimtK * CP + 4 * tk;
#pragma unroll 4
    for (int kk = 0; kk < kSimtK; ++kk) {
      float4 pv[TQ / 4], vv[CT];
#pragma unroll
      for (int h = 0; h < TQ / 4; ++h)
        pv[h] = *reinterpret_cast<const float4*>(p_s + kk * PP + q0 + 4 * h);
#pragma unroll
      for (int ct = 0; ct < CT; ++ct)
        vv[ct] = *reinterpret_cast<const float4*>(vs + kk * CP + 32 * ct);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const float p = lane_of(pv[i / 4], i % 4);
#pragma unroll
        for (int ct = 0; ct < CT; ++ct) {
          o[i][ct][0] = fmaf(p, vv[ct].x, o[i][ct][0]);
          o[i][ct][1] = fmaf(p, vv[ct].y, o[i][ct][1]);
          o[i][ct][2] = fmaf(p, vv[ct].z, o[i][ct][2]);
          o[i][ct][3] = fmaf(p, vv[ct].w, o[i][ct][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    float l = row_sum[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = qb + q0 + i;
    if (row >= s) continue;
    const float inv = 1.0f / l;
    T* orow = out + base + static_cast<size_t>(row) * c;
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = 4 * tk + 32 * ct + e;
        if (ch < c) orow[ch] = from_f32<T>(o[i][ct][e] * inv);
      }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int CP>
int launch_simt(const void* q, const void* k, const void* v, void* out, int b,
                int s, int c, cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes<CP>();
  cudaError_t err = bdm_allow_smem(attention_simt_kernel<T, CP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec16 = sizeof(T) == 4 && c % 4 == 0 && aligned16(q) &&
                    aligned16(k) && aligned16(v);
  const dim3 grid((s + SimtShape<CP>::BQ - 1) / SimtShape<CP>::BQ, b);
  attention_simt_kernel<T, CP>
      <<<grid, SimtShape<CP>::THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), s, c, vec16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* out, int b,
                int s, int c, cudaStream_t stream) {
  if (c <= 32) return launch_simt<T, 32>(q, k, v, out, b, s, c, stream);
  if (c <= 64) return launch_simt<T, 64>(q, k, v, out, b, s, c, stream);
  return launch_simt<T, 128>(q, k, v, out, b, s, c, stream);
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
