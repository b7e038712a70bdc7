// 3x3x3 SAME voxel convolution with bias, channel-last.
//
// Replaces the TPU kernels of bdm_tpu/ops/pallas/conv3d.py: `conv3d_pallas`,
// `conv3d_wg_pallas`, `_conv_ms_kernel` / `conv3d_ms_pallas` (narrow inputs,
// Cin <= 256) and `_conv_mm_kernel` / `conv3d_mm_pallas` (the 390-channel
// PC2 stage-0 input). Input (B, R, R, R, Cin) in float32 or bfloat16,
// weights rounded to the input type, float32 accumulation, bias added in
// float32, one rounding to the input type at the store.
//
// Bound on the H100: arithmetic. The stage-0 conv alone is
// 2 * B * R^3 * Cout * 27 * Cin = 22 GFLOP a cloud, far above the bytes it
// reads. Two kernels, chosen by the grid's type alone (`bdm_conv3d_path`,
// mirrored by `kernel_path` of ops/cuda/conv3d.py):
//
// `conv3d_tc_kernel`: bfloat16 grids, any Cin, Cout and R. An implicit GEMM
// on the tensor cores (`mma.sync.m16n8k16`, bf16 operands, float32
// accumulators): rows are output voxels, columns output channels, depth
// 27 taps x Cin. The weights come packed once by the wrapper as
// (27, Cin_p, Cout_p) bf16, Cin_p a multiple of 16 and Cout_p a multiple of
// the N tile, zeros in the padding, so a 16-deep step never straddles a tap.
// A block of eight warps owns a spatial tile of 4 x 8 x 8 output voxels of
// one cloud (256 rows; a warp 4 x 8 voxels of one z-plane, 32 rows, so each
// weight fragment it loads feeds two products) times an N tile of 32 or 64
// channels chosen from Cout, so a narrow Cout masks nothing away. Every
// block streams all the weights of its N tile from L2, which is what
// limited a 128-row tile: 256 rows halve that traffic. For each chunk of 16
// input channels the block stages the tile with its one-voxel halo
// (6 x 10 x 10 voxels) into shared memory, zero-filled outside the grid and
// beyond Cin, so every input element is read from L2 2.3 times instead of
// 27 and borders cost no branch in the inner loop. The 27 taps are 27
// shifted views of that tile: every lane hands `ldmatrix` its own row
// address, so a shift is one added constant. The weights of a chunk are
// walked nine taps (one z-plane of the 3 x 3 x 3) a step through a ring of
// `cp.async` copies, three stages deep at an N tile of 32 and two at 64
// (two blocks an SM either way); the halo tile of the next chunk lands in a
// second buffer meanwhile, a part a step; one barrier a step. Voxel rows of
// shared memory are 48 bytes apart and weight rows 16 bytes more than their
// width, so the eight rows of an `ldmatrix` fall into different banks. The
// halo is staged by 16-byte `cp.async` when Cin is a multiple of 8, by
// 4-byte `cp.async` when it is even (Cin 390: voxel rows are 780 bytes,
// 4-byte aligned only), and by plain 2-byte loads when it is odd (Cin 3).
// The epilogue adds the bias in float32, rounds once and hands the tile
// through shared memory to 16-byte stores.
//
// `conv3d_simt_kernel`: float32 grids (exact float32 products, which TF32
// would not give). float32 FMAs on the CUDA cores: a block of 256 threads
// computes a 64 x 64 output tile, 4 x 4 per thread (64 x 32 and 4 x 2 for
// Cout <= 32), and stages 64 x 16 slices of the implicit im2col matrix and
// 16 x 64 slices of the weights ((27 * Cin, Cout) float32) in shared
// memory; borders come from bounds checks while the input slice is staged.
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------- tensor cores

constexpr int kTZ = 4, kTY = 8, kTX = 8;     // output voxels a block
constexpr int kHY = kTY + 2, kHX = kTX + 2;  // the tile with its halo
constexpr int kHalo = (kTZ + 2) * kHY * kHX; // 600 voxels
constexpr int kCK = 16;                      // input channels a chunk
constexpr int kPitchA = kCK * 2 + 16;        // bytes a staged voxel
constexpr int kHaloBytes = kHalo * kPitchA;
constexpr int kHaloPieces = kHalo * (kCK / 8);   // 16-byte pieces
constexpr int kStepTaps = 9;                 // taps a ring step: one z plane
constexpr int kChunkSteps = 27 / kStepTaps;
constexpr int kTcThreads = 256;

// bytes of one ring stage: the weights of kStepTaps taps of a chunk
template <int NT>
constexpr int kStageBytesOf = kStepTaps * kCK * (NT * 2 + 16);

// ring stages: with an N tile of 64 two of them leave room for two blocks
// an SM
template <int NT>
constexpr int kStagesOf = NT <= 32 ? 3 : 2;

template <int NT>
__global__ void __launch_bounds__(kTcThreads, 2)
    conv3d_tc_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ wp,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int r, int cin,
                     int cin_p, int cout, int cout_p) {
  constexpr int STAGES = kStagesOf<NT>;
  constexpr int kPitchB = NT * 2 + 16;       // bytes a staged weight row
  constexpr int kStageBytes = kStageBytesOf<NT>;
  constexpr int kNTiles = NT / 8;
  // the next chunk's halo tile is fetched in parts, one a step, early
  // enough for the last part to have landed when the chunk begins
  constexpr int kHaloParts = kChunkSteps - STAGES + 2;
  constexpr int kPartPieces = (kHaloPieces + kHaloParts - 1) / kHaloParts;
  extern __shared__ __align__(16) unsigned char smem[];
  static_assert(kTcThreads * (NT * 2 + 16) <= 2 * kHaloBytes,
                "the output tile is staged where the halo was");
  unsigned char* halo_s = smem;                    // [2][kHalo][kPitchA]
  unsigned char* w_s = smem + 2 * kHaloBytes;      // [STAGES][9*16][kPitchB]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wz = warp >> 1, wy = (warp & 1) * 4;   // the warp's 4 x 8 rows
  const int ntx = (r + kTX - 1) / kTX;
  const int nty = (r + kTY - 1) / kTY;
  const int ntz = (r + kTZ - 1) / kTZ;
  int tile = blockIdx.x;
  const int x0 = (tile % ntx) * kTX;
  tile /= ntx;
  const int y0 = (tile % nty) * kTY;
  tile /= nty;
  const int z0 = (tile % ntz) * kTZ;
  const int b = tile / ntz;
  const int n0 = blockIdx.y * NT;
  // how the halo is staged: by the alignment of a voxel's channel row
  const int vec = cin % 8 == 0 ? 16 : (cin % 2 == 0 ? 4 : 2);

  auto load_halo = [&](int buf, int chunk, int lo, int hi) {
    unsigned char* dst_buf = halo_s + buf * kHaloBytes;
    for (int p = lo + tid; p < hi; p += kTcThreads) {
      const int hv = p / (kCK / 8), piece = p % (kCK / 8);
      const int ch = chunk * kCK + piece * 8;
      const int hz = hv / (kHY * kHX);
      const int rem = hv - hz * (kHY * kHX);
      const int hy = rem / kHX;
      const int hx = rem - hy * kHX;
      const int gz = z0 + hz - 1, gy = y0 + hy - 1, gx = x0 + hx - 1;
      const bool inside =
          gz >= 0 && gz < r && gy >= 0 && gy < r && gx >= 0 && gx < r;
      const int nvalid = inside ? max(0, min(8, cin - ch)) : 0;
      const __nv_bfloat16* src = x;
      if (nvalid > 0)
        src = x + (((static_cast<size_t>(b) * r + gz) * r + gy) * r + gx) *
                      cin + ch;
      unsigned char* dst = dst_buf + hv * kPitchA + piece * 16;
      if (vec == 16) {
        cp_async16(smem_u32(dst), src, nvalid * 2);
      } else if (vec == 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = 2 * j < nvalid;   // nvalid is even here
          cp_async4(smem_u32(dst) + 4 * j, ok ? src + 2 * j : x, ok ? 4 : 0);
        }
      } else {
        __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          d[j] = j < nvalid ? src[j] : __float2bfloat16_rn(0.0f);
      }
    }
  };

  // the weights of one ring step: taps 9j .. 9j+8 (the plane kd = j) of a
  // chunk
  auto load_weights = [&](int stage, int chunk, int j) {
    const uint32_t dst_stage = smem_u32(w_s) + stage * kStageBytes;
    for (int p = tid; p < kStepTaps * kCK * kNTiles; p += kTcThreads) {
      const int piece = p % kNTiles;
      const int row = p / kNTiles;          // tap * kCK + channel
      const __nv_bfloat16* src =
          wp + (static_cast<size_t>(kStepTaps * j + row / kCK) * cin_p +
                chunk * kCK + row % kCK) * cout_p + n0 + piece * 8;
      cp_async16(dst_stage + row * kPitchB + piece * 16, src, 16);
    }
  };

  const int nchunks = cin_p / kCK;
  const int nsteps = nchunks * kChunkSteps;

  // prologue: the first halo tile and the first STAGES - 1 steps
  load_halo(0, 0, 0, kHaloPieces);
  load_weights(0, 0, 0);
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < STAGES - 1; ++st) {
    load_weights(st, st / kChunkSteps, st % kChunkSteps);
    cp_async_commit();
  }

  float acc[2][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  // ldmatrix row addresses of this lane. A: row i of 16-row tile mt is the
  // output voxel (z = wz, y = wy + 2 mt + i / 8, x = i % 8), read at its
  // tap's shift inside the halo tile. B: weight rows are the depth
  // (transposed).
  uint32_t a_lane[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    a_lane[mt] = smem_u32(halo_s) +
                 ((wz * kHY + wy + 2 * mt + ((lane >> 3) & 1)) * kHX +
                  (lane & 7)) * kPitchA + (lane >> 4) * 16;
  const uint32_t b_lane = smem_u32(w_s) +
                          ((lane & 7) + ((lane >> 3) & 1) * 8) * kPitchB +
                          (lane >> 4) * 16;

  int it = 0, j = 0;                        // chunk and plane computed
  int pf_it = (STAGES - 1) / kChunkSteps;   // ... and fetched
  int pf_j = (STAGES - 1) % kChunkSteps;
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();    // this step's group has landed
    __syncthreads();                // ... for every thread; step - 1 is done
    if (step + STAGES - 1 < nsteps)
      load_weights((step + STAGES - 1) % STAGES, pf_it, pf_j);
    if (j < kHaloParts && it + 1 < nchunks)
      load_halo((it + 1) & 1, it + 1, j * kPartPieces,
                min((j + 1) * kPartPieces, kHaloPieces));
    cp_async_commit();
    if (++pf_j == kChunkSteps) {
      pf_j = 0;
      ++pf_it;
    }

    const uint32_t a_st = (it & 1) * kHaloBytes + j * kHY * kHX * kPitchA;
    const uint32_t b_st = b_lane + (step % STAGES) * kStageBytes;
    // tap (kd, kh, kw) = (j, tp / 3, tp % 3)
#pragma unroll
    for (int tp = 0; tp < kStepTaps; ++tp) {
      const uint32_t a_off = a_st + ((tp / 3) * kHX + tp % 3) * kPitchA;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(a[mt], a_lane[mt] + a_off);
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, b_st + tp * kCK * kPitchB + np * 32);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], bf[2], bf[3]);
        }
      }
    }
    if (++j == kChunkSteps) {
      j = 0;
      ++it;
    }
  }

  // bias in float32 and one rounding; the tile goes through shared memory
  // (the halo buffers are free now), each warp its own 32 rows, so that it
  // leaves in 16-byte stores
  __syncthreads();
  constexpr int kPitchO = NT * 2 + 16;
  unsigned char* o_s = smem + warp * 32 * kPitchO;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const int col = nt * 8 + 2 * t;   // bias is padded to Cout_p
        *reinterpret_cast<__nv_bfloat162*>(
            o_s + (mt * 16 + h * 8 + g) * kPitchO + col * 2) =
            __floats2bfloat162_rn(acc[mt][nt][2 * h] + bias[n0 + col],
                                  acc[mt][nt][2 * h + 1] + bias[n0 + col + 1]);
      }
  __syncwarp();
  const bool whole = cout % 8 == 0;   // rows of the output 16-byte aligned
  const int gz = z0 + wz;
  for (int p = lane; p < 32 * kNTiles; p += 32) {
    const int row = p / kNTiles, piece = p % kNTiles;
    const int gy = y0 + wy + row / 8, gx = x0 + row % 8;
    const int col = n0 + piece * 8;
    if (gz >= r || gy >= r || gx >= r || col >= cout) continue;
    const unsigned char* from = o_s + row * kPitchO + piece * 16;
    __nv_bfloat16* to =
        out + (((static_cast<size_t>(b) * r + gz) * r + gy) * r + gx) * cout +
        col;
    if (whole) {
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    } else {
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(from);
      for (int e = 0; e < 8 && col + e < cout; ++e) to[e] = v[e];
    }
  }
}

template <int NT>
int launch_tc(const void* x, const void* wp, const float* bias, void* out,
              int b, int r, int cin, int cout, cudaStream_t stream) {
  const int cin_p = (cin + kCK - 1) / kCK * kCK;
  const int cout_p = (cout + NT - 1) / NT * NT;
  const size_t smem = 2 * kHaloBytes + kStagesOf<NT> * kStageBytesOf<NT>;
  cudaError_t err = bdm_allow_smem(conv3d_tc_kernel<NT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((r + kTX - 1) / kTX) * ((r + kTY - 1) / kTY) *
                    ((r + kTZ - 1) / kTZ);
  const dim3 grid(static_cast<unsigned>(b) * tiles, cout_p / NT);
  conv3d_tc_kernel<NT><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), bias,
      static_cast<__nv_bfloat16*>(out), r, cin, cin_p, cout, cout_p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ CUDA cores

constexpr int kBM = 64;
constexpr int kBK = 16;
constexpr int kConvThreads = 256;

// BN: output channels a block (64, or 32 for a narrow Cout, where a
// 64-wide tile would mask half of its FMAs away)
template <int BN>
__global__ void __launch_bounds__(kConvThreads)
    conv3d_simt_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int b, int r, int cin, int cout) {
  constexpr int TN = BN / 16;   // output channels a thread
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][BN + 4];
  const int r3 = r * r * r;
  const long long mtot = static_cast<long long>(b) * r3;
  const int k_total = 27 * cin;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;
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

  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

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
        v = x[off];
      }
      As[a_k][tid / kBK + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < kBK * BN / kConvThreads; ++i) {
      const int e = tid + kConvThreads * i;
      const int bk = e / BN;
      const int bn = e % BN;
      const int kk = k0 + bk;
      const int nn = n0 + bn;
      Bs[bk][bn] = (kk < k_total && nn < cout)
                       ? w[static_cast<size_t>(kk) * cout + nn]
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bb[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bb[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= mtot) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int nn = n0 + tx * TN + j;
      if (nn < cout) out[m * cout + nn] = acc[i][j] + bias[nn];
    }
  }
}

template <int BN>
int launch_simt(const void* x, const void* w, const float* bias, void* out,
                int b, int r, int cin, int cout, cudaStream_t stream) {
  const long long mtot = static_cast<long long>(b) * r * r * r;
  const dim3 grid(static_cast<unsigned>((mtot + kBM - 1) / kBM),
                  (cout + BN - 1) / BN);
  conv3d_simt_kernel<BN><<<grid, kConvThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias,
      static_cast<float*>(out), b, r, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Which kernel a call takes: 1 the tensor-core kernel, 0 the CUDA-core one.
// A rule on the grid's type alone.
BDM_EXPORT int bdm_conv3d_path(int dtype, int cin, int cout, int r) {
  (void)cin;
  (void)cout;
  (void)r;
  return dtype == BDM_BF16 ? 1 : 0;
}

// The N tile of the tensor-core kernel, chosen from Cout; the packed
// weights and bias are padded to a multiple of it.
BDM_EXPORT int bdm_conv3d_n_tile(int cout) {
  return cout <= 32 ? 32 : 64;
}

// `w` and `bias` as the wrapper packs them for the path the call takes:
// (27, Cin_p, Cout_p) bf16 and (Cout_p,) float32 for the tensor-core
// kernel, (27 * Cin, Cout) float32 and (Cout,) float32 for the other.
BDM_EXPORT int bdm_conv3d(const void* x, const void* w, const float* bias,
                          void* out, int b, int r, int cin, int cout,
                          int dtype, cudaStream_t stream) {
  if (b < 1 || r < 1 || cin < 1 || cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == BDM_BF16) {
    // x as the halo is staged (16-, 4- or 2-byte copies by Cin), the
    // packed weights for 16-byte copies, out for 16-byte stores when its
    // rows allow them
    const uintptr_t x_align = cin % 8 == 0 ? 16 : (cin % 2 == 0 ? 4 : 2);
    const uintptr_t out_align = cout % 8 == 0 ? 16 : 2;
    if (reinterpret_cast<uintptr_t>(x) % x_align != 0 ||
        reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % out_align != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (bdm_conv3d_n_tile(cout) == 32)
      return launch_tc<32>(x, w, bias, out, b, r, cin, cout, stream);
    return launch_tc<64>(x, w, bias, out, b, r, cin, cout, stream);
  }
  if (dtype == BDM_F32)
    return cout <= 32
               ? launch_simt<32>(x, w, bias, out, b, r, cin, cout, stream)
               : launch_simt<64>(x, w, bias, out, b, r, cin, cout, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
