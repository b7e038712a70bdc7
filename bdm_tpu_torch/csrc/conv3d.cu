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
// `conv3d_simt_halo_kernel` and `conv3d_simt_kernel`: float32 grids (exact
// float32 products, which TF32 would not give). FFMA on the CUDA cores,
// bound by the 67 TFLOP/s of float32 FMA issue; both are implicit GEMMs
// (M = B R^3 voxels, N = Cout, K = 27 taps x Cin) on one packed weight
// layout ((Kp, Cout_p) float32, rows (tap, channel), the channels of a tap
// padded to a multiple of 4), with register tiles of 8 voxels x 8 channels
// a thread (8 x 4 at Cout <= 32) read from shared memory as float4, so 12
// or 16 shared loads feed 128 or 256 FMAs, and the bias added in float32
// in the epilogue. What limited the im2col form on the card (every input
// row read from L2 27 times, loads that did not hide under the products at
// 64 -> 64 R 32) decides between them, by shape alone:
//  * halo tiles where R is a multiple of 8 and the grid fills the card: a
//    block owns a TZ x 8 x 8 tile of output voxels (TZ 4 and 256 threads at
//    Cout > 32, TZ 2 and 128 threads below) and, for each 4-channel chunk,
//    stages the tile with its halo and the chunk's weights of all 27 taps;
//    the taps are shifted views of the halo (every input element read 2.3
//    or 3.1 times, not 27); two chunks in flight, one barrier a chunk;
//  * im2col tiles elsewhere (R 9, small grids): 128 voxels x an N tile, K
//    tap-outer and channel-inner in 16-deep slices through a three-stage
//    `cp.async` ring, one barrier a slice, a row's neighbour offset
//    computed once a tap; where the grid would leave SMs idle, K is split
//    over a cluster of up to 8 blocks, whose partial tiles block 0 adds in
//    rank order through distributed shared memory (deterministic).
// Input copies are 16 bytes when Cin % 4 == 0, 8 when it is even (390), 4
// otherwise (3); borders and channel padding are zero-filled by the
// copies' source size 0.
#include "common.cuh"
#include "mma.cuh"

#include <cooperative_groups.h>

namespace {

// The N tile the packed weights and bias are padded to (`bdm_conv3d_n_tile`).
int bdm_conv3d_n_tile_of(int cout) { return cout <= 32 ? 32 : 64; }

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

constexpr int kSimtBK = 16;               // depth a ring stage: 4 pieces
constexpr int kSimtPitchA = kSimtBK + 4;  // floats a staged voxel row
constexpr int kSimtStages = 3;

// A block of THREADS threads computes BM voxels x BN channels; a thread
// TM voxels x TN channels, with LN lanes across the N tile and RG row groups.
template <int BM_, int BN_, int TN_, int THREADS_, int MIN_BLOCKS_>
struct SimtTile {
  static constexpr int BM = BM_, BN = BN_, TN = TN_, THREADS = THREADS_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int LN = BN / TN;
  static constexpr int RG = THREADS / LN;
  static constexpr int TM = BM / RG;
  static constexpr int SR = BM / THREADS;   // voxel rows a thread stages
  static constexpr int STAGE_FLOATS = BM * kSimtPitchA + kSimtBK * BN;
  static_assert(TM * RG == BM && SR * THREADS == BM && TN % 4 == 0, "tile");
};

// 8 x 8 a thread (8 x 4 at an N tile of 32): a 4-deep step takes 8 + 4 NG
// float4 loads from shared memory for 128 NG FMAs
using TileNarrow64 = SimtTile<128, 64, 8, 128, 3>;
using TileNarrow32 = SimtTile<128, 32, 4, 128, 3>;

// The K axis is (tap, channel) with the channels of a tap padded to Cin4, a
// multiple of 4, and the whole to Kp, a multiple of 16: a 4-channel piece
// never straddles a tap. The weights come packed as (Kp, Cout_p) float32,
// zeros in the padding, Cout_p a multiple of BN (`bdm_conv3d_n_tile`).
template <typename Tile>
__global__ void __launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
    conv3d_simt_kernel(const float* __restrict__ x,
                       const float* __restrict__ wp,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int b, int r, int cin, int cin4, int kp, int cout,
                       int cout_p, int vec, int vec_out, int splits) {
  constexpr int BM = Tile::BM, BN = Tile::BN, THREADS = Tile::THREADS;
  constexpr int LN = Tile::LN, RG = Tile::RG, TM = Tile::TM, SR = Tile::SR;
  constexpr int NG = Tile::TN / 4;   // float4 column groups, 4 LN apart
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int tn = tid % LN;   // columns 4 tn + 4 LN g
  // voxels rg + RG i: the row groups of a quarter warp read consecutive
  // rows, 20 floats apart, in distinct banks
  const int rg = tid / LN;
  const int r3 = r * r * r;
  const long long mtot = static_cast<long long>(b) * r3;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // the voxels whose im2col rows this thread stages: rows tid + THREADS u
  long long mv[SR];
  int vz[SR], vy[SR], vx[SR];
  bool row_ok[SR];
#pragma unroll
  for (int u = 0; u < SR; ++u) {
    mv[u] = m0 + tid + THREADS * u;
    row_ok[u] = mv[u] < mtot;
    const int p = row_ok[u] ? static_cast<int>(mv[u] % r3) : 0;
    vz[u] = p / (r * r);
    vy[u] = (p / r) % r;
    vx[u] = p % r;
  }
  const int npt = cin4 / 4;       // pieces a tap
  // split-K: the blocks of a cluster along z share the tile, each a range
  // of the K slices
  const int split = blockIdx.z;
  const int kt0 = kp / kSimtBK * split / splits;
  const int nk = kp / kSimtBK * (split + 1) / splits - kt0;
  // the neighbours of the tap last staged: their offsets are computed once
  // a tap
  int cur_tap = -1;
  bool cur_ok[SR];
  long long cur_off[SR];

  auto load_stage = [&](int slot, int kt) {
    float* a_s = sm + slot * Tile::STAGE_FLOATS;
    float* b_s = a_s + BM * kSimtPitchA;
#pragma unroll
    for (int w = 0; w < kSimtBK / 4; ++w) {
      const int piece = kSimtBK / 4 * kt + w;
      const int tap = piece / npt;
      const int c0 = (piece - tap * npt) * 4;
      if (tap != cur_tap) {
        cur_tap = tap;
        const int dz = tap / 9 - 1, dy = tap / 3 % 3 - 1, dx = tap % 3 - 1;
#pragma unroll
        for (int u = 0; u < SR; ++u) {
          const int zz = vz[u] + dz, yy = vy[u] + dy, xx = vx[u] + dx;
          cur_ok[u] = row_ok[u] && tap < 27 && zz >= 0 && zz < r &&
                      yy >= 0 && yy < r && xx >= 0 && xx < r;
          cur_off[u] = (mv[u] + (dz * r + dy) * r + dx) * cin;
        }
      }
#pragma unroll
      for (int u = 0; u < SR; ++u) {
        const uint32_t dst =
            smem_u32(a_s + (tid + THREADS * u) * kSimtPitchA + 4 * w);
        const float* src = x + cur_off[u] + c0;
        if (vec == 16) {   // Cin % 4 == 0: a piece is whole or off the grid
          cp_async16(dst, cur_ok[u] ? src : x, cur_ok[u] ? 16 : 0);
        } else if (vec == 8) {   // Cin even (390): two 8-byte copies
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const bool ok = cur_ok[u] && c0 + e < cin;
            cp_async8(dst + 4 * e, ok ? src + e : x, ok ? 8 : 0);
          }
        } else {           // Cin odd (3): four 4-byte copies, zeros past Cin
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = cur_ok[u] && c0 + e < cin;
            cp_async4(dst + 4 * e, ok ? src + e : x, ok ? 4 : 0);
          }
        }
      }
    }
    // rows kt * 16 .. + 15 of the packed weights, columns n0 .. n0 + BN
    for (int p = tid; p < kSimtBK * BN / 4; p += THREADS) {
      const int row = p / (BN / 4), piece = p % (BN / 4);
      cp_async16(smem_u32(b_s + row * BN + piece * 4),
                 wp + static_cast<size_t>(kt * kSimtBK + row) * cout_p + n0 +
                     piece * 4,
                 16);
    }
  };

#pragma unroll
  for (int st = 0; st < kSimtStages - 1; ++st) {
    if (st < nk) load_stage(st, kt0 + st);
    cp_async_commit();
  }

  float acc[TM][4 * NG];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kSimtStages - 2>();   // stage kt has landed ...
    __syncthreads();                    // ... for all; stage kt - 1 is done
    if (kt + kSimtStages - 1 < nk)
      load_stage((kt + kSimtStages - 1) % kSimtStages,
                 kt0 + kt + kSimtStages - 1);
    cp_async_commit();
    const float* a_s =
        sm + (kt % kSimtStages) * Tile::STAGE_FLOATS + rg * kSimtPitchA;
    const float* b_s = sm + (kt % kSimtStages) * Tile::STAGE_FLOATS +
                       BM * kSimtPitchA + 4 * tn;
    // a 4-deep step: TM float4 loads of A and 4 NG of B feed 16 TM NG FMAs
#pragma unroll
    for (int k4 = 0; k4 < kSimtBK / 4; ++k4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            a_s + RG * i * kSimtPitchA + 4 * k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 bv[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          bv[g] = *reinterpret_cast<const float4*>(
              b_s + (4 * k4 + kk) * BN + 4 * LN * g);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = kk == 0   ? a[i].x
                           : kk == 1 ? a[i].y
                           : kk == 2 ? a[i].z
                                     : a[i].w;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            acc[i][4 * g] = fmaf(av, bv[g].x, acc[i][4 * g]);
            acc[i][4 * g + 1] = fmaf(av, bv[g].y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(av, bv[g].z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(av, bv[g].w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

  if (splits > 1) {
    // the partial tiles through distributed shared memory: every block
    // parks its sums in its own shared memory, the cluster's block 0 adds
    // those of blocks 1, 2, ... in that order (deterministic) and stores
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cp_async_wait<0>();
    __syncthreads();   // the ring is free
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NG; ++j)
        sm[(i * 4 * NG + j) * THREADS + tid] = acc[i][j];
    cluster.sync();
    if (split == 0) {
      for (int sp = 1; sp < splits; ++sp) {
        const float* part = cluster.map_shared_rank(sm, sp);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4 * NG; ++j)
            acc[i][j] += part[(i * 4 * NG + j) * THREADS + tid];
      }
    }
    cluster.sync();    // block 0 has read every block's shared memory
    if (split != 0) return;
  }

  // bias in float32 (padded to Cout_p)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + rg + RG * i;
    if (m >= mtot) continue;
    float* orow = out + m * cout;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = n0 + 4 * tn + 4 * LN * g;
      if (col >= cout) continue;
      const float4 bb = *reinterpret_cast<const float4*>(bias + col);
      const float4 y =
          make_float4(acc[i][4 * g] + bb.x, acc[i][4 * g + 1] + bb.y,
                      acc[i][4 * g + 2] + bb.z, acc[i][4 * g + 3] + bb.w);
      if (vec_out) {   // Cout % 4 == 0: col + 3 < Cout
        *reinterpret_cast<float4*>(orow + col) = y;
      } else {
        const float v4[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < cout) orow[col + e] = v4[e];
      }
    }
  }
}

// R % 8 == 0 (every grid of the models: R 32, 16, 8): a block owns a
// TZ x 8 x 8 tile of output voxels and, chunk by chunk of 4 input channels,
// stages the tile with its one-voxel halo ((TZ + 2) x 10 x 10 voxels) and
// the weights of those channels for all 27 taps; the taps are 27 shifted
// views of the halo tile, so every input element comes from L2
// (TZ + 2) 100 / (64 TZ) times (3.1 at TZ 2), not 27. Two chunks in flight
// (double buffer), one barrier a chunk. A thread computes TM voxels x TN
// channels, with LN = BN / TN lanes across the N tile.
constexpr int kHaloTY = 8, kHaloTX = 8;
constexpr int kHaloY = kHaloTY + 2, kHaloX = kHaloTX + 2;

template <int TZ_, int BN_, int TN_, int THREADS_, int MIN_BLOCKS_>
struct HaloTile {
  static constexpr int TZ = TZ_, BN = BN_, TN = TN_, THREADS = THREADS_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int BM = TZ * kHaloTY * kHaloTX;
  static constexpr int LN = BN / TN;
  static constexpr int RG = THREADS / LN;
  static constexpr int TM = BM / RG;
  static constexpr int VOX = (TZ + 2) * kHaloY * kHaloX;
  static constexpr int STAGE_FLOATS = VOX * 4 + 27 * 4 * BN;
  static_assert(TM * RG == BM && RG % 8 == 0 && TN % 4 == 0, "tile");
};

template <typename Tile>
__global__ void __launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
    conv3d_simt_halo_kernel(const float* __restrict__ x,
                            const float* __restrict__ wp,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int r, int cin, int cin4,
                            int cout, int cout_p, int vec, int vec_out) {
  constexpr int TZ = Tile::TZ, BN = Tile::BN, THREADS = Tile::THREADS;
  constexpr int LN = Tile::LN, RG = Tile::RG, TM = Tile::TM;
  constexpr int VOX = Tile::VOX, STAGE = Tile::STAGE_FLOATS;
  constexpr int NG = Tile::TN / 4;   // float4 column groups, 4 LN apart
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int tn = tid % LN;   // columns 4 tn + 4 LN g
  // voxels rg + RG i of the tile, row-major (z, y, x); the lanes of a
  // quarter warp share a voxel or read neighbouring ones
  const int rg = tid / LN;
  const int ntx = r / kHaloTX, nty = r / kHaloTY, ntz = r / TZ;
  int tile = blockIdx.x;
  const int x0 = (tile % ntx) * kHaloTX;
  tile /= ntx;
  const int y0 = (tile % nty) * kHaloTY;
  tile /= nty;
  const int z0 = (tile % ntz) * TZ;
  const int b = tile / ntz;
  const int n0 = blockIdx.y * BN;
  const int nchunks = cin4 / 4;

  auto load_chunk = [&](int slot, int c4) {
    float* h_s = sm + slot * STAGE;
    float* w_s = h_s + VOX * 4;
    const int c0 = 4 * c4;
    for (int hv = tid; hv < VOX; hv += THREADS) {
      const int hz = hv / (kHaloY * kHaloX);
      const int rem = hv - hz * (kHaloY * kHaloX);
      const int hy = rem / kHaloX, hx = rem - hy * kHaloX;
      const int gz = z0 + hz - 1, gy = y0 + hy - 1, gx = x0 + hx - 1;
      const bool inside =
          gz >= 0 && gz < r && gy >= 0 && gy < r && gx >= 0 && gx < r;
      const float* src =
          x + (((static_cast<size_t>(b) * r + (inside ? gz : 0)) * r +
                (inside ? gy : 0)) * r + (inside ? gx : 0)) * cin + c0;
      const uint32_t dst = smem_u32(h_s + hv * 4);
      if (vec == 16) {   // Cin % 4 == 0: a piece is whole or off the grid
        cp_async16(dst, inside ? src : x, inside ? 16 : 0);
      } else if (vec == 8) {   // Cin even (390): two 8-byte copies
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const bool ok = inside && c0 + e < cin;
          cp_async8(dst + 4 * e, ok ? src + e : x, ok ? 8 : 0);
        }
      } else {           // Cin odd (3): four 4-byte copies, zeros past Cin
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = inside && c0 + e < cin;
          cp_async4(dst + 4 * e, ok ? src + e : x, ok ? 4 : 0);
        }
      }
    }
    // the weights of these 4 channels for the 27 taps: rows tap * Cin4 +
    // c0 + e of the packed matrix, staged tap-major
    for (int p = tid; p < 27 * 4 * BN / 4; p += THREADS) {
      const int row = p / (BN / 4), piece = p % (BN / 4);
      const int tap = row >> 2, e = row & 3;
      cp_async16(smem_u32(w_s + row * BN + piece * 4),
                 wp + static_cast<size_t>(tap * cin4 + c0 + e) * cout_p +
                     n0 + piece * 4,
                 16);
    }
  };

  load_chunk(0, 0);
  cp_async_commit();

  float acc[TM][4 * NG];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.0f;
  // the halo row of each of the thread's voxels at tap (0, 0, 0)
  int hrow[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int v = rg + RG * i;
    hrow[i] = ((v >> 6) * kHaloY + ((v >> 3) & 7)) * kHaloX + (v & 7);
  }

  for (int c4 = 0; c4 < nchunks; ++c4) {
    cp_async_wait<0>();   // chunk c4 has landed for this thread ...
    __syncthreads();      // ... and for all; chunk c4 - 1 is done
    if (c4 + 1 < nchunks) load_chunk((c4 + 1) & 1, c4 + 1);
    cp_async_commit();
    const float* h_s = sm + (c4 & 1) * STAGE;
    const float* w_s = sm + (c4 & 1) * STAGE + VOX * 4 + 4 * tn;
#pragma unroll 1
    for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
      for (int t9 = 0; t9 < 9; ++t9) {
        const int off = (dz * kHaloY + t9 / 3) * kHaloX + t9 % 3;
        const float* ws = w_s + (dz * 9 + t9) * 4 * BN;
        // TM float4 loads of A and 4 NG of B feed 16 TM NG FMAs
        float4 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = *reinterpret_cast<const float4*>(h_s + (hrow[i] + off) * 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4 bv[NG];
#pragma unroll
          for (int g = 0; g < NG; ++g)
            bv[g] = *reinterpret_cast<const float4*>(ws + kk * BN +
                                                     4 * LN * g);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float av = kk == 0   ? a[i].x
                             : kk == 1 ? a[i].y
                             : kk == 2 ? a[i].z
                                       : a[i].w;
#pragma unroll
            for (int g = 0; g < NG; ++g) {
              acc[i][4 * g] = fmaf(av, bv[g].x, acc[i][4 * g]);
              acc[i][4 * g + 1] = fmaf(av, bv[g].y, acc[i][4 * g + 1]);
              acc[i][4 * g + 2] = fmaf(av, bv[g].z, acc[i][4 * g + 2]);
              acc[i][4 * g + 3] = fmaf(av, bv[g].w, acc[i][4 * g + 3]);
            }
          }
        }
      }
    }
  }

  // bias in float32 (padded to Cout_p)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int v = rg + RG * i;
    const int z = z0 + (v >> 6), y = y0 + ((v >> 3) & 7), xx = x0 + (v & 7);
    float* orow =
        out + (((static_cast<size_t>(b) * r + z) * r + y) * r + xx) * cout;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = n0 + 4 * tn + 4 * LN * g;
      if (col >= cout) continue;
      const float4 bb = *reinterpret_cast<const float4*>(bias + col);
      const float4 yv =
          make_float4(acc[i][4 * g] + bb.x, acc[i][4 * g + 1] + bb.y,
                      acc[i][4 * g + 2] + bb.z, acc[i][4 * g + 3] + bb.w);
      if (vec_out) {   // Cout % 4 == 0: col + 3 < Cout
        *reinterpret_cast<float4*>(orow + col) = yv;
      } else {
        const float v4[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < cout) orow[col + e] = v4[e];
      }
    }
  }
}

// 8 x 8 and 8 x 4 a thread; at Cout > 32, 4 x 8 x 8 tiles of 256 threads
// (half the weight traffic a voxel) were faster on the card than 2 x 8 x 8
// tiles of 128, which were faster at Cout <= 32
using HaloTile64 = HaloTile<4, 64, 8, 256, 1>;
using HaloTile32 = HaloTile<2, 32, 4, 128, 3>;

int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return count;
}

template <typename Tile>
int launch_simt(const void* x, const void* w, const float* bias, void* out,
                int b, int r, int cin, int cout, int cout_p,
                cudaStream_t stream) {
  const int cin4 = (cin + 3) / 4 * 4;
  const int kp = (27 * cin4 + kSimtBK - 1) / kSimtBK * kSimtBK;
  const size_t smem = sizeof(float) * kSimtStages * Tile::STAGE_FLOATS;
  cudaError_t err = bdm_allow_smem(conv3d_simt_kernel<Tile>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the widest copy every piece of every voxel row allows
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int vec = cin % 4 == 0 && xa % 16 == 0  ? 16
                  : cin % 2 == 0 && xa % 8 == 0 ? 8
                                                : 4;
  const int vec_out =
      cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long mtot = static_cast<long long>(b) * r * r * r;
  const long long blocks =
      (mtot + Tile::BM - 1) / Tile::BM * (cout_p / Tile::BN);
  // split K where the tiles give fewer than three quarters of the SMs a
  // block: up to a cluster of 8, two blocks an SM in all, at least four K
  // slices a block (a grid of about one block an SM ran faster unsplit)
  int splits = 1;
  if (blocks < 3LL * sm_count() / 4)
    while (splits < 8 && blocks * splits < 2LL * sm_count() &&
           kp / kSimtBK >= 4 * (splits + 1))
      ++splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks / (cout_p / Tile::BN)),
                     cout_p / Tile::BN, splits);
  cfg.blockDim = dim3(Tile::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, conv3d_simt_kernel<Tile>,
                           static_cast<const float*>(x),
                           static_cast<const float*>(w), bias,
                           static_cast<float*>(out), b, r, cin, cin4, kp,
                           cout, cout_p, vec, vec_out, splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tile>
int halo_tiles(int r) {
  return (r / kHaloTX) * (r / kHaloTY) * (r / Tile::TZ);
}

template <typename Tile>
int launch_halo(const void* x, const void* w, const float* bias, void* out,
                int b, int r, int cin, int cout, int cout_p,
                cudaStream_t stream) {
  const int cin4 = (cin + 3) / 4 * 4;
  const size_t smem = sizeof(float) * 2 * Tile::STAGE_FLOATS;
  cudaError_t err = bdm_allow_smem(conv3d_simt_halo_kernel<Tile>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int vec = cin % 4 == 0 && xa % 16 == 0  ? 16
                  : cin % 2 == 0 && xa % 8 == 0 ? 8
                                                : 4;
  const int vec_out =
      cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(b) * halo_tiles<Tile>(r),
                  cout_p / Tile::BN);
  conv3d_simt_halo_kernel<Tile><<<grid, Tile::THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias,
      static_cast<float*>(out), r, cin, cin4, cout, cout_p, vec, vec_out);
  return static_cast<int>(cudaGetLastError());
}


// Which tiles a float32 conv takes, by shape (the packed weights serve
// all: Cout_p is a multiple of 64 or of 32 by `bdm_conv3d_n_tile`): halo
// tiles where R is a multiple of their 4 x 8 x 8 (2 x 8 x 8) face and the
// grid gives three quarters of the SMs a block, else im2col tiles (K split
// over a cluster where they would leave SMs idle).
int launch_simt_f32(const void* x, const void* w, const float* bias,
                    void* out, int b, int r, int cin, int cout,
                    cudaStream_t stream) {
  const int nt = bdm_conv3d_n_tile_of(cout);
  const int cout_p = (cout + nt - 1) / nt * nt;
  const long long enough = 3LL * sm_count() / 4;
  if (nt == 64) {
    if (r % kHaloTY == 0 && r % HaloTile64::TZ == 0 &&
        static_cast<long long>(b) * halo_tiles<HaloTile64>(r) * (cout_p / 64) >=
            enough)
      return launch_halo<HaloTile64>(x, w, bias, out, b, r, cin, cout,
                                     cout_p, stream);
    return launch_simt<TileNarrow64>(x, w, bias, out, b, r, cin, cout,
                                     cout_p, stream);
  }
  if (r % kHaloTY == 0 && r % HaloTile32::TZ == 0 &&
      static_cast<long long>(b) * halo_tiles<HaloTile32>(r) >= enough)
    return launch_halo<HaloTile32>(x, w, bias, out, b, r, cin, cout, cout_p,
                                   stream);
  return launch_simt<TileNarrow32>(x, w, bias, out, b, r, cin, cout, cout_p,
                                   stream);
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

// The N tile of both kernels, chosen from Cout; the packed weights and
// bias are padded to a multiple of it.
BDM_EXPORT int bdm_conv3d_n_tile(int cout) {
  return bdm_conv3d_n_tile_of(cout);
}

// `w` and `bias` as the wrapper packs them for the path the call takes:
// (27, Cin_p, Cout_p) bf16 and (Cout_p,) float32 for the tensor-core
// kernel, (Kp, Cout_p) float32 (rows (tap, channel), the channels of a tap
// padded to a multiple of 4, Kp to one of 16) and (Cout_p,) float32 for
// the other; both 16-byte aligned.
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
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bias) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (dtype == BDM_F32)
    return launch_simt_f32(x, w, bias, out, b, r, cin, cout, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
