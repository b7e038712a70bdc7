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
// reads. Two kinds of kernel, chosen by the grid's type alone
// (`bdm_conv3d_path`, mirrored by `kernel_path` of ops/cuda/conv3d.py):
//
// `conv3d_wgmma_kernel`: bfloat16 grids, any Cin, Cout and R; it replaces
// `conv3d_ms_pallas` and `conv3d_mm_pallas` (and served `conv3d_pallas` /
// `conv3d_wg_pallas` contracts at bf16). An implicit GEMM on Hopper's
// warpgroup tensor cores (`wgmma.mma_async` m64nNk16, bf16 operands both
// read from shared memory through matrix descriptors, float32 accumulators
// in registers): rows are output voxels, columns output channels, depth
// 27 taps x Cin. What bounds it on this card: the operations where N is
// wide; at Cout 32 the shared-memory reads of A (a 64 x 16 tile, 2 KB, for
// 64 x 32 x 16 products) pace the tensor cores at about two thirds of their
// rate. What the design does about it:
//  * Tiles by shape, never by a knob: an N tile of 32, 64 or 128 from Cout,
//    so a block stages its halo once for all output channels up to 128;
//    TZ x 8 x 8 output voxels a block, two consumer warpgroups of P z-planes
//    each (one m64 product a plane), P 4 / 2 / 2 at N 32 / 64 / 128 where
//    the grid still gives half the SMs a block, else P 1.
//  * The 27 taps as shifted views. A chunk of 16 input channels is staged
//    with its one-voxel halo ((TZ + 2) x 10 x 10 voxels) in the no-swizzle
//    K-major layout [8-channel half][hz][hy][hx][8 channels]: a voxel is one
//    16-byte row, 8 neighbouring x form a core matrix, the next y row is the
//    stride offset (160 bytes), the chunk's other half the leading offset.
//    Tap (kd, kh, kw) of plane p is the descriptor's start moved by
//    ((p + kd) 10 + kh) 10 + kw rows: one added constant, and every input
//    element is read from L2 (TZ + 2) 100 / (64 TZ) times, not 27.
//  * Fed by a producer. The weights come packed once by the wrapper as
//    (Cout_p / NT, Cin_p / 16, 3, 9, 2, NT, 8): one (N tile, chunk, kd) is
//    one contiguous stage of 9 taps in the B layout (core matrices of 8
//    output x 8 input channels; next 8 outputs 128 bytes on, the chunk's
//    second half NT x 16 bytes on), fetched by one 1-D bulk copy into a
//    four-stage ring. The halo arrives by TMA where a voxel's channel row
//    is 16-byte aligned (Cin % 8 == 0): a 5-D tiled tensor map over
//    (B, Z, Y, X, C), one box of 8 channels x 10 x 10 x (TZ + 2) a half,
//    zeros outside the grid and past Cin, the map encoded at each launch
//    and passed as a `__grid_constant__` parameter (a captured CUDA graph
//    keeps it). Elsewhere (Cin 390: 780-byte rows; odd Cin) eight staging
//    warps fill a three-stage ring: a voxel's 32 bytes of the chunk from the
//    three aligned 16-byte words around them, loaded as vectors and shifted
//    into place in registers (the block then has the SM to itself; the
//    loads and their bytes through L1 leave it about a quarter behind TMA
//    at Cin 392). Full and empty `mbarrier`s a stage (bytes for TMA,
//    arrivals for the stagers and for every consumer warp); no block-wide
//    barrier in the main loop.
//  * Consumers issue a kd plane's 9 taps x P products, commit, and free the
//    previous plane's stages once `wgmma.wait_group 1` says its products
//    are done, so one plane's products always queue behind the other's.
//  * Epilogue: bias in float32, one rounding to bf16, the tile through
//    shared memory to 16-byte stores where Cout % 8 == 0; ragged Cout and
//    voxels past the grid masked. Two blocks an SM where accumulators and
//    rings fit (N x P <= 128 with TMA), so one block's epilogue and
//    prologue hide under the other's products.
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
#include "hopper.cuh"

#include <cstring>

#include <cooperative_groups.h>

namespace {

// The N tile of the CUDA-core kernels; their packed weights and bias are
// padded to a multiple of it.
int bdm_conv3d_n_tile_of(int cout) { return cout <= 32 ? 32 : 64; }

int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return count;
}

// ------------------------------------------------------ warpgroup tensor cores

// The N tile of the warpgroup kernel: every output channel of Cout <= 128
// in one block, so the halo is staged once for all of them.
int wgmma_n_tile_of(int cout) {
  return cout <= 32 ? 32 : (cout <= 64 ? 64 : 128);
}

constexpr int kWgCK = 16;                  // input channels a chunk: one k16
constexpr int kWgHY = 10, kWgHX = 10;      // the 8 x 8 face with its halo
constexpr int kWgWeightStages = 4;
constexpr int kWgConsumers = 2;            // consumer warpgroups
constexpr int kWgBarBytes = 1024;          // the rings' barriers
constexpr int kSmemPerSM = 233472;         // bytes of shared memory an SM

// A block of the warpgroup kernel: TZ x 8 x 8 output voxels, each consumer
// warpgroup P z-planes of 64 rows (one m64 product each), times an N tile.
// One producer warp issues the weights (and, with TMA, the halo); without
// TMA eight more warps stage the halo (a third stage lets them run ahead)
// and the block has the SM to itself.
template <int NT, int P, bool TMA>
struct WgTile {
  static constexpr int TZ = kWgConsumers * P;
  static constexpr int HV = (TZ + 2) * kWgHY * kWgHX;   // halo voxels
  static constexpr int GROUP = HV * 16;          // bytes of 8 channels
  static constexpr int HALO_STAGE = 2 * GROUP;   // one chunk of 16
  static constexpr int HALO_STAGES = TMA ? 2 : 3;
  static constexpr int W_STAGE = 9 * kWgCK * NT * 2;   // one kd plane of taps
  static constexpr int SMEM = kWgBarBytes + HALO_STAGES * HALO_STAGE +
                              kWgWeightStages * W_STAGE;
  static constexpr int STAGERS = TMA ? 0 : 256;   // halo threads
  static constexpr int THREADS = kWgConsumers * 128 + 32 + STAGERS;
  static constexpr int OUT_PITCH = NT * 2 + 16;  // a staged output row
  // two blocks an SM where their accumulators and rings fit
  static constexpr int MIN_BLOCKS =
      TMA && NT * P <= 128 && 2 * (SMEM + 1024) <= kSmemPerSM ? 2 : 1;
  static_assert(GROUP % 128 == 0 && W_STAGE % 128 == 0, "TMA alignment");
  static_assert(SMEM + 1024 <= kSmemPerSM, "one block an SM");
  static_assert(kWgConsumers * P * 64 * OUT_PITCH <= SMEM - kWgBarBytes,
                "the output tile is staged where the rings were");
};

// The halo of one chunk staged without TMA (a voxel's channel row not
// 16-byte aligned: Cin 390's 780-byte rows, odd Cin) by THREADS staging
// threads: [half][hz][hy][hx][8 channels], zeros outside the grid and past
// Cin. Thread t takes halo voxels t, t + THREADS, ...; the chunk's 32 bytes
// of a voxel lie in the three aligned 16-byte words around them, loaded as
// vectors (four voxels' before any store), shifted into place (whole
// words, then half a word) and masked past Cin. A word that starts inside
// the tensor lies in its page, so reading it whole is safe.
template <int TZ2, int THREADS>
__device__ __forceinline__ void wg_stage_halo(
    unsigned char* dst, const __nv_bfloat16* __restrict__ x, int batch,
    int b, int r, int cin, int c0, int z0, int y0, int x0, int t) {
  constexpr int HV = TZ2 * kWgHY * kWgHX;
  constexpr int GROUP = HV * 16;
  constexpr int ITEMS = 4;   // voxels a thread a round, loads in flight
  const uintptr_t end = reinterpret_cast<uintptr_t>(
      x + static_cast<size_t>(batch) * r * r * r * cin);
  for (int h0 = t; h0 < HV; h0 += THREADS * ITEMS) {
    uint4 w[ITEMS][3];
    int shift[ITEMS];
    bool in[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int hv = h0 + THREADS * k;
      const int hz = hv / (kWgHY * kWgHX);
      const int rem = hv - hz * (kWgHY * kWgHX);
      const int hy = rem / kWgHX, hx = rem - hy * kWgHX;
      const int gz = z0 - 1 + hz, gy = y0 - 1 + hy, gx = x0 - 1 + hx;
      in[k] = hv < HV && gz >= 0 && gz < r && gy >= 0 && gy < r && gx >= 0 &&
              gx < r;
      const uintptr_t a = reinterpret_cast<uintptr_t>(
          x + (((static_cast<size_t>(b) * r + (in[k] ? gz : 0)) * r +
                (in[k] ? gy : 0)) * r + (in[k] ? gx : 0)) * cin + c0);
      shift[k] = static_cast<int>(a & 15);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const uintptr_t word = (a & ~static_cast<uintptr_t>(15)) + 16 * q;
        w[k][q] = in[k] && word < end
                      ? *reinterpret_cast<const uint4*>(word)
                      : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int hv = h0 + THREADS * k;
      if (hv >= HV) continue;
      uint32_t v[12] = {w[k][0].x, w[k][0].y, w[k][0].z, w[k][0].w,
                        w[k][1].x, w[k][1].y, w[k][1].z, w[k][1].w,
                        w[k][2].x, w[k][2].y, w[k][2].z, w[k][2].w};
      // whole words: by 2, then by 1; then half a word (odd Cin)
      const int o = shift[k] >> 2;
#pragma unroll
      for (int i = 0; i < 10; ++i) v[i] = (o & 2) ? v[i + 2] : v[i];
#pragma unroll
      for (int i = 0; i < 9; ++i) v[i] = (o & 1) ? v[i + 1] : v[i];
      uint32_t out[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        out[i] = (shift[k] & 2) ? __funnelshift_r(v[i], v[i + 1], 16) : v[i];
        const int ch = c0 + 2 * i;   // zeros past Cin (and off the grid)
        if (!in[k] || ch >= cin) out[i] = 0;
        else if (ch + 1 >= cin) out[i] &= 0xFFFFu;
      }
      *reinterpret_cast<uint4*>(dst + hv * 16) =
          make_uint4(out[0], out[1], out[2], out[3]);
      *reinterpret_cast<uint4*>(dst + GROUP + hv * 16) =
          make_uint4(out[4], out[5], out[6], out[7]);
    }
  }
}

// Warp-specialised implicit GEMM on the warpgroup tensor cores (see the head
// of this file). Barriers at the base of shared memory: halo full / empty,
// weights full / empty; then the halo ring, then the weight ring.
template <int NT, int P, bool TMA>
__global__ void __launch_bounds__(WgTile<NT, P, TMA>::THREADS,
                                  WgTile<NT, P, TMA>::MIN_BLOCKS)
    conv3d_wgmma_kernel(__grid_constant__ const CUtensorMap tmap,
                        const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wp,
                        const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int batch, int r,
                        int cin, int cout) {
  using T = WgTile<NT, P, TMA>;
  constexpr int HS = T::HALO_STAGES, WS = kWgWeightStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t bar0 = smem_u32(smem);
  const uint32_t h_full = bar0, h_empty = bar0 + 8 * HS;
  const uint32_t w_full = bar0 + 16 * HS, w_empty = w_full + 8 * WS;
  unsigned char* halo_s = smem + kWgBarBytes;
  const uint32_t halo_a = bar0 + kWgBarBytes;
  const uint32_t w_a = halo_a + HS * T::HALO_STAGE;

  const int ntx = (r + 7) / 8;
  const int ntz = (r + T::TZ - 1) / T::TZ;
  int tile = blockIdx.x;
  const int x0 = tile % ntx * 8;
  tile /= ntx;
  const int y0 = tile % ntx * 8;
  tile /= ntx;
  const int z0 = tile % ntz * T::TZ;
  const int b = tile / ntz;
  const int ntile = blockIdx.y;
  const int nchunks = (cin + kWgCK - 1) / kWgCK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    // full: the producer's one arrival (TMA) or every staging thread's;
    // empty: every consumer warp
    for (int s = 0; s < HS; ++s) {
      mbar_init(h_full + 8 * s, TMA ? 1 : T::STAGERS);
      mbar_init(h_empty + 8 * s, kWgConsumers * 4);
    }
    for (int s = 0; s < WS; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, kWgConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWgConsumers * 4) {
    // ---- producer: each chunk's weights plane by plane (and its halo by
    // TMA first), never held up by the halo's loads
    int wit = 0;
    for (int c = 0; c < nchunks; ++c) {
      if constexpr (TMA) {
        const int hs = c % HS;
        mbar_wait(h_empty + 8 * hs, ((c / HS) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(h_full + 8 * hs, T::HALO_STAGE);
#pragma unroll
          for (int g = 0; g < 2; ++g)
            tma_load_5d(halo_a + hs * T::HALO_STAGE + g * T::GROUP, &tmap,
                        h_full + 8 * hs, c * kWgCK + 8 * g, x0 - 1, y0 - 1,
                        z0 - 1, b);
        }
      }
      for (int kd = 0; kd < 3; ++kd, ++wit) {
        const int ws = wit % WS;
        mbar_wait(w_empty + 8 * ws, ((wit / WS) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(w_full + 8 * ws, T::W_STAGE);
          bulk_load(w_a + ws * T::W_STAGE,
                    wp + ((static_cast<size_t>(ntile) * nchunks + c) * 3 + kd) *
                             (T::W_STAGE / 2),
                    T::W_STAGE, w_full + 8 * ws);
        }
      }
    }
    return;
  }
  if constexpr (!TMA) {
    if (warp > kWgConsumers * 4) {
      // ---- halo stagers
      const int pt = threadIdx.x - (kWgConsumers * 128 + 32);
      for (int c = 0; c < nchunks; ++c) {
        const int hs = c % HS;
        mbar_wait(h_empty + 8 * hs, ((c / HS) & 1) ^ 1);
        wg_stage_halo<T::TZ + 2, T::STAGERS>(halo_s + hs * T::HALO_STAGE, x,
                                             batch, b, r, cin, c * kWgCK, z0,
                                             y0, x0, pt);
        // seen by the async proxy that wgmma reads through
        fence_proxy_async();
        mbar_arrive(h_full + 8 * hs);
      }
      return;
    }
  }

  // ---- consumers: warpgroup wg computes z planes wg P .. wg P + P - 1
  const int wg = warp >> 2;
  float acc[P][NT / 2];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[p][i] = 0.0f;
  // A: row 8 y + x of a plane is the halo voxel (y + kh, x + kw) of plane
  // z + kd: 8-row groups one halo row (160 bytes) apart, the two 8-channel
  // halves of a chunk one group apart. B: (tap, channel group, n, 8).
  const uint64_t a_desc = wgmma_desc(
      halo_a + wg * P * kWgHY * kWgHX * 16, T::GROUP, kWgHX * 16);
  const uint64_t b_desc = wgmma_desc(w_a, NT * 16, 128);
  int wit = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int hs = c % HS;
    mbar_wait(h_full + 8 * hs, (c / HS) & 1);
    for (int kd = 0; kd < 3; ++kd, ++wit) {
      const int ws = wit % WS;
      mbar_wait(w_full + 8 * ws, (wit / WS) & 1);
      // descriptors count in 16-byte units: one halo voxel, one weight row
      const uint64_t a_st =
          a_desc + hs * (T::HALO_STAGE / 16) + kd * kWgHY * kWgHX;
      const uint64_t b_st = b_desc + ws * (T::W_STAGE / 16);
#pragma unroll
      for (int p = 0; p < P; ++p) fence_regs(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int t9 = 0; t9 < 9; ++t9)
#pragma unroll
        for (int p = 0; p < P; ++p)
          Wgmma<NT>::mma(acc[p], a_st + (p * kWgHY + t9 / 3) * kWgHX + t9 % 3,
                         b_st + t9 * 2 * NT);
      wgmma_commit();
#pragma unroll
      for (int p = 0; p < P; ++p) fence_regs(acc[p]);
      // the previous step's products are done: free its stages
      wgmma_wait<1>();
#pragma unroll
      for (int p = 0; p < P; ++p) fence_regs(acc[p]);
      if (lane == 0 && wit > 0) {
        mbar_arrive(w_empty + 8 * ((wit - 1) % WS));
        if (kd == 0) mbar_arrive(h_empty + 8 * ((c - 1) % HS));
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < P; ++p) fence_regs(acc[p]);

  // ---- epilogue: bias in float32 and one rounding; the tile goes through
  // shared memory (the rings are free once both warpgroups are done), each
  // warpgroup its own rows, so that it leaves in 16-byte stores
  named_barrier(1, kWgConsumers * 128);
  unsigned char* o_s = halo_s + wg * P * 64 * T::OUT_PITCH;
  const int n0 = ntile * NT;
  const int g = lane >> 2, t = lane & 3, wq = warp & 3;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < NT / 8; ++i) {
      const int col = 8 * i + 2 * t;   // bias is padded to Cout_p
      const float b0 = bias[n0 + col], b1 = bias[n0 + col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(
            o_s + (p * 64 + 16 * wq + g + 8 * h) * T::OUT_PITCH + 2 * col) =
            __floats2bfloat162_rn(acc[p][4 * i + 2 * h] + b0,
                                  acc[p][4 * i + 2 * h + 1] + b1);
    }
  named_barrier(2 + wg, 128);
  const bool whole = cout % 8 == 0;   // rows of the output 16-byte aligned
  for (int q = threadIdx.x & 127; q < P * 64 * (NT / 8); q += 128) {
    const int row = q / (NT / 8), piece = q % (NT / 8);
    const int gz = z0 + wg * P + (row >> 6);
    const int gy = y0 + ((row >> 3) & 7), gx = x0 + (row & 7);
    const int col = n0 + piece * 8;
    if (gz >= r || gy >= r || gx >= r || col >= cout) continue;
    const unsigned char* from = o_s + row * T::OUT_PITCH + piece * 16;
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

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// `cuTensorMapEncodeTiled` from libcuda, looked up through the runtime (no
// link to libcuda needed).
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

template <int NT, int P, bool TMA>
int launch_wgmma(const void* x, const void* wp, const float* bias, void* out,
                 int b, int r, int cin, int cout, cudaStream_t stream) {
  using T = WgTile<NT, P, TMA>;
  // the tensor map goes to the kernel by value (a `__grid_constant__`
  // parameter), so a captured CUDA graph keeps it
  CUtensorMap tmap;
  memset(&tmap, 0, sizeof(tmap));
  if (TMA) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t e = sizeof(__nv_bfloat16);
    const cuuint64_t dims[5] = {static_cast<cuuint64_t>(cin),
                                static_cast<cuuint64_t>(r),
                                static_cast<cuuint64_t>(r),
                                static_cast<cuuint64_t>(r),
                                static_cast<cuuint64_t>(b)};
    const cuuint64_t strides[4] = {dims[0] * e, dims[0] * dims[1] * e,
                                   dims[0] * dims[1] * dims[2] * e,
                                   dims[0] * dims[1] * dims[2] * dims[3] * e};
    const cuuint32_t box[5] = {8, kWgHX, kWgHY, T::TZ + 2, 1};
    const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
    if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
               const_cast<void*>(x), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = bdm_allow_smem(conv3d_wgmma_kernel<NT, P, TMA>, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntx = (r + 7) / 8, ntz = (r + T::TZ - 1) / T::TZ;
  const int cout_p = (cout + NT - 1) / NT * NT;
  const dim3 grid(static_cast<unsigned>(b) * ntx * ntx * ntz, cout_p / NT);
  conv3d_wgmma_kernel<NT, P, TMA><<<grid, T::THREADS, T::SMEM, stream>>>(
      tmap, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), bias,
      static_cast<__nv_bfloat16*>(out), b, r, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

// The z-planes a consumer warpgroup takes, by shape: the deep tile (fewer
// halo planes and weight reads a voxel) where its grid gives at least half
// the SMs a block; below that one plane, with twice the blocks, is faster
// (on the H100 SXM: 1.8x at 16 to 64 deep blocks, 3-8 % slower at 96 to
// 128). Without TMA at N 128, a plane's 64 accumulators a thread and the
// stagers' share leave room for one.
int wgmma_planes(int b, int r, int cout, bool tma) {
  const int nt = wgmma_n_tile_of(cout);
  const int deep = nt == 32 ? 4 : (nt == 64 || tma ? 2 : 1);
  const int ntx = (r + 7) / 8, tz = kWgConsumers * deep;
  const long long blocks = static_cast<long long>(b) * ntx * ntx *
                           ((r + tz - 1) / tz) * ((cout + nt - 1) / nt);
  return deep > 1 && 2 * blocks >= sm_count() ? deep : 1;
}

// TMA where a voxel's channel row is 16-byte aligned, staging warps
// elsewhere; the N tile from Cout, the planes from the grid.
int launch_wgmma_bf16(const void* x, const void* wp, const float* bias,
                      void* out, int b, int r, int cin, int cout,
                      cudaStream_t stream) {
  const bool tma =
      cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int nt = wgmma_n_tile_of(cout);
  const bool deep = wgmma_planes(b, r, cout, tma) > 1;
#define BDM_WG(NT_, P_, TMA_)                                              \
  return launch_wgmma<NT_, P_, TMA_>(x, wp, bias, out, b, r, cin, cout, \
                                     stream)
  if (tma) {
    if (nt == 32) { if (deep) BDM_WG(32, 4, true); BDM_WG(32, 1, true); }
    if (nt == 64) { if (deep) BDM_WG(64, 2, true); BDM_WG(64, 1, true); }
    if (deep) BDM_WG(128, 2, true);
    BDM_WG(128, 1, true);
  }
  if (nt == 32) { if (deep) BDM_WG(32, 4, false); BDM_WG(32, 1, false); }
  if (nt == 64) { if (deep) BDM_WG(64, 2, false); BDM_WG(64, 1, false); }
  BDM_WG(128, 1, false);
#undef BDM_WG
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

// Which kernel a call takes: 2 the warpgroup tensor-core kernel, 0 the
// CUDA-core one. A rule on the grid's type alone.
BDM_EXPORT int bdm_conv3d_path(int dtype, int cin, int cout, int r) {
  (void)cin;
  (void)cout;
  (void)r;
  return dtype == BDM_BF16 ? 2 : 0;
}

// The z-planes a consumer warpgroup of the warpgroup kernel takes for a
// grid of `dtype` (0 for the CUDA-core kernels) whose start is 16-byte
// `aligned` or not.
BDM_EXPORT int bdm_conv3d_planes(int dtype, int b, int r, int cin, int cout,
                                 int aligned) {
  if (dtype != BDM_BF16) return 0;
  return wgmma_planes(b, r, cout, cin % 8 == 0 && aligned);
}

// The N tile of the kernel a grid of `dtype` takes, chosen from Cout; the
// packed weights and bias are padded to a multiple of it.
BDM_EXPORT int bdm_conv3d_n_tile(int dtype, int cout) {
  return dtype == BDM_BF16 ? wgmma_n_tile_of(cout) : bdm_conv3d_n_tile_of(cout);
}

// `w` and `bias` as the wrapper packs them for the path the call takes:
// (Cout_p / NT, Cin_p / 16, 3, 9, 2, NT, 8) bf16 (N tile, chunk of 16
// input channels, kd, (kh, kw), 8-channel group, output channel, channel)
// and (Cout_p,) float32 for the warpgroup kernel; (Kp, Cout_p) float32
// (rows (tap, channel), the channels of a tap padded to a multiple of 4, Kp
// to one of 16) and (Cout_p,) float32 for the other; both 16-byte aligned.
BDM_EXPORT int bdm_conv3d(const void* x, const void* w, const float* bias,
                          void* out, int b, int r, int cin, int cout,
                          int dtype, cudaStream_t stream) {
  if (b < 1 || r < 1 || cin < 1 || cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == BDM_BF16) {
    // the packed weights for bulk copies, out for 16-byte stores when its
    // rows allow them; x takes the widest copy its alignment allows
    const uintptr_t out_align = cout % 8 == 0 ? 16 : 2;
    if (reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % out_align != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    return launch_wgmma_bf16(x, w, bias, out, b, r, cin, cout, stream);
  }
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bias) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (dtype == BDM_F32)
    return launch_simt_f32(x, w, bias, out, b, r, cin, cout, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
