// Three-neighbour weighted blend of bf16 centre features.
//
// Replaces the TPU kernel `_interp_mm_kernel` / `_interp_mm_fwd_pallas`
// (bdm_tpu/ops/pallas/interp_mm.py). Semantics: out[n] = sum_k
// bf16(w_k[n]) * F[idx_k[n]], the weights rounded once to bf16, the
// products accumulated in float32 in k order and rounded once to bf16 at
// the store. The TPU kernel writes this as a one-hot (N, M) matrix times F
// because the TPU gathers badly; the card gathers well, so the rows are
// read directly and the 2*N*M*C operations of the one-hot product shrink
// to the 6*N*C of the blend. Every product and sum is rounded on its own
// (`__fmul_rn`, `__fadd_rn`) in the plain version's order, so the result
// is the plain version's bit for bit whatever nvcc contracts.
//
// Bound on the H100: bytes. A call reads idx, w and F once and writes
// (B, N, C) bf16: B 8, N 4096 <- M 1024, C 128 moves 11.27 MB (3.36 us at
// 3.35 TB/s), N 1024 <- M 256, C 256 5.44 MB (1.62 us). At that size the
// launch is most of the cost, so the design works on the two dependent
// trips to L2 (idx and w, then the rows of F):
//   * thread t of a block of T = 128 takes channel group t % G (G = C / 8
//     groups of 16 bytes) of rows t / G + p * T / G, p < R = 2: a warp
//     covers 32 / G consecutive rows, so its loads of idx and w read one
//     contiguous span (the G threads of a row load the same 24 bytes in one
//     request) and its 16-byte stores fill whole sectors. A thread issues
//     the 6 loads of idx and w for its R rows, rounds each weight to bf16
//     once, then issues all 3 R gathers before its first product;
//   * 32-bit index math on a grid of row blocks (x), batch elements (y)
//     and, where G > T, spans of T groups (z); the wrapper refuses B*N*C or
//     B*M*C of 2^31 or more. A thread divides twice (t / G, t % G), at its
//     start.
// C that is no multiple of 8 takes groups of one channel, a 2-byte gather
// each ("scalar"). Indices are clamped to [0, M) so a bad index cannot read
// outside F (three_nn never produces one).
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int kThreads = 128;   // a block
constexpr int kRows = 2;        // rows a thread

// VEC bf16 channels moved as one access: 16 bytes (uint4) or 2
template <int VEC>
struct Raw;
template <>
struct Raw<8> {
  using type = uint4;
};
template <>
struct Raw<1> {
  using type = unsigned short;
};

// Where thread t of block (x, b, z) works: channel group j of rows
// row0 + q * pass, q < kRows, of batch element b; `mine` is false for the
// threads past a pass's rows and the groups past G.
struct Place {
  int b, j, row0, pass;
  bool mine;
};

__device__ __forceinline__ Place place(int groups) {
  const int t = threadIdx.x;
  const int row_groups = min(groups, kThreads);   // a row's groups a block
  const int pass = kThreads / row_groups;         // rows a pass of the block
  const int rt = t / row_groups;
  const int j = static_cast<int>(blockIdx.z) * kThreads + t % row_groups;
  return {static_cast<int>(blockIdx.y), j,
          static_cast<int>(blockIdx.x) * pass * kRows + rt, pass,
          rt < pass && j < groups};
}

// (kThreads, 1): with the least blocks an SM given, ptxas schedules the
// same 48 registers into a faster kernel than with kThreads alone
// (measured on the card)
template <int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    interp_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                  const __nv_bfloat16* __restrict__ feats,
                  __nv_bfloat16* __restrict__ out, int n, int m, int groups) {
  using Vec = typename Raw<VEC>::type;
  const Place p = place(groups);
  const int* ib = idx + p.b * n * 3;
  const float* wb = w + p.b * n * 3;
  const Vec* fb = reinterpret_cast<const Vec*>(feats) + p.b * m * groups;
  Vec* ob = reinterpret_cast<Vec*>(out) + p.b * n * groups;

  int ri[kRows][3];
  float rw[kRows][3];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int r = p.row0 + q * p.pass;
    const bool live = p.mine && r < n;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ri[q][k] = live ? min(max(__ldg(ib + r * 3 + k), 0), m - 1) : 0;
      rw[q][k] = live ? __bfloat162float(
                            __float2bfloat16_rn(__ldg(wb + r * 3 + k)))
                      : 0.0f;
    }
  }
  Vec g[kRows][3];
#pragma unroll
  for (int q = 0; q < kRows; ++q)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      g[q][k] = __ldg(fb + ri[q][k] * groups + (p.mine ? p.j : 0));
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int r = p.row0 + q * p.pass;
    if (!p.mine || r >= n) continue;
    const auto* g0 = reinterpret_cast<const __nv_bfloat16*>(&g[q][0]);
    const auto* g1 = reinterpret_cast<const __nv_bfloat16*>(&g[q][1]);
    const auto* g2 = reinterpret_cast<const __nv_bfloat16*>(&g[q][2]);
    Vec o;
    auto* ov = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float acc = __fmul_rn(__bfloat162float(g0[v]), rw[q][0]);
      acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(g1[v]), rw[q][1]));
      acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(g2[v]), rw[q][2]));
      ov[v] = __float2bfloat16_rn(acc);
    }
    ob[r * groups + p.j] = o;
  }
}

// Launch the blend on its grid: rows on x, the batch element on y, a
// row's groups past kThreads on z.
template <int VEC>
int launch(const int* idx, const float* w, const __nv_bfloat16* f,
           __nv_bfloat16* o, int b, int n, int m, int groups,
           cudaStream_t stream) {
  const int pass = kThreads / std::min(groups, kThreads);
  const dim3 grid((n + pass * kRows - 1) / (pass * kRows), b,
                  (groups + kThreads - 1) / kThreads);
  interp_kernel<VEC><<<grid, kThreads, 0, stream>>>(idx, w, f, o, n, m,
                                                    groups);
  return static_cast<int>(cudaGetLastError());
}

bool fits(int b, int n, int m, int c) {
  return m >= 1 && c >= 1 && b <= 65535 &&
         static_cast<long long>(b) * n * std::max(c, 3) < (1LL << 31) &&
         static_cast<long long>(b) * m * c < (1LL << 31);
}

}  // namespace

// The kernel's split, which the wrapper mirrors (`interp.THREADS`, `ROWS`)
BDM_EXPORT int bdm_interp_threads() { return kThreads; }
BDM_EXPORT int bdm_interp_rows() { return kRows; }

BDM_EXPORT int bdm_interp(const int* idx, const float* w, const void* feats,
                          void* out, int b, int n, int m, int c,
                          cudaStream_t stream) {
  if (!fits(b, n, m, c)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * n == 0) return static_cast<int>(cudaSuccess);
  const auto* f = static_cast<const __nv_bfloat16*>(feats);
  auto* o = static_cast<__nv_bfloat16*>(out);
  // 16-byte accesses need rows of a multiple of 8 channels (the wrapper
  // checks the 16-byte alignment of F and out)
  if (c % 8 == 0) return launch<8>(idx, w, f, o, b, n, m, c / 8, stream);
  return launch<1>(idx, w, f, o, b, n, m, c, stream);
}
