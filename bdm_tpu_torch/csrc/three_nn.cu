// Three nearest centres and their inverse-distance weights.
//
// Replaces the TPU kernel `_tnn_kernel` / `three_nn_pallas`
// (bdm_tpu/ops/pallas/three_nn.py). Semantics: for each query point the
// three centres with the smallest squared distance, ordered by (distance,
// index), so the lower index wins a tie; distances clamped to
// [1e-10, 1e10]; weights w_i = prod_{j != i} d_j / ((d0*d1 + d0*d2) + d1*d2),
// every operation rounded on its own, in that order. M >= 1: with fewer
// than three centres the last one found repeats, as the JAX reference's
// plain path gives it. Coordinates are finite and their squared distances
// below FLT_MAX.
//
// Bound on the H100: instruction issue. Every query scans all M centres
// (B 8, N 4096, M 1024: 33.5 M pairs) and `sqdist` must not be contracted
// into FMAs, so a pair costs 8 floating-point instructions before any
// bookkeeping of the best three.
// Design: the centres of a query are split over L lanes of a warp, L from
// B * N and M (`bdm_three_nn_lanes`), so that the small levels still fill
// the card. A block stages the centres of its batch element in shared
// memory, a tile at a time, as three float arrays (x, y, z; a warp's reads
// are broadcasts or L distinct words, with no bank conflict). Lane s of a
// query scans the steps s, s + L, ... of U consecutive centres
// (`bdm_three_nn_step`), padded at the end with centres at +inf. Two
// phases keep the scan free of branches, whose divergence (some lane of a
// warp nearly always inserts) cost the one-thread-a-query form its time:
//   1. each step's least distance goes into the lane's three least steps,
//      by strict < with selects (steps arrive in ascending order);
//   2. the centres of those three steps are recomputed, each step's best
//      three kept by strict <, and the three triples merged on
//      (d, index). A centre among the query's three nearest lies in one of
//      its lane's three least steps: a step outside them has three steps
//      before it on (least distance, step), each holding a centre before
//      that centre on (d, index).
// With U = 1 (few centres) the steps are the centres and phase 2 is not
// needed. Then log2 L xor-shuffle rounds merge two sorted triples:
// min(a_k, b_(2-k)) on (d, index) gives the three least of the union as a
// bitonic triple, and two compare-exchanges, (0, 2) then (1, 2), sort it.
// A lane that owns fewer than three centres holds (+inf, INT_MAX) entries,
// which lose to every centre. Lane 0 of a query writes its indices and
// weights.
#include "common.cuh"

#include <algorithm>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;         // centres staged a pass (24 KB)
constexpr int kNone = INT_MAX;      // a sentinel's index
constexpr unsigned kNoStep = UINT_MAX;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStepFrom = 256;      // M from which a step holds 4 centres

struct Top3 {
  float d0, d1, d2;
  int i0, i1, i2;
};

__device__ __forceinline__ Top3 empty3() {
  return Top3{INFINITY, INFINITY, INFINITY, kNone, kNone, kNone};
}

// Strict < insertion of (x, s) into a sorted triple, with selects only.
// Items arrive in ascending s, so of two equal values the earlier stays
// first: the (value, s) order.
template <typename T>
__device__ __forceinline__ void insert(float& v0, float& v1, float& v2,
                                       T& s0, T& s1, T& s2, float x, T s,
                                       bool take) {
  const bool p0 = take && x < v0, p1 = take && x < v1, p2 = take && x < v2;
  v2 = p1 ? v1 : (p2 ? x : v2);
  s2 = p1 ? s1 : (p2 ? s : s2);
  v1 = p0 ? v0 : (p1 ? x : v1);
  s1 = p0 ? s0 : (p1 ? s : s1);
  v0 = p0 ? x : v0;
  s0 = p0 ? s : s0;
}

__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__device__ __forceinline__ void keep_lesser(float& d, int& i, float od,
                                            int oi) {
  const bool o = before(od, oi, d, i);
  d = o ? od : d;
  i = o ? oi : i;
}

__device__ __forceinline__ void order(float& da, int& ia, float& db,
                                      int& ib) {
  const bool s = before(db, ib, da, ia);
  const float d = da;
  const int i = ia;
  da = s ? db : da;
  ia = s ? ib : ia;
  db = s ? d : db;
  ib = s ? i : ib;
}

// t <- the three least of t and o (both sorted, disjoint) on (d, index)
__device__ __forceinline__ void merge(Top3& t, const Top3& o) {
  keep_lesser(t.d0, t.i0, o.d2, o.i2);
  keep_lesser(t.d1, t.i1, o.d1, o.i1);
  keep_lesser(t.d2, t.i2, o.d0, o.i0);
  order(t.d0, t.i0, t.d2, t.i2);
  order(t.d1, t.i1, t.d2, t.i2);
}

__device__ __forceinline__ void merge_xor(Top3& t, int off) {
  Top3 o;
  o.d0 = __shfl_xor_sync(kFull, t.d0, off);
  o.d1 = __shfl_xor_sync(kFull, t.d1, off);
  o.d2 = __shfl_xor_sync(kFull, t.d2, off);
  o.i0 = __shfl_xor_sync(kFull, t.i0, off);
  o.i1 = __shfl_xor_sync(kFull, t.i1, off);
  o.i2 = __shfl_xor_sync(kFull, t.i2, off);
  merge(t, o);
}

// The U centres from `first` on, out of the staged arrays (x at 0, y at
// `stride`, z at 2 * stride); float4 reads where U allows
template <int U>
__device__ __forceinline__ void load(const float* sc, int stride, int first,
                                     float* cx, float* cy, float* cz) {
  if (U % 4 == 0) {
#pragma unroll
    for (int u = 0; u < U; u += 4) {
      const float4 x = *reinterpret_cast<const float4*>(sc + first + u);
      const float4 y =
          *reinterpret_cast<const float4*>(sc + stride + first + u);
      const float4 z =
          *reinterpret_cast<const float4*>(sc + 2 * stride + first + u);
      cx[u] = x.x; cx[u + 1] = x.y; cx[u + 2] = x.z; cx[u + 3] = x.w;
      cy[u] = y.x; cy[u + 1] = y.y; cy[u + 2] = y.z; cy[u + 3] = y.w;
      cz[u] = z.x; cz[u + 1] = z.y; cz[u + 2] = z.z; cz[u + 3] = z.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cx[u] = sc[first + u];
      cy[u] = sc[stride + first + u];
      cz[u] = sc[2 * stride + first + u];
    }
  }
}

template <int L, int U>
__global__ void __launch_bounds__(kThreads)
    three_nn_kernel(const float* __restrict__ points,
                    const float* __restrict__ centers, int* __restrict__ idx,
                    float* __restrict__ weight, int n, int m, int stride) {
  extern __shared__ float sc[];
  const int b = blockIdx.y;
  const int sub = threadIdx.x % L;
  const int q = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  // a query past N scans for the last one and stores nothing: its lanes
  // take part in the shuffles
  const float* pp = points + (static_cast<size_t>(b) * n + min(q, n - 1)) * 3;
  const float px = pp[0], py = pp[1], pz = pp[2];
  const float* cb = centers + static_cast<size_t>(b) * m * 3;
  Top3 t = empty3();
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int lim = min(kTile, m - t0);
    // whole steps for every lane of a query
    const int steps = (lim + L * U - 1) / (L * U) * L;
    __syncthreads();
    for (int i = threadIdx.x; i < steps * U; i += kThreads) {
      float x = INFINITY, y = INFINITY, z = INFINITY;
      if (i < lim) {
        const float* c = cb + static_cast<size_t>(t0 + i) * 3;
        x = c[0];
        y = c[1];
        z = c[2];
      }
      sc[i] = x;
      sc[stride + i] = y;
      sc[2 * stride + i] = z;
    }
    __syncthreads();
    // phase 1: the lane's three least steps
    float v0 = INFINITY, v1 = INFINITY, v2 = INFINITY;
    unsigned s0 = kNoStep, s1 = kNoStep, s2 = kNoStep;
    for (int s = sub; s < steps; s += L) {
      float cx[U], cy[U], cz[U];
      load<U>(sc, stride, s * U, cx, cy, cz);
      float x = sqdist(px, py, pz, cx[0], cy[0], cz[0]);
#pragma unroll
      for (int u = 1; u < U; ++u)
        x = fminf(x, sqdist(px, py, pz, cx[u], cy[u], cz[u]));
      insert(v0, v1, v2, s0, s1, s2, x, static_cast<unsigned>(s), true);
    }
    if (U == 1) {   // the steps are the centres
      const auto index = [&](unsigned s) {
        return s == kNoStep ? kNone : t0 + static_cast<int>(s);
      };
      merge(t, Top3{v0, v1, v2, index(s0), index(s1), index(s2)});
      continue;
    }
    // phase 2: the centres of those steps
    Top3 st[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const unsigned s = r == 0 ? s0 : (r == 1 ? s1 : s2);
      const bool live = s != kNoStep;
      const int first = live ? static_cast<int>(s) * U : 0;
      float cx[U], cy[U], cz[U];
      load<U>(sc, stride, first, cx, cy, cz);
      st[r] = empty3();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float d = sqdist(px, py, pz, cx[u], cy[u], cz[u]);
        insert(st[r].d0, st[r].d1, st[r].d2, st[r].i0, st[r].i1, st[r].i2, d,
               t0 + first + u, live && first + u < lim);
      }
    }
    merge(st[0], st[1]);
    merge(st[0], st[2]);
    merge(t, st[0]);
  }
#pragma unroll
  for (int off = 1; off < L; off <<= 1) merge_xor(t, off);
  if (m < 3) {   // repeat the last centre found
    t.d2 = m == 1 ? t.d0 : t.d1;
    t.i2 = m == 1 ? t.i0 : t.i1;
    t.d1 = m == 1 ? t.d0 : t.d1;
    t.i1 = m == 1 ? t.i0 : t.i1;
  }
  if (sub != 0 || q >= n) return;
  const float d0 = fminf(fmaxf(t.d0, 1e-10f), 1e10f);
  const float d1 = fminf(fmaxf(t.d1, 1e-10f), 1e10f);
  const float d2 = fminf(fmaxf(t.d2, 1e-10f), 1e10f);
  const float p12 = __fmul_rn(d1, d2);
  const float p02 = __fmul_rn(d0, d2);
  const float p01 = __fmul_rn(d0, d1);
  const float denom = __fadd_rn(__fadd_rn(p01, p02), p12);
  const size_t o = (static_cast<size_t>(b) * n + q) * 3;
  idx[o] = t.i0;
  idx[o + 1] = t.i1;
  idx[o + 2] = t.i2;
  weight[o] = __fdiv_rn(p12, denom);
  weight[o + 1] = __fdiv_rn(p02, denom);
  weight[o + 2] = __fdiv_rn(p01, denom);
}

// Centres a step: 4 from kStepFrom centres on (ops/cuda/three_nn.py::step
// is the same rule)
int tnn_step(int m) { return m >= kStepFrom ? 4 : 1; }

// Lanes a query: the least power of two from 1 to 32 that gives B * N * L
// at least 2^15 threads, and no more than one step of centres a lane
// (ops/cuda/three_nn.py::lanes is the same rule). The first FP level
// (B 8, N 4096) runs one lane a query: the two phases give each thread
// independent work, and a split would only add merges; the small levels
// split their centres to spread over more of the card.
int tnn_lanes(int b, int n, int m) {
  const long long queries = static_cast<long long>(b) * n;
  const int u = tnn_step(m);
  int l = 1;
  while (l < 32 && queries * l < (1 << 15) && l * u < m) l *= 2;
  return l;
}

template <int L, int U>
int launch(const float* points, const float* centers, int* idx,
           float* weight, int b, int n, int m, cudaStream_t stream) {
  const dim3 grid((n + kThreads / L - 1) / (kThreads / L), b);
  const int stride = (std::min(m, kTile) + L * U - 1) / (L * U) * (L * U);
  three_nn_kernel<L, U><<<grid, kThreads, 3 * stride * sizeof(float),
                          stream>>>(points, centers, idx, weight, n, m,
                                    stride);
  return static_cast<int>(cudaGetLastError());
}

template <int U>
int launch_lanes(int l, const float* points, const float* centers, int* idx,
                 float* weight, int b, int n, int m, cudaStream_t stream) {
  switch (l) {
    case 1: return launch<1, U>(points, centers, idx, weight, b, n, m, stream);
    case 2: return launch<2, U>(points, centers, idx, weight, b, n, m, stream);
    case 4: return launch<4, U>(points, centers, idx, weight, b, n, m, stream);
    case 8: return launch<8, U>(points, centers, idx, weight, b, n, m, stream);
    case 16:
      return launch<16, U>(points, centers, idx, weight, b, n, m, stream);
    default:
      return launch<32, U>(points, centers, idx, weight, b, n, m, stream);
  }
}

}  // namespace

BDM_EXPORT int bdm_three_nn(const float* points, const float* centers,
                            int* idx, float* weight, int b, int n, int m,
                            cudaStream_t stream) {
  if (b == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const int l = tnn_lanes(b, n, m);
  return tnn_step(m) == 4
             ? launch_lanes<4>(l, points, centers, idx, weight, b, n, m,
                               stream)
             : launch_lanes<1>(l, points, centers, idx, weight, b, n, m,
                               stream);
}

BDM_EXPORT int bdm_three_nn_lanes(int b, int n, int m) {
  return tnn_lanes(b, n, m);
}

BDM_EXPORT int bdm_three_nn_step(int m) { return tnn_step(m); }
