// GroupNorm over the channel axis of channel-last (B, S, C) tensors, with
// an optional SiLU, as two kernels: the statistics, then the apply.
//
// Replaces no TPU kernel: `bdm_tpu/models/layers.py` takes flax's
// `nn.GroupNorm` (jnp), which XLA fuses on the TPU. Eager PyTorch ran the
// same math as twelve float32 passes a call plus a separate SiLU; here the
// input is read twice (statistics, apply) and the output written once.
// Semantics (`ops/cuda/groupnorm.py::group_norm_plain`): per sample and
// group of C / G channels, over every position, the float32 mean and the
// variance as the mean of squared deviations (never E[x^2] - mean^2);
// y = ((x - mean) * rsqrt(var + eps)) * w + b in float32, each operation
// rounded on its own in that order (`__fsub_rn` ..., so nvcc contracts no
// FMA), then SiLU y / (1 + exp(-y)) in float32 where asked, and one
// rounding to the output type. The plain version rounds the affine to the
// output type before its SiLU. The SiLU takes the card's fast exp and
// division (`__expf`, `__fdividef`: a few float32 ulps, far below a bf16
// rounding); with `expf` and `__fdiv_rn` the apply was bound by its
// instructions (B 64, S 32,768, C 64: 0.552 against 0.354 ms without SiLU,
// on an H100 80GB HBM3 at 700 W).
//
// Bound on the H100: bytes. bf16 moves 6 bytes an element (two reads, one
// write): B 64, S 32,768, C 64 is 805 MB, 0.240 ms at 3.35 TB/s.
//
// Design:
//   * a block of T = 256 threads owns a chunk of whole rows of one sample;
//     thread t takes the 16-byte vector j = t % (C / W) of a row (W = 8
//     bf16 or 4 float32 channels), rows t / (C / W) + k * T / (C / W),
//     k < V = 16: a warp reads whole rows with coalesced 16-byte loads,
//     and a thread's channels, so its groups, stay fixed. V = 16 against
//     8 and 4: 4.76 against 4.96 and 5.84 ms for the 63 norms of a B-64
//     PC2 forward (same card);
//   * the statistics kernel holds its V vectors in registers, sums them by
//     channel, reduces the block's table of sums by group (a warp a group,
//     lanes in a fixed order, then a fixed shuffle tree), and makes a
//     second pass over the same registers for the squared deviations from
//     the chunk's own mean: HBM is read once. It writes (n, mean, M2) a
//     chunk and group to a float32 scratch the wrapper allocates;
//   * the apply kernel first merges its sample's partials by Chan's
//     formula (a warp a group, lanes over the partials in a fixed order,
//     then a fixed shuffle tree), so every block of a sample computes the
//     same statistics bit for bit and no float atomics are needed: results
//     are the same run to run. It then streams its chunk once. Where asked
//     it writes the statistics (mean, rstd) a sample and group, which the
//     backward reads;
//   * a point-sharded norm (x one rank's shard of the point axis) runs the
//     statistics kernel on its shard, gathers every rank's partials
//     (ranks, B, chunks, G) and hands them all to the apply kernel, which
//     merges them in the same fixed order on every rank: every rank
//     normalises with the statistics of the whole, bit for bit the same.
// The split is a function of (S, C, dtype) alone (`bdm_groupnorm_chunks`,
// which the wrapper mirrors). `bdm_groupnorm` launches both kernels on the
// stream it is given; `bdm_groupnorm_stats` and `bdm_groupnorm_apply` one
// each, for the sharded norm's gather between them.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // a block
constexpr int kVecs = 16;      // 16-byte vectors a thread holds
constexpr int kMaxGroups = 32;
constexpr int kWarps = kThreads / 32;

template <typename T>
__host__ __device__ constexpr int lanes() {  // elements in 16 bytes
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float elem(const uint4& v, int e, float) {
  return reinterpret_cast<const float*>(&v)[e];
}
__device__ __forceinline__ float elem(const uint4& v, int e, __nv_bfloat16) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&v)[e]);
}

// Where thread t works in a chunk of `rows` rows: vector j of rows
// rt + k * pass; `on` is false for the threads past a pass's rows.
struct Place {
  int j, rt, pass, rows;
  bool on;
};

template <typename T>
__device__ __forceinline__ Place place(int c) {
  const int vpr = c / lanes<T>();
  const int pass = kThreads / vpr;
  const int t = threadIdx.x;
  return {t % vpr, t / vpr, pass, pass * kVecs, t / vpr < pass};
}

__device__ __forceinline__ float silu(float y) {
  // 0 where 1 + exp(-y) passes 2^126 (y < -87.3), as `__fdividef` gives
  return __fdividef(y, 1.0f + __expf(-y));
}

// (n, mean, M2) <- the union of itself and (nb, mb, m2b), Chan's formula
__device__ __forceinline__ void merge(float& n, float& mean, float& m2,
                                      float nb, float mb, float m2b) {
  if (nb == 0.0f) return;
  if (n == 0.0f) {
    n = nb;
    mean = mb;
    m2 = m2b;
    return;
  }
  const float nt = n + nb;
  const float d = mb - mean;
  mean += d * (nb / nt);
  m2 += m2b + d * d * (n * (nb / nt));
  n = nt;
}

// The sum of the (pass, C) table `red` over group g's channels, by the
// lanes of one warp in a fixed order; lane 0 holds it.
__device__ __forceinline__ float group_sum(const float* red, int g, int cg,
                                           int c, int pass) {
  const int lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int i = lane; i < pass * cg; i += 32)
    s += red[(i / cg) * c + g * cg + i % cg];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(~0u, s, off);
  return s;
}

// Loads a thread's vectors of chunk `chunk` of sample `b`: zero where the
// row is past S.
template <typename T>
__device__ __forceinline__ int load(const T* x, uint4 (&v)[kVecs],
                                    const Place& p, int b, int chunk, int s,
                                    int c) {
  const int vpr = c / lanes<T>();
  const uint4* xb =
      reinterpret_cast<const uint4*>(x + static_cast<long long>(b) * s * c);
  const int r0 = chunk * p.rows;
  const int nrows = min(p.rows, s - r0);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int r = p.rt + k * p.pass;
    v[k] = p.on && r < nrows ? __ldg(xb + (r0 + r) * vpr + p.j) : uint4{};
  }
  return nrows;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ x, float4* __restrict__ part, int s,
                 int c, int groups) {
  constexpr int W = lanes<T>();
  __shared__ float red[kThreads * W];  // (pass, C): a row of sums a thread
  __shared__ float gmean[kMaxGroups];
  const Place p = place<T>(c);
  const int b = blockIdx.y, chunk = blockIdx.x, cg = c / groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint4 v[kVecs];
  const int nrows = load(x, v, p, b, chunk, s, c);

  float acc[W];
#pragma unroll
  for (int e = 0; e < W; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
#pragma unroll
    for (int e = 0; e < W; ++e) acc[e] += elem(v[k], e, T{});
  if (p.on) {
#pragma unroll
    for (int e = 0; e < W; ++e) red[threadIdx.x * W + e] = acc[e];
  }
  __syncthreads();
  const float count = static_cast<float>(nrows) * cg;
  for (int g = warp; g < groups; g += kWarps) {
    const float sum = group_sum(red, g, cg, c, p.pass);
    if (lane == 0) gmean[g] = sum / count;
  }
  __syncthreads();

  // second pass over the registers: squared deviations from the chunk's
  // group means, rows past S left out
  float mu[W];
#pragma unroll
  for (int e = 0; e < W; ++e) {
    mu[e] = gmean[(p.j * W + e) / cg];
    acc[e] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (p.rt + k * p.pass >= nrows) continue;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float d = elem(v[k], e, T{}) - mu[e];
      acc[e] += d * d;
    }
  }
  // every read of `red` above came before the last barrier
  if (p.on) {
#pragma unroll
    for (int e = 0; e < W; ++e) red[threadIdx.x * W + e] = acc[e];
  }
  __syncthreads();
  for (int g = warp; g < groups; g += kWarps) {
    const float m2 = group_sum(red, g, cg, c, p.pass);
    if (lane == 0)
      part[(static_cast<long long>(b) * gridDim.x + chunk) * groups + g] =
          make_float4(count, gmean[g], m2, 0.0f);
  }
}

// `part` holds the partials of `ranks` shards, (ranks, B, chunks, G): the
// sample's statistics are those of all of them; `stats`, where not null,
// takes (mean, rstd) a sample and group (B, G), from the first chunk's
// blocks
template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, const float4* __restrict__ part,
                 int ranks, const float* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ out,
                 float2* __restrict__ stats, int s, int c, int groups,
                 float eps) {
  constexpr int W = lanes<T>();
  __shared__ float gmean[kMaxGroups];
  __shared__ float grstd[kMaxGroups];
  const Place p = place<T>(c);
  const int b = blockIdx.y, chunk = blockIdx.x, cg = c / groups;
  const int chunks = gridDim.x, batch = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint4 v[kVecs];  // the loads are in flight while the partials merge
  const int nrows = load(x, v, p, b, chunk, s, c);

  // the sample's statistics from every shard's partials, in a fixed order
  for (int g = warp; g < groups; g += kWarps) {
    float n = 0.0f, mean = 0.0f, m2 = 0.0f;
    for (int q = lane; q < ranks * chunks; q += 32) {
      const float4 mq =
          part[((static_cast<long long>(q / chunks) * batch + b) * chunks +
                q % chunks) * groups + g];
      merge(n, mean, m2, mq.x, mq.y, mq.z);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_down_sync(~0u, n, off);
      const float mb = __shfl_down_sync(~0u, mean, off);
      const float m2b = __shfl_down_sync(~0u, m2, off);
      merge(n, mean, m2, nb, mb, m2b);
    }
    if (lane == 0) {
      gmean[g] = mean;
      grstd[g] = __frsqrt_rn(__fadd_rn(__fdiv_rn(m2, n), eps));
      if (stats != nullptr && chunk == 0)
        stats[b * groups + g] = make_float2(gmean[g], grstd[g]);
    }
  }
  __syncthreads();

  float mu[W], rs[W], wt[W], bs[W];
#pragma unroll
  for (int e = 0; e < W; ++e) {
    const int ch = p.j * W + e;
    mu[e] = gmean[ch / cg];
    rs[e] = grstd[ch / cg];
    wt[e] = __ldg(w + ch);
    bs[e] = __ldg(bias + ch);
  }
  const int vpr = c / W;
  uint4* ob =
      reinterpret_cast<uint4*>(out + static_cast<long long>(b) * s * c);
  const int r0 = chunk * p.rows;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int r = p.rt + k * p.pass;
    if (!p.on || r >= nrows) continue;
    uint4 o;
    T* ov = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      float y = __fmul_rn(__fsub_rn(elem(v[k], e, T{}), mu[e]), rs[e]);
      y = __fadd_rn(__fmul_rn(y, wt[e]), bs[e]);
      if (SILU) y = silu(y);
      ov[e] = from_f32<T>(y);
    }
    ob[(r0 + r) * vpr + p.j] = o;
  }
}

int element_lanes(int dtype) {
  return dtype == BDM_BF16 ? lanes<__nv_bfloat16>() : lanes<float>();
}

// The chunks a sample is split into, or 0 where the kernels do not take
// (S, C, G, dtype)
int chunks_of(int s, int c, int groups, int dtype) {
  if (dtype != BDM_F32 && dtype != BDM_BF16) return 0;
  const int w = element_lanes(dtype);
  if (s < 1 || c < 1 || groups < 1 || groups > kMaxGroups || c % groups ||
      c % w || c / w > kThreads ||
      static_cast<long long>(s) * c >= (1LL << 31))
    return 0;
  const int rows = kThreads / (c / w) * kVecs;
  return (s + rows - 1) / rows;
}

template <typename T>
int launch_stats(const void* x, float4* part, int batch, int s, int c,
                 int groups, cudaStream_t stream) {
  const dim3 grid(chunks_of(s, c, groups, sizeof(T) == 2 ? BDM_BF16 : BDM_F32),
                  batch);
  stats_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                 part, s, c, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply(const void* x, const float4* part, int ranks, const float* w,
                 const float* bias, void* out, float2* stats, int batch,
                 int s, int c, int groups, float eps, bool silu,
                 cudaStream_t stream) {
  const dim3 grid(chunks_of(s, c, groups, sizeof(T) == 2 ? BDM_BF16 : BDM_F32),
                  batch);
  const auto* xt = static_cast<const T*>(x);
  auto* ot = static_cast<T*>(out);
  if (silu)
    apply_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xt, part, ranks, w, bias, ot, stats, s, c, groups, eps);
  else
    apply_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xt, part, ranks, w, bias, ot, stats, s, c, groups, eps);
  return static_cast<int>(cudaGetLastError());
}

bool refused(int batch, int s, int c, int groups, int dtype) {
  return batch < 0 || batch > 65535 || chunks_of(s, c, groups, dtype) == 0;
}

}  // namespace

// The split, which the wrapper mirrors (`groupnorm.chunks`): chunks a
// sample, 0 where the kernels refuse the shape
BDM_EXPORT int bdm_groupnorm_chunks(int s, int c, int groups, int dtype) {
  return chunks_of(s, c, groups, dtype);
}

// x (B, S, C) of `dtype` (0 float32, 1 bf16), contiguous and 16-byte
// aligned; part a float32 scratch of B * chunks * G * 4: (n, mean, M2)
BDM_EXPORT int bdm_groupnorm_stats(const void* x, void* part, int batch,
                                   int s, int c, int groups, int dtype,
                                   cudaStream_t stream) {
  if (refused(batch, s, c, groups, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  auto* pt = static_cast<float4*>(part);
  return dtype == BDM_BF16
             ? launch_stats<__nv_bfloat16>(x, pt, batch, s, c, groups, stream)
             : launch_stats<float>(x, pt, batch, s, c, groups, stream);
}

// x, out (B, S, C) of `dtype`; part the partials of `ranks` shards of
// the same S, (ranks, B, chunks, G, 4); w, bias (C,) float32; stats null
// or a float32 (B, G, 2) for (mean, rstd)
BDM_EXPORT int bdm_groupnorm_apply(const void* x, const void* part, int ranks,
                                   const float* w, const float* bias,
                                   void* out, void* stats, int batch, int s,
                                   int c, int groups, float eps, int silu,
                                   int dtype, cudaStream_t stream) {
  if (refused(batch, s, c, groups, dtype) || ranks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const auto* pt = static_cast<const float4*>(part);
  auto* st = static_cast<float2*>(stats);
  if (dtype == BDM_BF16)
    return launch_apply<__nv_bfloat16>(x, pt, ranks, w, bias, out, st, batch,
                                       s, c, groups, eps, silu != 0, stream);
  return launch_apply<float>(x, pt, ranks, w, bias, out, st, batch, s, c,
                             groups, eps, silu != 0, stream);
}

// Both kernels of an unsharded norm in one call: the sampling step is
// paced by the host, which pays each ctypes call
BDM_EXPORT int bdm_groupnorm(const void* x, const float* w, const float* bias,
                             void* out, void* part, void* stats, int batch,
                             int s, int c, int groups, float eps, int silu,
                             int dtype, cudaStream_t stream) {
  const int err = bdm_groupnorm_stats(x, part, batch, s, c, groups, dtype,
                                      stream);
  if (err != static_cast<int>(cudaSuccess)) return err;
  return bdm_groupnorm_apply(x, part, 1, w, bias, out, stats, batch, s, c,
                             groups, eps, silu, dtype, stream);
}
