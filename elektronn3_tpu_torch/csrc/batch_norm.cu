// K8-K11: the standalone batch norm of the 'batchp' normalization, on a
// channels-last activation seen as rows: x is (R, C), channels minor,
// R = N * D * H * W, in float32 or bfloat16, C % 8 == 0, C <= 2048.
//
//   K8  bn_stats       one launch: the per-channel float32 sums of x and
//                      x^2 over the rows, then the forward's glue: out
//                      (5, C) = mean, var = max(E[x^2] - mean^2, 0),
//                      inv = rsqrt(var + eps), scale = gamma * inv,
//                      shift = beta - mean * scale; given the running
//                      buffers, also ra = (1 - m) * ra + m * batch for
//                      the mean and the clamped var, in place
//   K9  bn_normalize   y = x * scale + shift in float32, rounded once to
//                      x's dtype
//   K10 bn_bwd_reduce  one launch: the per-channel float32 sums of g and
//                      g * xhat, xhat = (x - mean) * inv, inv = rsqrt(var
//                      + eps), then the backward's glue: out (5, C) = a =
//                      gamma * inv, b = -a * inv * sum(g xhat) / R, c =
//                      -a * sum(g) / R - b * mean, dgamma = sum(g xhat),
//                      dbeta = sum(g)
//   K11 bn_bwd_dx      dx = a * g + b * x + c in float32, rounded once to
//                      g's dtype
//
// Replaces these TPU kernels of the JAX package (ops/pallas_bn.py):
//   K8  _bn_stats      (_stats_kernel), and the XLA glue of _bn_fwd_impl
//   K9  _bn_normalize  (_normalize_kernel; also batch_norm_inference)
//   K10 _bn_bwd        (_bwd_reduce_kernel), and the XLA glue after it
//   K11 _bn_bwd        (_bwd_dx_kernel)
//
// What bounds them on the card: device-memory bandwidth. Each reads its
// (R, C) operands once (K8 one, K10 two) and K9/K11 write one; the
// arithmetic is a few float32 operations per element. Every thread moves
// 8 channels as one 16-byte vector (two for float32), and a warp's lanes
// walk neighbouring vectors of consecutive rows: at C = 32 a bfloat16 row
// is 64 bytes, 4 threads, so a warp reads 8 rows at once. Below about a
// million elements a call is bound by its launch and the host, so K8 and
// K10 are one launch each, with the glue in the kernel's last step.
//
// K8 and K10 (bn_reduce_kernel): a persistent grid of thread-block
// clusters, sized by the wrapper's plan to the card's SMs (one block an
// SM), in which block b streams the contiguous rows [b * rpb, (b + 1) *
// rpb). Each thread keeps 2 x kBytesInFlight of 16-byte vector loads in
// flight: a batch of rows is loaded while the last is summed. Measured
// on an H100 (bf16 device time, bn_reduce_sweep.py's shapes) against a
// variant of this kernel that fed the same sums from 1-D cp.async.bulk
// copies of whole row ranges into a 4-stage shared-memory ring under
// mbarriers: the ring was 0.7-1 us slower at the 'batchp' steps' shapes
// (bench L2 14.2 against 13.5 us, L3 9.4 against 8.5), where a call's
// fixed costs weigh most, and 5-10% faster only at 2.7M rows (66.3
// against 73.3 us), so the vector loads stay. Two blocks an SM ran the
// grid in two waves (a cluster of 8 lives in one GPC): 19.0 against
// 13.5 us at bench L2. Each thread sums its rows in row order; the
// block sums its threads' partials in shared memory; the blocks of a
// cluster sum their block partials through distributed shared memory
// in rank order, each rank a slice of the channels. A plan of one
// cluster ends there: its ranks apply the glue. Otherwise each cluster
// writes its partial into the workspace, and the last cluster to
// arrive (an atomic ticket, which it resets to 0 for the next call)
// sums the cluster partials in cluster order and applies the glue. The
// workspace (ticket and partials) is allocated once per device and
// stream by the wrapper.
//
// The same bits on every run: every sum is taken in an order that the
// plan fixes (rows, threads, blocks of a cluster, clusters), never in
// the order in which blocks arrive, and the plan is a function of (R, C)
// and the card's SM count alone.
//
// Rounding: the glue, K9 and K11 multiply, add and divide with separate
// roundings, in the plain PyTorch version's order, so that the two agree
// to the last bits of the sums (rsqrt is correctly rounded here; the
// card's torch.rsqrt is within 2 ulps of it). xhat in K10 likewise.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using namespace e3;
namespace cg = cooperative_groups;

constexpr int kThreads = 256;        // threads of a block
constexpr int kBytesInFlight = 128;  // per thread, twice over
constexpr int kRedBytes = 2 * kThreads * 8 * 4;  // per-thread partials

// 8 channels of a row as loaded: one 16-byte vector of bfloat16, two of
// float32.
template <typename T>
struct Raw {
  uint4 v[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Raw<T> load_raw(const T* p) {
  Raw<T> r;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
    r.v[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  return r;
}

__device__ __forceinline__ void unpack(const Raw<float>& r, float* v) {
  const float* f = reinterpret_cast<const float*>(r.v);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = f[j];
}
__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& r,
                                       float* v) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(r.v);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct ReduceArgs {
  const void* x;
  const void* g;          // K10's cotangent
  const float* mean;      // K10
  const float* var;       // K10
  const float* gamma;
  const float* beta;      // K8
  float* ra_mean;         // K8's running buffers, or null
  float* ra_var;
  float eps, momentum, one_minus_m;
  unsigned int* ticket;   // the workspace (plans of more than one cluster)
  float* partials;        // (clusters, 2, c)
  float* out;             // (5, c)
  int64_t rows;
  int c, rows_per_block, nclusters;
};

// The glue of channel ch from its two float32 sums, in the plain
// version's order (ops/pallas_bn.py bn_stats_plain, bn_bwd_reduce_plain).
template <bool kBwd>
__device__ __forceinline__ void epilogue(const ReduceArgs& p, int ch,
                                         float s1, float s2) {
  const int c = p.c;
  const float rf = (float)p.rows;
  if constexpr (kBwd) {
    const float inv = __frsqrt_rn(__fadd_rn(p.var[ch], p.eps));
    const float a = __fmul_rn(p.gamma[ch], inv);
    const float b = __fdiv_rn(__fmul_rn(__fmul_rn(-a, inv), s2), rf);
    p.out[ch] = a;
    p.out[c + ch] = b;
    p.out[2 * c + ch] = __fsub_rn(__fdiv_rn(__fmul_rn(-a, s1), rf),
                                  __fmul_rn(b, p.mean[ch]));
    p.out[3 * c + ch] = s2;
    p.out[4 * c + ch] = s1;
  } else {
    const float mean = __fdiv_rn(s1, rf);
    float var = __fsub_rn(__fdiv_rn(s2, rf), __fmul_rn(mean, mean));
    var = var < 0.0f ? 0.0f : var;
    const float inv = __frsqrt_rn(__fadd_rn(var, p.eps));
    const float scale = __fmul_rn(p.gamma[ch], inv);
    p.out[ch] = mean;
    p.out[c + ch] = var;
    p.out[2 * c + ch] = inv;
    p.out[3 * c + ch] = scale;
    p.out[4 * c + ch] = __fsub_rn(p.beta[ch], __fmul_rn(mean, scale));
    if (p.ra_mean != nullptr) {
      p.ra_mean[ch] = __fadd_rn(__fmul_rn(p.one_minus_m, p.ra_mean[ch]),
                                __fmul_rn(p.momentum, mean));
      p.ra_var[ch] = __fadd_rn(__fmul_rn(p.one_minus_m, p.ra_var[ch]),
                               __fmul_rn(p.momentum, var));
    }
  }
}

// Add one row's 8 channels to a thread's sums: K8 (x, x^2), K10 (g,
// g * xhat).
template <typename T, bool kBwd>
__device__ __forceinline__ void accumulate(const Raw<T>& xr,
                                           const Raw<T>& gr, const float* m,
                                           const float* iv, float* a1,
                                           float* a2) {
  float v[8];
  unpack(xr, v);
  if constexpr (kBwd) {
    float gv[8];
    unpack(gr, gv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xhat = __fmul_rn(__fsub_rn(v[j], m[j]), iv[j]);
      a1[j] += gv[j];
      a2[j] = fmaf(gv[j], xhat, a2[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a1[j] += v[j];
      a2[j] = fmaf(v[j], v[j], a2[j]);
    }
  }
}

// Shared memory: [per-thread partials kRedBytes][block partial 2c
// floats][parts kThreads floats][flag].
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads) bn_reduce_kernel(
    const ReduceArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kOps = kBwd ? 2 : 1;
  const int c = p.c;
  float* s_red = reinterpret_cast<float*>(smem);
  float* s_part = s_red + 2 * kThreads * 8;
  float* s_tmp = s_part + 2 * c;
  int* s_flag = reinterpret_cast<int*>(s_tmp + kThreads);

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / cs;
  const int t = threadIdx.x;
  const int cg8 = c / 8;
  const int rpp = kThreads / cg8;      // rows a block reads at once
  const int grp = t % cg8;
  const int sub = t / cg8;
  const bool active = sub < rpp;
  const int64_t r0 = (int64_t)blockIdx.x * p.rows_per_block;
  const int64_t r1 = min64(r0 + p.rows_per_block, p.rows);
  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.g);

  float a1[8], a2[8], m[8], iv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a1[j] = 0.0f;
    a2[j] = 0.0f;
    m[j] = 0.0f;
    iv[j] = 0.0f;
  }
  if constexpr (kBwd) {
    if (active) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m[j] = p.mean[grp * 8 + j];
        iv[j] = __frsqrt_rn(__fadd_rn(p.var[grp * 8 + j], p.eps));
      }
    }
  }

  // Rows r0 + sub, + rpp, ...: U of them loaded before any is summed,
  // and the next U loaded while these are summed.
  constexpr int U = kBytesInFlight / (8 * (int)sizeof(T) * kOps);
  const int64_t step = (int64_t)U * rpp;
  auto load_batch = [&](int64_t rb, Raw<T>* xa, Raw<T>* ga) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t r = rb + (int64_t)u * rpp;
      if (r < r1) {
        xa[u] = load_raw(x + r * c + grp * 8);
        if constexpr (kBwd) ga[u] = load_raw(g + r * c + grp * 8);
      }
    }
  };
  if (active) {
    Raw<T> xr[U], gr[U];
    int64_t rb = r0 + sub;
    load_batch(rb, xr, gr);
    while (rb < r1) {
      Raw<T> xn[U], gn[U];
      if (rb + step < r1) load_batch(rb + step, xn, gn);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (rb + (int64_t)u * rpp < r1)
          accumulate<T, kBwd>(xr[u], gr[u], m, iv, a1, a2);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        xr[u] = xn[u];
        gr[u] = gn[u];
      }
      rb += step;
    }
  }

  // The block: per-thread partials [2][rpp][c], then each of the 2c
  // values summed over rpp in fixed parts and the parts in order.
  if (active) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s_red[(0 * rpp + sub) * c + grp * 8 + j] = a1[j];
      s_red[(1 * rpp + sub) * c + grp * 8 + j] = a2[j];
    }
  }
  __syncthreads();
  const int nv = 2 * c;
  const int parts = nv < kThreads ? kThreads / nv : 1;
  if (parts == 1) {
    for (int v = t; v < nv; v += kThreads) {
      const int k = v / c, ch = v % c;
      float s = 0.0f;
      for (int q = 0; q < rpp; ++q) s += s_red[(k * rpp + q) * c + ch];
      s_part[v] = s;
    }
  } else {
    const int per = (rpp + parts - 1) / parts;
    if (t < nv * parts) {
      const int v = t % nv, part = t / nv;
      const int k = v / c, ch = v % c;
      const int q1 = min(rpp, (part + 1) * per);
      float s = 0.0f;
      for (int q = part * per; q < q1; ++q)
        s += s_red[(k * rpp + q) * c + ch];
      s_tmp[part * nv + v] = s;
    }
    __syncthreads();
    if (t < nv) {
      float s = 0.0f;
      for (int part = 0; part < parts; ++part) s += s_tmp[part * nv + t];
      s_part[t] = s;
    }
  }

  // The cluster: rank ``rank`` sums its slice of the channels over the
  // cluster's blocks in rank order (distributed shared memory).
  cluster.sync();
  const int cpr = c / cs;
  const int ch0 = rank * cpr;
  for (int j = t; j < cpr; j += kThreads) {
    const int ch = ch0 + j;
    float s1 = 0.0f, s2 = 0.0f;
    for (int q = 0; q < cs; ++q) {
      const float* rp = cluster.map_shared_rank(s_part, q);
      s1 += rp[ch];
      s2 += rp[c + ch];
    }
    if (p.nclusters == 1) {
      epilogue<kBwd>(p, ch, s1, s2);
    } else {
      p.partials[(2 * (int64_t)cid) * c + ch] = s1;
      p.partials[(2 * (int64_t)cid + 1) * c + ch] = s2;
    }
  }
  if (p.nclusters == 1) {
    cluster.sync();   // no block leaves while another reads its partial
    return;
  }
  __threadfence();
  cluster.sync();
  if (rank == 0 && t == 0) {
    const unsigned int prev = atomicAdd(p.ticket, 1u);
    const int last = prev == (unsigned int)(p.nclusters - 1);
    if (last) *p.ticket = 0u;   // ready for the next call on this stream
    __threadfence();
    for (int q = 0; q < cs; ++q) *cluster.map_shared_rank(s_flag, q) = last;
  }
  cluster.sync();
  if (*s_flag) {
    // The last cluster: the cluster partials in cluster order.
    for (int j = t; j < cpr; j += kThreads) {
      const int ch = ch0 + j;
      float s1 = 0.0f, s2 = 0.0f;
      for (int k = 0; k < p.nclusters; ++k) {
        s1 += __ldcg(&p.partials[(2 * (int64_t)k) * c + ch]);
        s2 += __ldcg(&p.partials[(2 * (int64_t)k + 1) * c + ch]);
      }
      epilogue<kBwd>(p, ch, s1, s2);
    }
  }
}

template <typename T, bool kBwd>
cudaError_t launch_reduce(const ReduceArgs& p, int cs, int nblocks,
                          cudaStream_t stream) {
  // At most 16 KB + 16 KB (c = 2048) + 1 KB + 16 B, under the 48 KB that
  // needs no opt-in.
  const size_t smem =
      kRedBytes + sizeof(float) * (2 * p.c + kThreads) + 16;
  auto kern = bn_reduce_kernel<T, kBwd>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool kBwd>
int reduce(int dtype, ReduceArgs& p, void* ws, int cs, void* stream) {
  const int c = p.c;
  if (c < 8 || c % 8 != 0 || c > 2048 ||
      !(cs == 1 || cs == 2 || cs == 4 || cs == 8) || p.nclusters < 1 ||
      p.rows < 1 || p.rows_per_block < 1 ||
      (int64_t)p.nclusters * cs * p.rows_per_block < p.rows ||
      (p.nclusters > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  p.ticket = static_cast<unsigned int*>(ws);
  p.partials = ws ? reinterpret_cast<float*>(static_cast<char*>(ws) + 16)
                  : nullptr;
  const int nblocks = p.nclusters * cs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == DT_BF16
          ? launch_reduce<__nv_bfloat16, kBwd>(p, cs, nblocks, s)
          : launch_reduce<float, kBwd>(p, cs, nblocks, s));
}

// K9 (kDx false): out = x * p1 + p2. K11 (kDx true): out = p1 * g +
// p2 * x + p3. One 8-channel vector per thread and step, grid-stride.
template <typename T, bool kDx>
__global__ void __launch_bounds__(kThreads) bn_affine_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ p1, const float* __restrict__ p2,
    const float* __restrict__ p3, T* __restrict__ out, int64_t rows, int c) {
  const int cg = c / 8;
  const int64_t total = rows * cg;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int c0 = (int)(idx % cg) * 8;
    float v[8], r[8];
    load8(x + idx * 8, v);
    if constexpr (kDx) {
      float gv[8];
      load8(g + idx * 8, gv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r[j] = __fadd_rn(__fadd_rn(__fmul_rn(p1[c0 + j], gv[j]),
                                   __fmul_rn(p2[c0 + j], v[j])),
                         p3[c0 + j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r[j] = __fadd_rn(__fmul_rn(v[j], p1[c0 + j]), p2[c0 + j]);
    }
    store8(out + idx * 8, r);
  }
}

int affine_blocks(int64_t total) {
  const int64_t want = (total + kThreads - 1) / kThreads;
  return (int)(want < (1 << 20) ? (want > 0 ? want : 1) : (1 << 20));
}

template <bool kDx>
int affine(int dtype, const void* x, const void* g, const float* p1,
           const float* p2, const float* p3, void* out, int64_t rows, int c,
           void* stream) {
  if (c < 8 || c % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = affine_blocks(rows * (c / 8));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    bn_affine_kernel<__nv_bfloat16, kDx><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), p1, p2, p3,
        static_cast<__nv_bfloat16*>(out), rows, c);
  else
    bn_affine_kernel<float, kDx><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), p1, p2,
        p3, static_cast<float*>(out), rows, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8: out (5, c) float32 = mean, var, inv, scale, shift of the rows of x
// (see the header); ra_mean and ra_var (float32, c) get the running
// update in place unless null. ws is the workspace (a 16-byte ticket,
// zero between calls, then (nclusters, 2, c) float32 partials), null for
// a plan of one cluster. The grid is nclusters clusters of cs blocks;
// block b sums rows [b * rows_per_block, (b + 1) * rows_per_block).
extern "C" int e3_bn_stats(int dtype, const void* x, const float* gamma,
                           const float* beta, float eps, float* ra_mean,
                           float* ra_var, float momentum, float one_minus_m,
                           void* ws, float* out, int64_t rows, int c, int cs,
                           int nclusters, int rows_per_block, void* stream) {
  if ((ra_mean == nullptr) != (ra_var == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ReduceArgs p = {x, nullptr, nullptr, nullptr, gamma, beta, ra_mean,
                  ra_var, eps, momentum, one_minus_m, nullptr, nullptr, out,
                  rows, c, rows_per_block, nclusters};
  return reduce<false>(dtype, p, ws, cs, stream);
}

// K9: y = x * scale + shift.
extern "C" int e3_bn_normalize(int dtype, const void* x, const float* scale,
                               const float* shift, void* y, int64_t rows,
                               int c, void* stream) {
  return affine<false>(dtype, x, nullptr, scale, shift, nullptr, y, rows, c,
                       stream);
}

// K10: out (5, c) float32 = a, b, c (of dx = a g + b x + c), dgamma =
// sum g * xhat, dbeta = sum g, from the cotangent g and x (one shape and
// dtype), the batch mean and (clamped) var, gamma and eps; the plan and
// the workspace as K8's.
extern "C" int e3_bn_bwd_reduce(int dtype, const void* g, const void* x,
                                const float* mean, const float* var,
                                const float* gamma, float eps, void* ws,
                                float* out, int64_t rows, int c, int cs,
                                int nclusters, int rows_per_block,
                                void* stream) {
  ReduceArgs p = {x, g, mean, var, gamma, nullptr, nullptr, nullptr, eps,
                  0.0f, 0.0f, nullptr, nullptr, out, rows, c,
                  rows_per_block, nclusters};
  return reduce<true>(dtype, p, ws, cs, stream);
}

// K11: dx = a * g + b * x + c (per channel a, b, c).
extern "C" int e3_bn_bwd_dx(int dtype, const void* g, const void* x,
                            const float* a, const float* b, const float* cc,
                            void* dx, int64_t rows, int c, void* stream) {
  return affine<true>(dtype, x, g, a, b, cc, dx, rows, c, stream);
}
