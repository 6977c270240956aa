// K2 pool_bnact: prologue (BN-apply + activation) on load, then a max
// over a (1, 2, 2) or (2, 2, 2) window, stored in the activation dtype.
// The raw input stays the level's skip; the wrapper passes it on with
// its (inv, shift) and never copies it.
//
// Replaces these TPU kernels of the JAX package:
//   ops/flat_fused.py::pool_bnact_flat_skip      (_pool_fwd_kernel)
//   ops/flat_fused64.py::pool222_bnact_flat64_skip (_pool64_fwd_kernel)
//
// What bounds it on the card: device-memory bandwidth. It reads every
// input byte once and writes 1/4 or 1/8 of that; each thread moves
// 16-byte vectors of 8 channels, and a warp's lanes walk neighbouring
// output voxels.
//
// In the per-sample mode (group and instance norm) inv/shift are rows of
// (n, c), one a sample, and a thread reads the row of its output voxel's
// sample (pro_ns = c; 0 for the batch form).
//
// The max is taken over the PROLOGUED float32 values, not the raw ones
// (a negative batch-norm scale reverses the order). Rounding the max to
// the activation dtype equals taking the max of rounded values, since
// rounding is monotone.
#include <math_constants.h>

#include "common.cuh"
#include "ps_reduce.cuh"

namespace {

using namespace e3;

template <typename T>
__global__ void __launch_bounds__(256) pool_bnact_kernel(
    const T* __restrict__ x, const float* __restrict__ inv,
    const float* __restrict__ shift, int pro_ns, T* __restrict__ y, int n,
    int d, int h, int w, int c, int pd, int act) {
  const int dout = d / pd;
  const int ho = h / 2;
  const int wo = w / 2;
  const int cg = c / 8;
  const int64_t total = (int64_t)n * dout * ho * wo * cg;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int g = (int)(idx % cg);
    int64_t t = idx / cg;
    const int ow = (int)(t % wo);
    t /= wo;
    const int oh = (int)(t % ho);
    t /= ho;
    const int od = (int)(t % dout);
    const int64_t on = t / dout;
    float sc[8], sh[8], m[8], v[8];
    const int64_t pc = on * pro_ns + g * 8;   // the sample's row, group g
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j] = inv[pc + j];
      sh[j] = shift[pc + j];
      m[j] = -CUDART_INF_F;
    }
    for (int dz = 0; dz < pd; ++dz) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int64_t pos =
              ((on * d + od * pd + dz) * h + 2 * oh + dy) * w + 2 * ow + dx;
          load8(x + pos * c + g * 8, v);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            m[j] = fmaxf(m[j], prologue(v[j], sc[j], sh[j], act));
        }
      }
    }
    // The output is laid out in the same (n, d, h, w, channel group)
    // order as idx enumerates it.
    store8(y + idx * 8, m);
  }
}

// K6 pool_bnact_bwd. It recomputes each window's prologued float32
// values and their max, and routes dpool to EVERY element equal to the
// max (the JAX kernels' tie rule, flat_fused.py:42-45; torch's pool picks
// one), then applies act', the prologue's gradients and the cotangent of
// the level's skip (the raw x itself, JAX's with_skip: the decoder's
// gradient of x is summed here, not by a separate add):
//   dpre = dpool * [a == max] * act'(pre),
//   dx = round(dpre * inv + dskip)  (__fmul_rn, then __fadd_rn: the
//        plain version's two roundings, so dx is bitwise equal to it),
//   dinv = sum(dpre * x),  dshift = sum(dpre).
// Replaces flat_fused.py::_pool_bwd_impl (_pool_bwd_kernel, with_skip),
// flat_fused64.py::_pool64_bwd_impl and ::_pool122_bwd_impl.
//
// What bounds it on the card: the bytes of x, dskip and dx (each once)
// and dpool; about 10 float32 operations an element. The design:
//   - two lanes per (pooled voxel, group of 8 channels), one per window
//     column: lane (v, g, dx) reads x at columns 2 ow + dx of its window
//     rows, so a warp's loads of x and dskip and its stores of dx are
//     contiguous runs over the channels of neighbouring voxels; the two
//     lanes' maxima meet by one shuffle;
//   - each element of x (and of dskip) is loaded once, all of a window
//     column's together, and kept in registers from the max to the
//     routing;
//   - a persistent grid (as many blocks as fit the SMs); a thread keeps
//     one channel group over all its items (the grid's thread count is a
//     multiple of 2 C / 8), so dinv and dshift stay in registers: then
//     shuffles over the lanes of a warp that hold the same group, shared
//     memory, and one device atomic per channel and block;
//   - 32-bit index arithmetic (pooled voxels < 2^30), 64-bit offsets.
// The per-sample mode (an (n, c) prologue, read by the sample stride
// pro_ns): the grid is (blocks of a sample, sample), its blocks a number
// set by the sample's shape alone (about 16 items a thread), each block
// walks its sample's pooled voxels only and sums its shares in a fixed
// order (the shuffles, then its warps in turn) into its partial row of
// dinv and dshift, slot blockIdx.x of sample blockIdx.y; ps_reduce
// (ps_reduce.cuh) sums a sample's rows in a fixed order. No float atomic
// touches them, so they are the same bits on every run.
constexpr int kPoolBwdMaxC = 512;  // channels the block sums can hold

// 8 channels of T as loaded, widened to float32 where used: bf16 keeps
// them in 4 registers, not 8.
template <typename T>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Raw8<float> {
  float4 a, b;
};

__device__ __forceinline__ void load_raw8(const __nv_bfloat16* p,
                                          Raw8<__nv_bfloat16>& r) {
  r.u = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void load_raw8(const float* p, Raw8<float>& r) {
  r.a = *reinterpret_cast<const float4*>(p);
  r.b = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& r,
                                        float* v) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&r.u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void unpack8(const Raw8<float>& r, float* v) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

template <typename T, int PD>
__global__ void __launch_bounds__(256, 2) pool_bnact_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ inv,
    const float* __restrict__ shift, int pro_ns, const T* __restrict__ dpool,
    const T* __restrict__ dskip, T* __restrict__ dx,
    float* __restrict__ dinv, float* __restrict__ dshift,
    float* __restrict__ part, int npv, int h, int w, int c, int act) {
  __shared__ float s_red[2][kPoolBwdMaxC];
  for (int i = threadIdx.x; i < 2 * c; i += blockDim.x)
    s_red[i / c][i % c] = 0.0f;
  const int ho = h / 2;
  const int wo = w / 2;
  const int cg = c / 8;
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int col = t & 1;                       // the window column
  const int g = (t >> 1) % cg;                 // the channel group
  const int pstep = gridDim.x * blockDim.x / (2 * cg);
  // The per-sample grid: blockIdx.y is the sample, npv its pooled voxels,
  // which start at pvb; the batch form has one sample of them all.
  const int pvb = (int)blockIdx.y * npv;
  const int64_t pc = (int64_t)blockIdx.y * pro_ns + g * 8;
  float sc[8], sh[8], gi[8], gs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = inv[pc + j];
    sh[j] = shift[pc + j];
    gi[j] = 0.0f;
    gs[j] = 0.0f;
  }
  constexpr int NE = 2 * PD;                   // a lane's window elements
  // The warp walks its pooled voxels in lockstep (the shuffles need every
  // lane): its first lane's voxel sets the trip count, and a lane past
  // npv loads and stores nothing.
  const int pv0 = t / (2 * cg);
  const int wpv0 = (t & ~31) / (2 * cg);
  const int64_t rowc = (int64_t)w * c;         // an input row's elements
  const int64_t planec = h * rowc;             // an input plane's
  for (int k = 0; wpv0 + k * pstep < npv; ++k) {
    const int pl = pv0 + k * pstep;            // of the sample
    const bool ok = pl < npv;
    const int pv = pvb + pl;
    // Element e = (dz, dy) of this lane's window column at base + dz
    // planec + dy rowc.
    int64_t base = 0;
    Raw8<T> raw[NE], skr[NE];   // x and, with dskip, the skip's cotangent
    Raw8<T> dpr;
    float m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = -CUDART_INF_F;
    if (ok) {
      // pv = (nd_out * ho + oh) * wo + ow; the window's first input row
      // is (PD nd_out) h + 2 oh.
      const int pr = pv / wo;
      const int ow = pv - pr * wo;
      const int ndo = pr / ho;
      const int oh = pr - ndo * ho;
      base = ((int64_t)PD * ndo * h + 2 * oh) * rowc
          + (int64_t)(2 * ow + col) * c + g * 8;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int64_t off = base + (e / 2) * planec + (e % 2) * rowc;
        load_raw8(x + off, raw[e]);
        if (dskip != nullptr) load_raw8(dskip + off, skr[e]);
      }
      load_raw8(dpool + (int64_t)pv * c + g * 8, dpr);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        float v[8];
        unpack8(raw[e], v);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          m[j] = fmaxf(m[j], prologue(v[j], sc[j], sh[j], act));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], 1));
    if (!ok) continue;
    float dp[8];
    unpack8(dpr, dp);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int64_t off = base + (e / 2) * planec + (e % 2) * rowc;
      float v[8], sk[8], r[8];
      unpack8(raw[e], v);
      if (dskip != nullptr) unpack8(skr[e], sk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pre = pre_act(v[j], sc[j], sh[j]);
        const float sel = act_fwd(pre, act) == m[j] ? dp[j] : 0.0f;
        const float dpre = sel * act_grad(pre, act);
        r[j] = __fmul_rn(dpre, sc[j]);
        if (dskip != nullptr) r[j] = __fadd_rn(r[j], sk[j]);
        gi[j] = fmaf(dpre, v[j], gi[j]);
        gs[j] += dpre;
      }
      store8(dx + off, r);
    }
  }
  // The block's sums: the lanes of a warp that hold group g (the two
  // columns, then the pooled voxels: lane bits 0 and log2(2 cg) up),
  // then shared memory, then one device atomic per channel.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    gi[j] += __shfl_xor_sync(0xffffffffu, gi[j], 1);
    gs[j] += __shfl_xor_sync(0xffffffffu, gs[j], 1);
  }
  for (int off = 2 * cg; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      gi[j] += __shfl_xor_sync(0xffffffffu, gi[j], off);
      gs[j] += __shfl_xor_sync(0xffffffffu, gs[j], off);
    }
  }
  __syncthreads();   // s_red's initialization is visible
  if (part != nullptr) {
    // The per-sample mode: the warps in turn (a warp's lanes col == 0,
    // lane < 2 cg hold distinct groups), then the partial row.
    for (int wi = 0; wi < (int)blockDim.x / 32; ++wi) {
      if ((int)threadIdx.x / 32 == wi && col == 0 && lane < 2 * cg) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s_red[0][g * 8 + j] += gi[j];
          s_red[1][g * 8 + j] += gs[j];
        }
      }
      __syncthreads();
    }
    float* const row =
        part + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * c;
    for (int i = threadIdx.x; i < 2 * c; i += blockDim.x)
      row[i] = s_red[i / c][i % c];
    return;
  }
  if (col == 0 && lane < 2 * cg) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      atomicAdd(&s_red[0][g * 8 + j], gi[j]);
      atomicAdd(&s_red[1][g * 8 + j], gs[j]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    atomicAdd(dinv + i, s_red[0][i]);
    atomicAdd(dshift + i, s_red[1][i]);
  }
}

int pool_blocks(int64_t total) {
  const int64_t want = (total + 255) / 256;
  return (int)(want < (1 << 20) ? (want > 0 ? want : 1) : (1 << 20));
}

int pool_sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

// The per-sample grid's blocks a sample of ``spv`` pooled voxels: about
// 16 items a thread, set by the sample's shape alone.
int64_t pool_bwd_ps_blocks(int64_t spv, int c) {
  const int64_t items = spv * 2 * (c / 8);
  const int64_t blocks = (items + 16 * 256 - 1) / (16 * 256);
  return blocks > 0 ? blocks : 1;
}

// K6's persistent grid: as many blocks as fit the SMs, and no more than
// one item a thread; in the per-sample mode (``part``) the grid of
// pool_bwd_ps_blocks blocks a sample by ``n`` samples of ``npv`` pooled
// voxels each.
template <typename T, int PD>
cudaError_t pool_bwd_launch(const void* x, const float* inv,
                            const float* shift, int pro_ns,
                            const void* dpool, const void* dskip, void* dx,
                            float* dinv, float* dshift, float* part, int n,
                            int npv, int h, int w, int c, int act,
                            cudaStream_t s) {
  auto kern = pool_bnact_bwd_kernel<T, PD>;
  static int per_sm = 0;   // resident blocks an SM, per instantiation
  if (per_sm == 0) {
    cudaError_t rc =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 256, 0);
    if (rc != cudaSuccess) return rc;
    if (per_sm < 1) per_sm = 1;
  }
  int64_t blocks;
  if (part != nullptr) {
    blocks = pool_bwd_ps_blocks(npv, c);
  } else {
    const int64_t items = (int64_t)npv * 2 * (c / 8);
    blocks = (int64_t)per_sm * pool_sm_count();
    if (blocks > (items + 255) / 256) blocks = (items + 255) / 256;
    if (blocks < 1) blocks = 1;
  }
  const dim3 grid((unsigned)blocks, part != nullptr ? n : 1);
  kern<<<grid, 256, 0, s>>>(
      static_cast<const T*>(x), inv, shift, pro_ns,
      static_cast<const T*>(dpool), static_cast<const T*>(dskip),
      static_cast<T*>(dx), dinv, dshift, part, npv, h, w, c, act);
  return cudaGetLastError();
}

}  // namespace

// K2. ``pro_ns``: c for inv/shift of (n, c) (the per-sample mode), 0
// for (c,).
extern "C" int e3_pool_bnact(int dtype, const void* x, const float* inv,
                             const float* shift, int pro_ns, void* y, int n,
                             int d, int h, int w, int c, int pd, int act,
                             void* stream) {
  const int64_t total = (int64_t)n * (d / pd) * (h / 2) * (w / 2) * (c / 8);
  const int blocks = pool_blocks(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == e3::DT_BF16)
    pool_bnact_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), inv, shift, pro_ns,
        static_cast<__nv_bfloat16*>(y), n, d, h, w, c, pd, act);
  else
    pool_bnact_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(x), inv, shift, pro_ns,
        static_cast<float*>(y), n, d, h, w, c, pd, act);
  return static_cast<int>(cudaGetLastError());
}

// The per-sample mode's partial rows a sample (ps_reduce.cuh): the
// blocks of a sample of K6's per-sample grid.
extern "C" int64_t e3_pool_bnact_bwd_ps_parts(int d, int h, int w, int c,
                                              int pd) {
  return pool_bwd_ps_blocks((int64_t)(d / pd) * (h / 2) * (w / 2), c);
}

// K6. ``dskip`` (x's shape) is the skip's cotangent, or null for none.
// ``inv``/``shift`` are (c,), or per sample (n, c) with ``pro_ns`` = c and
// a workspace ``ws`` (ps_workspace_floats of n samples,
// e3_pool_bnact_bwd_ps_parts rows of 2 c): dinv and dshift then come per
// sample, in a fixed order, as (n, 2, c) in ``dinv`` (``dshift`` unused);
// else they are zeroed by the caller. Needs c / 8 dividing 256 (a thread
// keeps one channel group), c <= kPoolBwdMaxC (the block sums) and fewer
// than 2^30 pooled voxels (32-bit indices).
extern "C" int e3_pool_bnact_bwd(int dtype, const void* x, const float* inv,
                                 const float* shift, int pro_ns,
                                 const void* dpool, const void* dskip,
                                 void* dx, float* dinv, float* dshift,
                                 float* ws, int n, int d, int h, int w,
                                 int c, int pd, int act, void* stream) {
  const int64_t npv = (int64_t)n * (d / pd) * (h / 2) * (w / 2);
  if (c < 8 || c % 8 || c > kPoolBwdMaxC || 256 % (c / 8) != 0
      || (pd != 1 && pd != 2) || npv >= ((int64_t)1 << 30)
      || (ws != nullptr && (n > 65535 || pro_ns != c)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (npv == 0) return static_cast<int>(cudaSuccess);
  // The per-sample grid walks one sample's pooled voxels a block.
  const int nv = ws != nullptr ? (int)(npv / n) : (int)npv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (dtype == e3::DT_BF16)
    rc = pd == 1 ? pool_bwd_launch<__nv_bfloat16, 1>(
                       x, inv, shift, pro_ns, dpool, dskip, dx, dinv,
                       dshift, ws, n, nv, h, w, c, act, s)
                 : pool_bwd_launch<__nv_bfloat16, 2>(
                       x, inv, shift, pro_ns, dpool, dskip, dx, dinv,
                       dshift, ws, n, nv, h, w, c, act, s);
  else
    rc = pd == 1 ? pool_bwd_launch<float, 1>(
                       x, inv, shift, pro_ns, dpool, dskip, dx, dinv,
                       dshift, ws, n, nv, h, w, c, act, s)
                 : pool_bwd_launch<float, 2>(
                       x, inv, shift, pro_ns, dpool, dskip, dx, dinv,
                       dshift, ws, n, nv, h, w, c, act, s);
  if (rc == cudaSuccess && ws != nullptr)
    rc = e3::ps_reduce(ws, n, e3_pool_bnact_bwd_ps_parts(d, h, w, c, pd),
                       2 * c, dinv, s);
  return static_cast<int>(rc);
}
