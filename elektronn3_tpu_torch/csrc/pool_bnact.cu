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
// The max is taken over the PROLOGUED float32 values, not the raw ones
// (a negative batch-norm scale reverses the order). Rounding the max to
// the activation dtype equals taking the max of rounded values, since
// rounding is monotone.
#include <math_constants.h>

#include "common.cuh"

namespace {

using namespace e3;

template <typename T>
__global__ void __launch_bounds__(256) pool_bnact_kernel(
    const T* __restrict__ x, const float* __restrict__ inv,
    const float* __restrict__ shift, T* __restrict__ y, int n, int d,
    int h, int w, int c, int pd, int act) {
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
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j] = inv[g * 8 + j];
      sh[j] = shift[g * 8 + j];
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

// K6 pool_bnact_bwd: one thread per (pooled voxel, 8 channels), as in
// the forward. It recomputes the window's prologued float32 values and
// their max, and routes dpool to EVERY element equal to the max (the JAX
// kernels' tie rule, flat_fused.py:42-45; torch's pool picks one), then
// applies act' and the prologue's gradients:
//   dpre = dpool * [a == max] * act'(pre),  dx = dpre * inv (rounded),
//   dinv = sum(dpre * x),  dshift = sum(dpre).
// dinv and dshift are summed per thread (a thread keeps one channel
// group: the grid stride is a multiple of c / 8), then per block in
// shared memory, then with one float32 atomic per channel and block.
constexpr int kPoolBwdMaxC = 512;  // channels the block sums can hold

template <typename T>
__global__ void __launch_bounds__(256) pool_bnact_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ inv,
    const float* __restrict__ shift, const T* __restrict__ dpool,
    T* __restrict__ dx, float* __restrict__ dinv,
    float* __restrict__ dshift, int n, int d, int h, int w, int c, int pd,
    int act) {
  __shared__ float s_red[2][kPoolBwdMaxC];
  for (int i = threadIdx.x; i < 2 * c; i += blockDim.x)
    s_red[i / c][i % c] = 0.0f;
  __syncthreads();
  const int dout = d / pd;
  const int ho = h / 2;
  const int wo = w / 2;
  const int cg = c / 8;
  const int64_t total = (int64_t)n * dout * ho * wo * cg;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int g = (int)(first % cg);
  float sc[8], sh[8], gi[8], gs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = inv[g * 8 + j];
    sh[j] = shift[g * 8 + j];
    gi[j] = 0.0f;
    gs[j] = 0.0f;
  }
  for (int64_t idx = first; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    int64_t t = idx / cg;
    const int ow = (int)(t % wo);
    t /= wo;
    const int oh = (int)(t % ho);
    t /= ho;
    const int od = (int)(t % dout);
    const int64_t on = t / dout;
    float m[8], v[8], dp[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = -CUDART_INF_F;
    for (int dz = 0; dz < pd; ++dz)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dxx = 0; dxx < 2; ++dxx) {
          const int64_t pos =
              ((on * d + od * pd + dz) * h + 2 * oh + dy) * w + 2 * ow + dxx;
          load8(x + pos * c + g * 8, v);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            m[j] = fmaxf(m[j], prologue(v[j], sc[j], sh[j], act));
        }
    load8(dpool + idx * 8, dp);
    for (int dz = 0; dz < pd; ++dz)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dxx = 0; dxx < 2; ++dxx) {
          const int64_t pos =
              ((on * d + od * pd + dz) * h + 2 * oh + dy) * w + 2 * ow + dxx;
          load8(x + pos * c + g * 8, v);
          float r[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float pre = pre_act(v[j], sc[j], sh[j]);
            const float sel = act_fwd(pre, act) == m[j] ? dp[j] : 0.0f;
            const float dpre = sel * act_grad(pre, act);
            r[j] = dpre * sc[j];
            gi[j] = fmaf(dpre, v[j], gi[j]);
            gs[j] += dpre;
          }
          store8(dx + pos * c + g * 8, r);
        }
  }
  if (first < total) {
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

}  // namespace

extern "C" int e3_pool_bnact(int dtype, const void* x, const float* inv,
                             const float* shift, void* y, int n, int d,
                             int h, int w, int c, int pd, int act,
                             void* stream) {
  const int64_t total = (int64_t)n * (d / pd) * (h / 2) * (w / 2) * (c / 8);
  const int blocks = pool_blocks(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == e3::DT_BF16)
    pool_bnact_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), inv, shift,
        static_cast<__nv_bfloat16*>(y), n, d, h, w, c, pd, act);
  else
    pool_bnact_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(x), inv, shift, static_cast<float*>(y),
        n, d, h, w, c, pd, act);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int e3_pool_bnact_bwd(int dtype, const void* x, const float* inv,
                                 const float* shift, const void* dpool,
                                 void* dx, float* dinv, float* dshift, int n,
                                 int d, int h, int w, int c, int pd, int act,
                                 void* stream) {
  // The block sums hold at most kPoolBwdMaxC channels, and a thread keeps
  // one channel group only if c / 8 divides the block size.
  if (c > kPoolBwdMaxC || 256 % (c / 8) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = (int64_t)n * (d / pd) * (h / 2) * (w / 2) * (c / 8);
  const int blocks = pool_blocks(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == e3::DT_BF16)
    pool_bnact_bwd_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), inv, shift,
        static_cast<const __nv_bfloat16*>(dpool),
        static_cast<__nv_bfloat16*>(dx), dinv, dshift, n, d, h, w, c, pd,
        act);
  else
    pool_bnact_bwd_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(x), inv, shift,
        static_cast<const float*>(dpool), static_cast<float*>(dx), dinv,
        dshift, n, d, h, w, c, pd, act);
  return static_cast<int>(cudaGetLastError());
}
