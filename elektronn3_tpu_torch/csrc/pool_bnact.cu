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

}  // namespace

extern "C" int e3_pool_bnact(int dtype, const void* x, const float* inv,
                             const float* shift, void* y, int n, int d,
                             int h, int w, int c, int pd, int act,
                             void* stream) {
  const int64_t total = (int64_t)n * (d / pd) * (h / 2) * (w / 2) * (c / 8);
  const int64_t want = (total + 255) / 256;
  const int blocks = (int)(want < (1 << 20) ? (want > 0 ? want : 1) : (1 << 20));
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
