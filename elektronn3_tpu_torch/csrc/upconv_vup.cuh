// The (1, 2, 2) upconv of a deeper level's carried activation, computed
// voxel by voxel from the carry: the one device function that every
// kernel of the vup path calls (K1's vup staging, K4's vup epilogue, K5's
// vup staging, the statistics pass and its backward), so that all of
// them see the same bits of the upconv output, which is never stored.
// Counterpart of the JAX package's ops/flat_fused64.py::_upconv122_f64_y,
// which JAX shares between those kernels the same way.
//
// Output voxel (n, d, 2 hc + b, 2 wc + c), channels c0 .. c0 + 7:
//     round(bu + sum_ci round(act_c(carry[n, d, hc, wc, ci] * invc + shiftc))
//                    * Wu[(b, c), ci, :])
// summed in float32 over ci in ascending order, each round to the
// activation dtype T. That is the order of K3's float32 body, so in
// float32 the values are K3's stored output bit for bit. K3's bf16 body
// (upconv_tc.cu) sums on the tensor cores in another order, so in bf16
// the recomputed values may differ from what K3 would store in the last
// bit: the vup path agrees with the materializing path within the
// tolerance of one rounding after a reordered sum, and nothing on the
// card asserts the two bitwise equal (the CPU tests that do run the
// plain versions of both).
#pragma once

#include "common.cuh"

namespace e3 {

struct VupArgs {
  const void* carry;    // (n, d, h / 2, w / 2, cc) raw carry, dtype T
  const float* invc;    // (cc,) the carry's prologue
  const float* shiftc;
  const float* wu;      // (2, 2, cc, cu) float32 weights (values of T)
  const float* bu;      // (cu,) float32 bias
  int cc, cu, actc;     // cc % 8 == 0, cu % 8 == 0
};

inline VupArgs vup_args(const void* carry, int cc, const float* invc,
                        const float* shiftc, const float* wu,
                        const float* bu, int cu, int actc) {
  VupArgs u = {};
  u.carry = carry;
  u.invc = invc;
  u.shiftc = shiftc;
  u.wu = wu;
  u.bu = bu;
  u.cc = cc;
  u.cu = cu;
  u.actc = actc;
  return u;
}

// The carry voxel under full-resolution voxel (nd, hh, ww) of a level of
// (h, wd), both even, nd the n * d + depth index.
__device__ __forceinline__ int64_t vup_parent(int64_t nd, int hh, int ww,
                                              int h, int wd) {
  return (nd * (h / 2) + hh / 2) * (wd / 2) + ww / 2;
}

// Its sub-position: the (row, column) parity, as K3's tap order.
__device__ __forceinline__ int vup_sub(int hh, int ww) {
  return (hh % 2) * 2 + ww % 2;
}

// The upconv output of carry voxel ``cv`` at sub-position ``sub``,
// channels c0 .. c0 + 7, rounded to T, into out[0 .. 7].
template <typename T>
__device__ __forceinline__ void upconv_value8(const VupArgs& u, int64_t cv,
                                              int sub, int c0, float* out) {
  const T* cp = static_cast<const T*>(u.carry) + cv * u.cc;
  const float* wp = u.wu + (int64_t)sub * u.cc * u.cu + c0;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
  for (int ci = 0; ci < u.cc; ci += 8) {
    float xv[8];
    load8(cp + ci, xv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float av = round_to<T>(prologue(xv[j], u.invc[ci + j],
                                            u.shiftc[ci + j], u.actc));
      const float4* wr =
          reinterpret_cast<const float4*>(wp + (int64_t)(ci + j) * u.cu);
      const float4 w0 = __ldg(wr);
      const float4 w1 = __ldg(wr + 1);
      acc[0] = fmaf(av, w0.x, acc[0]);
      acc[1] = fmaf(av, w0.y, acc[1]);
      acc[2] = fmaf(av, w0.z, acc[2]);
      acc[3] = fmaf(av, w0.w, acc[3]);
      acc[4] = fmaf(av, w1.x, acc[4]);
      acc[5] = fmaf(av, w1.y, acc[5]);
      acc[6] = fmaf(av, w1.z, acc[6]);
      acc[7] = fmaf(av, w1.w, acc[7]);
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = round_to<T>(acc[k] + u.bu[c0 + k]);
}

}  // namespace e3
