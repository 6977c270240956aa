// The (1, 2, 2) upconv of a deeper level's carried activation, recomputed
// where it is read and never stored: the vup path's two recomputes.
// Counterpart of the JAX package's ops/flat_fused64.py::_upconv122_f64_y,
// which JAX shares between its vup kernels.
//
// Output voxel (n, d, 2 hc + b, 2 wc + c), channel co:
//     round(bu[co] + sum_ci round(act_c(carry[n, d, hc, wc, ci] * invc
//                                       + shiftc)) * Wu[(b, c), ci, co])
// with float32 sums and each round to the activation dtype T.
//
// - upconv_value8, voxel by voxel on the CUDA cores, sums over ci in
//   ascending order, the order of K3's float32 body: in float32 the
//   values are K3's stored output bit for bit. K1's vup staging
//   (conv_vup), K4's vup epilogue (conv_vup_dgrad), the statistics pass
//   (upconv_stats, row 22), and the float32 bodies (and the 'cuda-core'
//   bodies asked for in bf16) of conv_vup_wgrad and upconv_stats_bwd
//   call it, so they all see the same bits of u.
// - vup_mma, a tile GEMM on the tensor cores (bf16 only): rows are carry
//   voxels, columns (sub-position, co) of K3's packed weight, each sum
//   taken over the k16 steps of ci in ascending order by mma.sync from
//   zero, then vup_round. The bf16 bodies of row 23
//   (upconv_stats_bwd_tc.cu) and of row 9's weight gradient
//   (conv_vup_wgrad in wgrad_tc.cu) call it, so those two see the same
//   bits of u as each other, whatever rows and columns a warp takes.
// The two recomputes sum in different orders, so in bf16 a value of one
// may differ from the other's (and from K3's tensor-core body's) by one
// rounding: the entries agree with each other, and with the
// materializing path, within the tolerance of one rounding after a
// reordered sum, and nothing on the card asserts them bitwise equal
// (the CPU tests that do run the plain versions).
#pragma once

#include "common.cuh"
#include "tc.cuh"

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

// -- The tensor-core recompute (bf16).
//
// One warp's share of the tile GEMM: acc[mi][2 p + h] (m16 tile mi of the
// rows, n8 tile h of column pair p) = sum over the k16 steps ks = 0 ..
// ksteps - 1, in that order, from zero, of the rows' prologued carry
// values times the weight columns col[p] .. col[p] + 15.
//   a_lane: shared address of this lane's ldmatrix row of m16 tile 0 and
//     k16 step 0 in a tile of bf16 rows of ``a_pitch`` bytes (an odd
//     number of 16-byte units: conflict-free): row (lane % 16), byte
//     16 (lane / 16). m16 tile mi adds 16 rows.
//   w_lane: shared address of this lane's row of the weight tile, K3's
//     packed layout as [ksteps][w_rows][16] bf16 swizzled as tc.cuh's
//     swz: swz((lane % 8) + 8 (lane / 16), (lane / 8) % 2). col[p] and
//     w_rows are multiples of 16.
template <int MI, int NP>
__device__ __forceinline__ void vup_mma(uint32_t a_lane, int a_pitch,
                                        uint32_t w_lane, const int (&col)[NP],
                                        int w_rows, int ksteps,
                                        float (&acc)[MI][2 * NP][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2 * NP; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t af[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldmatrix_x4(a_lane + mi * 16 * a_pitch + ks * 32, af[mi]);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint32_t r[4];
      ldmatrix_x4(w_lane + (ks * w_rows + col[p]) * 32, r);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma_bf16_16816(acc[mi][2 * p], af[mi], r[0], r[1]);
        mma_bf16_16816(acc[mi][2 * p + 1], af[mi], r[2], r[3]);
      }
    }
  }
}

// The recomputed output from a vup_mma sum: the float32 bias added, then
// rounded to bf16 once.
__device__ __forceinline__ float vup_round(float acc, float bu) {
  return __bfloat162float(__float2bfloat16_rn(acc + bu));
}

}  // namespace e3
