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
//   values are K3's stored output bit for bit. The float32 bodies of the
//   five vup entries call it (conv_vup's and conv_vup_dgrad's K1 and K4
//   CUDA-core bodies in conv_bnact.cuh, conv_vup_wgrad's K5 in
//   conv_bnact_bwd.cu, upconv_stats and upconv_stats_bwd's pass in
//   upconv_bnact.cu), and so do their bf16 'cuda-core' bodies at shapes
//   the tensor-core bodies do not take.
// - vup_mma, a tile GEMM on the tensor cores (bf16): rows are carry
//   voxels, columns (sub-position, co) of K3's packed weight, each sum
//   taken over the k16 steps of ci in ascending order by mma.sync from
//   zero, then vup_round: the float32 bias added and one rounding to
//   bf16. K3's bf16 body (upconv_tc.cu) forms each of its stored values
//   the same way: the prologued carry rounded to bf16 (prologue_half),
//   the same packed weight, one m16n8k16 mma per k16 step of ci in
//   ascending order from zero, the bias added in float32, one rounding.
//   An mma's result depends only on its operands' bits, not on the lane
//   or warp that issues it, so vup_mma's u is K3's stored bf16 output
//   bit for bit, whatever rows and columns a warp takes: the
//   "materializing upconv kernel" contract of the JAX package's
//   _upconv122_f64_y (a card test, test_cuda_vup_u_is_k3s_output, holds
//   them equal). All five bf16 'tc' bodies (vup.vup_body) call it:
//   conv_vup (conv_tc.cu), conv_vup_dgrad (conv_vup_tc.cu), upconv_stats
//   and upconv_stats_bwd (upconv_stats_bwd_tc.cu), conv_vup_wgrad
//   (wgrad_tc.cu). A model step in bf16 therefore sees one u.
// The chain from E, the upconv output's cotangent, into the carry (row
// 23's GEMMs 2 and 3, shared by row 23 and conv_vup_dgrad's bf16 body)
// is at the end of this file.
#pragma once

#include "common.cuh"
#include "tc.cuh"

namespace e3 {

struct VupArgs {
  const void* carry;    // (n, d, h / 2, w / 2, cc) raw carry, dtype T
  const float* invc;    // (cc,) the carry's prologue (or its sample's
  const float* shiftc;  // row, at an offset upconv_value8_row is given)
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

// upconv_value8 with the carry's prologue row at offset ``po`` (the
// per-sample mode: the voxel's sample's row; 0 for the (cc,) vectors).
// The same sums, written out again rather than through upconv_value8 or
// a copy of ``u``: both of those moved the registers of the batch
// bodies that call this with ``po`` = 0 (ptxas, on the card).
template <typename T>
__device__ __forceinline__ void upconv_value8_row(const VupArgs& u,
                                                  int64_t cv, int sub,
                                                  int c0, float* out,
                                                  int64_t po) {
  const T* cp = static_cast<const T*>(u.carry) + cv * u.cc;
  const float* wp = u.wu + (int64_t)sub * u.cc * u.cu + c0;
  const float* ic = u.invc + po;   // the sample's rows
  const float* sc = u.shiftc + po;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
  for (int ci = 0; ci < u.cc; ci += 8) {
    float xv[8];
    load8(cp + ci, xv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float av = round_to<T>(prologue(xv[j], ic[ci + j], sc[ci + j],
                                            u.actc));
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

// -- The chain (bf16): row 23's GEMMs 2 and 3 on a tile of VBM carry
// voxels whose E, the upconv output's rounded cotangent, sits in shared
// memory as [VBM][EP] bf16 rows, column sub * cu + co (row 23's layout).
// Row 23 (upconv_stats_bwd_tc.cu) and conv_vup_dgrad's bf16 body
// (conv_vup_tc.cu) run them with 8 warps:
//   GEMM 2, the dgrad G = E Wu^T (M = VBM, N = cc, K = 4 cu), warps 4
//     (16 rows, wm2 = warp % 4) x 2 (cc / 2 channels, wn2 = warp / 4),
//     B K3's packed weight through ldmatrix .trans; its epilogue is K7's
//     (chain_dcarry): gm = G * act_c'(prec), dcarry = round(gm * invc),
//     dinvc and dshiftc partials;
//   GEMM 3, the wgrad dWu += a^T E (M = cc, N = 4 cu, K = VBM), warps 2
//     (cc / 2 channels, wm3 = warp / 4) x 4 (one sub-position's cu
//     columns, sub3 = warp % 4); both operands voxel-major, so both
//     through ldmatrix .trans; the sums live in registers for a block's
//     walk, and chain_dw_flush adds them to device memory.
// The raw carry and the prologued, rounded a sit as [VBM][XP] rows.
constexpr int VBM = 64;

template <int CC, int CU>
struct ChainCfg {
  static constexpr int NCOL = 4 * CU;            // (sub, co) columns
  static constexpr int XP = CC * 2 + 16;         // carry / a row pitch
  static constexpr int EP = NCOL * 2 + 16;       // E row pitch
  static constexpr int WBYTES = CC * NCOL * 2;   // K3's packed weight
  static constexpr int NJ2 = CC / 16;            // GEMM 2 n8 tiles a warp
  static constexpr int MI3 = CC / 32;            // GEMM 3 m16 tiles a warp
  static constexpr int NJ3 = CU / 8;             // GEMM 3 n8 tiles a warp
};

// This lane's ldmatrix rows of GEMMs 2 and 3 (s_e: E, s_w: the packed
// weight in tc.cuh's swizzled rows, s_a: the prologued carry).
template <int CC, int CU>
struct ChainLanes {
  uint32_t e2, w2, a3, e3;
  __device__ __forceinline__ ChainLanes(const void* s_e, const void* s_w,
                                        const void* s_a, int warp,
                                        int lane) {
    using C = ChainCfg<CC, CU>;
    const int wm2 = warp % 4, wm3 = warp / 4, sub3 = warp % 4;
    e2 = smem_u32(s_e) + (wm2 * 16 + (lane & 15)) * C::EP + (lane >> 4) * 16;
    w2 = smem_u32(s_w) + swz((lane & 7) + 8 * ((lane >> 3) & 1), lane >> 4);
    a3 = smem_u32(s_a) + ((lane & 7) + 8 * (lane >> 4)) * C::XP + wm3 * CC
        + ((lane >> 3) & 1) * 16;
    e3 = smem_u32(s_e) + ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::EP
        + sub3 * CU * 2 + (lane >> 4) * 16;
  }
};

// GEMM 2: acc = the warp's 16 rows x cc / 2 channels of G = E Wu^T.
template <int CC, int CU>
__device__ __forceinline__ void chain_gemm2(const ChainLanes<CC, CU>& l,
                                            int wn2,
                                            float (&acc)[CC / 16][4]) {
  using C = ChainCfg<CC, CU>;
#pragma unroll
  for (int nj = 0; nj < C::NJ2; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nj][e] = 0.0f;
#pragma unroll 4
  for (int ks = 0; ks < C::NCOL / 16; ++ks) {
    uint32_t af[4];
    ldmatrix_x4(l.e2 + ks * 32, af);
#pragma unroll
    for (int p = 0; p < C::NJ2 / 2; ++p) {
      uint32_t q[4];
      const int kc = wn2 * (CC / 32) + p;   // 16-channel group
      ldmatrix_x4_trans(l.w2 + (kc * C::NCOL + ks * 16) * 32, q);
      mma_bf16_16816(acc[2 * p], af, q[0], q[1]);
      mma_bf16_16816(acc[2 * p + 1], af, q[2], q[3]);
    }
  }
}

// GEMM 2's epilogue, K7's: lane (g, t4) takes rows g and g + 8 of the
// warp's 16, channels 2 t4 and 2 t4 + 1 of each n8 tile; gm = G *
// act_c'(x * invc + shiftc) of the raw carry x (row r of ``sx``);
// dcarry = round(gm * invc) at carry voxel ``vox(r)`` (negative: outside
// the volume, nothing stored or summed); the dinvc and dshiftc partials
// into si and ss.
template <int CC, typename Vox>
__device__ __forceinline__ void chain_dcarry(
    const float (&acc)[CC / 16][4], const unsigned char* sx,
    const float* s_inv, const float* s_shift, int act, int wm2, int wn2,
    int lane, Vox vox, __nv_bfloat16* dx, float (&si)[CC / 16][2],
    float (&ss)[CC / 16][2]) {
  constexpr int XP = CC * 2 + 16;
  const int g = lane / 4;
  const int t4 = lane % 4;
#pragma unroll
  for (int nj = 0; nj < CC / 16; ++nj) {
    const int c = wn2 * (CC / 2) + nj * 8 + 2 * t4;
    const float i0 = s_inv[c], i1 = s_inv[c + 1];
    const float h0 = s_shift[c], h1 = s_shift[c + 1];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm2 * 16 + g + 8 * hr;
      const int64_t v = vox(r);
      if (v < 0) continue;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sx + r * XP + c * 2));
      const float gm0 = acc[nj][2 * hr]
          * act_grad(pre_act(xv.x, i0, h0), act);
      const float gm1 = acc[nj][2 * hr + 1]
          * act_grad(pre_act(xv.y, i1, h1), act);
      si[nj][0] += gm0 * xv.x;
      si[nj][1] += gm1 * xv.y;
      ss[nj][0] += gm0;
      ss[nj][1] += gm1;
      *reinterpret_cast<__nv_bfloat162*>(dx + v * CC + c) =
          __floats2bfloat162_rn(gm0 * i0, gm1 * i1);
    }
  }
}

// GEMM 3: acc3 += the warp's cc / 2 channels x sub3's cu columns of
// a^T E over the tile's VBM rows.
template <int CC, int CU>
__device__ __forceinline__ void chain_gemm3(
    const ChainLanes<CC, CU>& l, float (&acc3)[CC / 32][CU / 8][4]) {
  using C = ChainCfg<CC, CU>;
#pragma unroll
  for (int ks = 0; ks < VBM / 16; ++ks) {
    uint32_t af[C::MI3][4];
#pragma unroll
    for (int mt = 0; mt < C::MI3; ++mt)
      ldmatrix_x4_trans(l.a3 + ks * 16 * C::XP + mt * 32, af[mt]);
#pragma unroll
    for (int p = 0; p < C::NJ3 / 2; ++p) {
      uint32_t q[4];
      ldmatrix_x4_trans(l.e3 + ks * 16 * C::EP + p * 32, q);
#pragma unroll
      for (int mt = 0; mt < C::MI3; ++mt) {
        mma_bf16_16816(acc3[mt][2 * p], af[mt], q[0], q[1]);
        mma_bf16_16816(acc3[mt][2 * p + 1], af[mt], q[2], q[3]);
      }
    }
  }
}

// dWu (2, 2, cc, cu) += GEMM 3's sums: lane (g, t4) holds input channels
// g and g + 8 of each m16 tile, output channels 2 t4 and 2 t4 + 1 of
// each n8 tile; one float32 device atomic per weight and lane.
template <int CC, int CU>
__device__ __forceinline__ void chain_dw_flush(
    const float (&acc3)[CC / 32][CU / 8][4], float* dw, int warp,
    int lane) {
  const int wm3 = warp / 4, sub3 = warp % 4;
  const int g = lane / 4;
  const int t4 = lane % 4;
#pragma unroll
  for (int mt = 0; mt < CC / 32; ++mt)
#pragma unroll
    for (int nj = 0; nj < CU / 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = wm3 * (CC / 2) + mt * 16 + g + 8 * (e >> 1);
        const int co = nj * 8 + 2 * t4 + (e & 1);
        atomicAdd(dw + ((int64_t)sub3 * CC + ci) * CU + co, acc3[mt][nj][e]);
      }
}

}  // namespace e3
