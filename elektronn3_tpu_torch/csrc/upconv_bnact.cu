// K3 upconv_bnact: transposed convolution whose kernel equals its
// stride, (1, 2, 2) or (2, 2, 2), with an optional prologue (BN-apply +
// activation of the deeper level's raw output) on load. Each output
// voxel (kd*d + a, 2h + b, 2w + c) is
//     bias + sum_ci act(x[d, h, w, ci] * inv + shift) * W[a, b, c, ci, co],
// float32 accumulation, stored in the activation dtype, with optional
// batch statistics (per-channel sum and sum of squares of the stored,
// dtype-rounded output). W is in the port's (a, b, c, ci, co) order,
// i.e. torch ConvTranspose taps.
//
// K7 upconv_bnact_bwd: its merged backward, as two kernels in one call:
//   - dgrad: dy_tot = dy + ds + 2 y dq on load (the statistics cotangent
//     folded in), rounded to the dtype; per input voxel a GEMM over
//     (sub-position, C_out) back to the prologued input's gradient g;
//     its epilogue gives gm = g * act'(x * inv + shift), dx = gm * inv
//     (rounded once), dinv = sum(gm * x) and dshift = sum(gm);
//   - wgrad: dW[sub, ci, co] = sum over input voxels of a[v, ci] *
//     dy_tot[out(v, sub), co], with a the RECOMPUTED prologued input
//     rounded to the dtype, and db = sum of the float32 dy_tot.
//
// Replaces these TPU kernels of the JAX package:
//   ops/flat_fused64.py::upconv222_bn_flat64   (_upconv64_fwd_kernel,
//                                              _upconv64_bwd_kernel)
//   ops/flat_fused64.py::upconv122_from_flat64 (_upconv122_f64_fwd_kernel,
//                                              _upconv122_f64_bwd_kernel)
//   ops/flat_fused64.py::upconv122_bn_flat64   (and _upconv122_64_bwd)
//   ops/flat_fused64.py::upconv222_f64in, upconv122_f64in
//                                              (_upconv_f64in_bwd_call: the
//                                              carried C=128 or 256 input)
//   ops/flat_fused.py::upconv_bn_flat          (and _upconv_bwd)
// Nothing here is sized by the channel counts: input channels are
// staged UCK (BCO, BCI) at a time and output channels are split over
// blocks of 32, so C_in 128 and 256 run the same code as 64.
//
// The bf16 forward runs on the tensor cores, in upconv_tc.cu: one GEMM
// per block of 64 input voxels over all kd * 4 * C_out columns, its
// prologued input tile staged once, the weights packed once per call.
// At the headline shapes it does 64 to 256 FLOP per byte it must move
// (the output dominates the bytes), near the H100's ridge, so the
// tensor-core rate and the store rate both bound it. This file keeps
// the float32 forward on the CUDA cores (the float32 tests hold 1e-4 of
// the scale, which TF32 products would not): one warp owns one
// sub-position (a, b, c), so the shared-memory weight reads are
// broadcasts, and each staged (prologued) input value serves every
// sub-position and 32 output channels; float32 FMAs cap it at the
// 67 TFLOP/s of those units. The backward kernels (K7) stage dy_tot and
// the weights in shared memory by 16- or 32-channel steps and keep
// their sums in registers; they run on the CUDA cores in both dtypes.
//
// Cross-block sums (statistics, dinv, dshift, dW, db) use float32
// atomics after a warp-shuffle and shared-memory reduction inside the
// block: one atomic per channel (or weight) and block. Their order, and
// so the last bits of each sum, changes from run to run.
//
// The vup path (JAX's upconv of the C=64 carry that is never stored)
// adds three entries here, each on the recompute of upconv_vup.cuh
// (upconv_value8), for float32 and for bf16 where vup.vup_body names the
// CUDA-core bodies (its 'tc' bodies: upconv_stats_bwd_tc.cu for rows 22
// and 23, conv_vup_tc.cu for row 9's chain):
//   e3_upconv_stats (row 22, ops/flat_fused64.py::
//     upconv122_stats_from_flat64): the per-channel sum and sum of
//     squares of the rounded upconv output, recomputed per voxel;
//     nothing else is stored. Bound by that recompute (2 * cc FLOP per
//     output value on the CUDA cores) and by the carry read.
//   e3_upconv_stats_bwd (row 23, _upconv122_stats_bwd): one pass forms dy_tot = ds + 2 y dq on the
//     recomputed y, sums it in float32 (the bias gradient) and stores
//     it rounded, E, into a scratch of the upconv output's shape; then
//     the chain below on that E.
//   e3_conv_vup_chain (row 9's chain, ops/flat_fused.py::_conv_vup_bwd):
//     K7's dgrad and wgrad bodies on E, the upconv output's cotangent
//     that e3_conv_vup_dgrad (conv_vup.cu) stored rounded: dcarry,
//     dinvc, dshiftc and dWu. The bias gradient of the chain is summed
//     from the float32 cotangent before E is rounded, as JAX sums it, so
//     K7's db of E goes to a scratch that the caller drops.
//   Each upconv recompute runs once per output value; the chain reads E
//   (in the activation dtype, as JAX rounds it) once per use.
//   Their per-sample mode (group and instance norm; JAX's
//   want_stats='per_sample', flat_fused64.py:2930): the carry's prologue
//   and ds, dq are (n, C) rows at their sample strides; the pass runs a
//   grid of (chunk of a sample, channel block, sample), PASS_VOX carry
//   voxels a chunk, on instantiations of its own, and row 22's sums come
//   per sample from the chunks' partial rows through ps_reduce, in a
//   fixed order; the chain is K7's per-sample CUDA-core mode (dinvc,
//   dshiftc per sample); dWu and dbu stay global.
#include "common.cuh"
#include "ps_reduce.cuh"
#include "upconv_vup.cuh"

namespace {

using namespace e3;

constexpr int UCK = 16;  // input channels staged per step
constexpr int COG = 32;  // output channels per block
constexpr int NT = 256;  // threads per block: 8 warps
constexpr int VMAX = 64; // most input voxels per block (kd == 1)

struct UpArgs {
  const void* x;      // (n, d, h, w, cin)
  const float* inv;   // (cin,)
  const float* shift; // (cin,)
  const float* wt;    // (kd, 2, 2, cin, cout), float32
  const float* bias;  // (cout,), float32
  void* y;            // (n, kd * d, 2 h, 2 w, cout)
  float* s;           // (cout,) sums of the stored output, or null
  float* q;           // (cout,) sums of squares, or null
  // Backward only.
  const void* dy;     // (n, kd * d, 2 h, 2 w, cout)
  const float* ds;    // (cout,) statistics cotangents, or null
  const float* dq;
  void* dx;           // (n, d, h, w, cin), or null
  float* dinv;        // (cin,)
  float* dshift;
  float* dw;          // (kd, 2, 2, cin, cout)
  float* db;          // (cout,)
  int n, d, h, wd, cin, cout, kd, act;
  VupArgs vup;        // the vup entries: x is this carry (kd == 1)
  // K3, the per-sample mode (group and instance norm): the sample stride
  // of inv/shift (cin), the statistics' partial rows (n, blocks of a
  // sample, 2 cout) in place of s and q (ps_reduce.cuh; or null), and
  // the voxels of a sample (d * h * w), which selects the (block of a
  // sample, channel block, sample) grid, so no block straddles two
  // samples; 0 and null for the batch form.
  int pro_ns;
  float* part;
  int64_t spv;
  // K7, the per-sample mode: the sample stride of ds/dq (cout; 0 for the
  // batch form) and the input voxels of a sample (d * h * w), by which a
  // voxel finds its sample's rows. With an (n, cin) prologue (pro_ns) the
  // dgrad's grid is (block of a sample, channel block, sample) and its
  // dinv, dshift go into ``part`` (n, blocks of a sample, 2 cin).
  int st_ns;
  int64_t sv;
};

// Output voxel of input voxel v at sub-position sub = (a, b, c).
__device__ __forceinline__ int64_t out_voxel(const UpArgs& a, int64_t v,
                                             int sub) {
  const int ww = (int)(v % a.wd);
  int64_t t = v / a.wd;
  const int hh = (int)(t % a.h);
  const int64_t nd = t / a.h;
  const int64_t nn = nd / a.d;
  const int dd = (int)(nd % a.d);
  const int pa = sub / 4;        // depth phase (0 when kd == 1)
  const int pb = (sub / 2) % 2;  // row phase
  const int pc = sub % 2;        // column phase
  return ((nn * (a.d * a.kd) + dd * a.kd + pa) * (2 * a.h) + 2 * hh + pb)
      * (2 * a.wd) + 2 * ww + pc;
}

// Add a block's per-channel partial sums (one value per lane of every
// warp, COG channels, two quantities) into device memory.
__device__ __forceinline__ void block_sums32(float (*red)[COG], float t0,
                                             float t1, float* out0,
                                             float* out1, int co0) {
  __syncthreads();  // red's initialization is visible
  atomicAdd(&red[0][threadIdx.x % 32], t0);
  atomicAdd(&red[1][threadIdx.x % 32], t1);
  __syncthreads();
  if (threadIdx.x < COG) {
    atomicAdd(out0 + co0 + threadIdx.x, red[0][threadIdx.x]);
    atomicAdd(out1 + co0 + threadIdx.x, red[1][threadIdx.x]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) upconv_bnact_kernel(const UpArgs a) {
  __shared__ float s_in[UCK][VMAX];
  __shared__ __align__(16) float s_w[8][UCK][COG];
  __shared__ float s_red[2][COG];

  const int nsub = a.kd * 4;          // 8 or 4 sub-positions
  const int vpb = 32 * (8 / nsub);    // 32 or 64 input voxels per block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = warp % nsub;
  const int vl = (warp / nsub) * 32 + lane;
  // The end of the block's voxels (of its sample, blockIdx.z, in the
  // per-sample grid), its first voxel and its sample's prologue row.
  const int64_t vbase = blockIdx.z * a.spv;
  const int64_t total = a.spv ? vbase + a.spv
                              : (int64_t)a.n * a.d * a.h * a.wd;
  const int64_t v0 = vbase + (int64_t)blockIdx.x * vpb;
  const float* const inv = a.inv + blockIdx.z * a.pro_ns;
  const float* const shift = a.shift + blockIdx.z * a.pro_ns;
  const int co0 = blockIdx.y * COG;
  const T* x = static_cast<const T*>(a.x);
  if (threadIdx.x < 2 * COG) s_red[threadIdx.x / COG][threadIdx.x % COG] = 0;

  float acc[COG];
#pragma unroll
  for (int o = 0; o < COG; ++o) acc[o] = 0.0f;

  for (int cb = 0; cb < a.cin; cb += UCK) {
    __syncthreads();
    for (int p = threadIdx.x; p < vpb * (UCK / 8); p += NT) {
      const int pv = p / (UCK / 8);
      const int g = p % (UCK / 8);
      const int64_t v = v0 + pv;
      float vals[8];
      if (v < total) {
        load8(x + v * a.cin + cb + g * 8, vals);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = cb + g * 8 + j;
          vals[j] = round_to<T>(prologue(vals[j], inv[c], shift[c], a.act));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) vals[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s_in[g * 8 + j][pv] = vals[j];
    }
    for (int q = threadIdx.x; q < nsub * UCK * COG; q += NT) {
      const int o = q % COG;
      const int c = (q / COG) % UCK;
      const int s = q / (COG * UCK);
      s_w[s][c][o] = a.wt[((int64_t)s * a.cin + cb + c) * a.cout + co0 + o];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < UCK; ++c) {
      const float av = s_in[c][vl];
      const float4* wr = reinterpret_cast<const float4*>(&s_w[sub][c][0]);
#pragma unroll
      for (int q = 0; q < COG / 4; ++q) {
        const float4 wv = wr[q];
        acc[4 * q + 0] = fmaf(av, wv.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(av, wv.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(av, wv.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(av, wv.w, acc[4 * q + 3]);
      }
    }
  }

  // Epilogue: bias, store, and the stored values' sums (zero for a
  // voxel past the end, which every thread still reduces with).
  const int64_t v = v0 + vl;
  const bool valid = v < total;
  float st0[COG], st1[COG];
  if (valid) {
    T* dst = static_cast<T*>(a.y) + out_voxel(a, v, sub) * a.cout + co0;
#pragma unroll
    for (int q = 0; q < COG / 8; ++q) {
      float r[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r[j] = acc[8 * q + j] + a.bias[co0 + 8 * q + j];
      store8(dst + 8 * q, r);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float rv = round_to<T>(r[j]);
        st0[8 * q + j] = rv;
        st1[8 * q + j] = rv * rv;
      }
    }
  } else {
#pragma unroll
    for (int o = 0; o < COG; ++o) st0[o] = st1[o] = 0.0f;
  }
  if (a.s == nullptr) return;
  const float t0 = warp_reduce_scatter32(st0);
  const float t1 = warp_reduce_scatter32(st1);
  if (a.part != nullptr) {
    // The per-sample mode: the warps in turn, then the block's partial
    // row into slot blockIdx.x of sample blockIdx.z.
    __syncthreads();  // s_red's initialization is visible
    for (int w = 0; w < NT / 32; ++w) {
      if (warp == w) {
        s_red[0][lane] += t0;
        s_red[1][lane] += t1;
      }
      __syncthreads();
    }
    if (threadIdx.x < COG) {
      float* const row = a.part
          + ((int64_t)blockIdx.z * gridDim.x + blockIdx.x) * 2 * a.cout
          + co0;
      row[threadIdx.x] = s_red[0][threadIdx.x];
      row[a.cout + threadIdx.x] = s_red[1][threadIdx.x];
    }
    return;
  }
  block_sums32(s_red, t0, t1, a.s, a.q, co0);
}

// -- K7, dgrad: one block per 32 input voxels and 32 input channels;
// thread (voxel vl, channel quad cq) sums 4 input channels over
// (sub-position, output channel), with dy_tot and the weights staged
// 16 output channels at a time.
constexpr int BV = 32;   // input voxels per block
constexpr int BCI = 32;  // input channels per block
constexpr int BCO = 16;  // output channels staged per step

template <typename T>
__global__ void __launch_bounds__(NT) upconv_dgrad_kernel(const UpArgs a) {
  // s_g[voxel][sub * BCO + co], rows padded by one so the 4 voxels a
  // warp reads sit in 4 banks.
  __shared__ float s_g[BV][8 * BCO + 1];
  __shared__ __align__(16) float s_w[8][BCO][BCI];
  __shared__ float s_red[2][BCI];

  const int nsub = a.kd * 4;
  // The per-sample grid's block covers voxels of sample blockIdx.z only.
  const bool psg = a.part != nullptr;
  const int64_t vbase = psg ? blockIdx.z * a.sv : 0;
  const int64_t total = psg ? vbase + a.sv
                            : (int64_t)a.n * a.d * a.h * a.wd;
  const int64_t v0 = vbase + (int64_t)blockIdx.x * BV;
  const int ci0 = blockIdx.y * BCI;
  const int vl = threadIdx.x / (BCI / 4);
  const int cq = threadIdx.x % (BCI / 4);
  const T* dyp = static_cast<const T*>(a.dy);
  const T* yp = static_cast<const T*>(a.y);
  if (threadIdx.x < 2 * BCI) s_red[threadIdx.x / BCI][threadIdx.x % BCI] = 0;

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int cb = 0; cb < a.cout; cb += BCO) {
    __syncthreads();  // the previous step's reads are done
    // dy_tot of (voxel, sub, 8 output channels) items, rounded.
    for (int p = threadIdx.x; p < BV * nsub * (BCO / 8); p += NT) {
      const int g = p % (BCO / 8);
      const int sub = (p / (BCO / 8)) % nsub;
      const int pv = p / (nsub * (BCO / 8));
      const int64_t v = v0 + pv;
      float gv[8];
      if (v < total) {
        const int64_t off = out_voxel(a, v, sub) * a.cout + cb + 8 * g;
        load8(dyp + off, gv);
        if (a.ds != nullptr) {
          float yv[8];
          load8(yp + off, yv);
          const int64_t so = a.st_ns ? v / a.sv * a.st_ns : 0;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            gv[j] = dy_tot(gv[j], yv[j], a.ds[so + cb + 8 * g + j],
                           a.dq[so + cb + 8 * g + j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) gv[j] = round_to<T>(gv[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) gv[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s_g[pv][sub * BCO + 8 * g + j] = gv[j];
    }
    // s_w[sub][co][ci] = W[sub, ci0 + ci, cb + co].
    for (int q = threadIdx.x; q < nsub * BCO * BCI; q += NT) {
      const int co = q % BCO;
      const int ci = (q / BCO) % BCI;
      const int sub = q / (BCO * BCI);
      s_w[sub][co][ci] =
          a.wt[((int64_t)sub * a.cin + ci0 + ci) * a.cout + cb + co];
    }
    __syncthreads();
    for (int sub = 0; sub < nsub; ++sub) {
#pragma unroll
      for (int co = 0; co < BCO; ++co) {
        const float gv = s_g[vl][sub * BCO + co];
        const float4 wv =
            reinterpret_cast<const float4*>(&s_w[sub][co][0])[cq];
        acc[0] = fmaf(gv, wv.x, acc[0]);
        acc[1] = fmaf(gv, wv.y, acc[1]);
        acc[2] = fmaf(gv, wv.z, acc[2]);
        acc[3] = fmaf(gv, wv.w, acc[3]);
      }
    }
  }

  // Epilogue: the prologue's gradient of 4 input channels.
  const int64_t v = v0 + vl;
  const int c0 = ci0 + 4 * cq;
  float gi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float gs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (v < total) {
    const T* xp = static_cast<const T*>(a.x) + v * a.cin + c0;
    const int64_t po = a.pro_ns ? v / a.sv * a.pro_ns : 0;
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float xv = to_f(xp[j]);
      const float inv = a.inv[po + c0 + j];
      const float gm = acc[j] * act_grad(pre_act(xv, inv,
                                                 a.shift[po + c0 + j]),
                                         a.act);
      r[j] = gm * inv;
      gi[j] = gm * xv;
      gs[j] = gm;
    }
    if (a.dx != nullptr) {
      T* dxp = static_cast<T*>(a.dx) + v * a.cin + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j) dxp[j] = from_f<T>(r[j]);
    }
  }
  // Lanes l and l + 8k hold the same channels (quad l % 8): sum over
  // the other lane bits, then each block adds its 32 channels.
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int off = 8; off < 32; off <<= 1) {
      gi[j] += __shfl_xor_sync(0xffffffffu, gi[j], off);
      gs[j] += __shfl_xor_sync(0xffffffffu, gs[j], off);
    }
  __syncthreads();  // s_red's initialization is visible
  if (psg) {
    // The per-sample mode: the warps in turn, then the block's partial
    // row, slot blockIdx.x of sample blockIdx.z.
    for (int w = 0; w < NT / 32; ++w) {
      if (threadIdx.x / 32 == w && threadIdx.x % 32 < BCI / 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s_red[0][4 * cq + j] += gi[j];
          s_red[1][4 * cq + j] += gs[j];
        }
      }
      __syncthreads();
    }
    if (threadIdx.x < BCI) {
      float* const row = a.part
          + ((int64_t)blockIdx.z * gridDim.x + blockIdx.x) * 2 * a.cin + ci0;
      row[threadIdx.x] = s_red[0][threadIdx.x];
      row[a.cin + threadIdx.x] = s_red[1][threadIdx.x];
    }
    return;
  }
  if (threadIdx.x % 32 < BCI / 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      atomicAdd(&s_red[0][4 * cq + j], gi[j]);
      atomicAdd(&s_red[1][4 * cq + j], gs[j]);
    }
  }
  __syncthreads();
  if (threadIdx.x < BCI) {
    atomicAdd(a.dinv + ci0 + threadIdx.x, s_red[0][threadIdx.x]);
    atomicAdd(a.dshift + ci0 + threadIdx.x, s_red[1][threadIdx.x]);
  }
}

// -- K7, wgrad: block (voxel split, 32 input channels, 32 output
// channels) walks a strided share of 32-voxel tiles; thread (input
// channel ci = lane, output group = warp) keeps nsub * 32 / 8 sums of
// dW in registers. The blocks of the first input-channel group also sum
// db from the unrounded dy_tot they stage.
constexpr int WVT = 32;  // input voxels per tile

template <typename T>
__global__ void __launch_bounds__(NT) upconv_wgrad_kernel(const UpArgs a) {
  __shared__ float s_a[WVT][BCI + 1];
  __shared__ __align__(16) float s_g[WVT][8][COG];
  __shared__ float s_db[COG];

  const int nsub = a.kd * 4;
  const int nout = nsub * COG / 8;   // dW sums per thread: 32 or 16
  const int64_t total = (int64_t)a.n * a.d * a.h * a.wd;
  const int64_t ntiles = (total + WVT - 1) / WVT;
  const int ci0 = blockIdx.y * BCI;
  const int co0 = blockIdx.z * COG;
  const bool do_db = blockIdx.y == 0;
  const int lane = threadIdx.x % 32;
  const int grp = threadIdx.x / 32;
  const T* xp = static_cast<const T*>(a.x);
  const T* dyp = static_cast<const T*>(a.dy);
  const T* yp = static_cast<const T*>(a.y);
  if (threadIdx.x < COG) s_db[threadIdx.x] = 0.0f;

  float acc[32];
#pragma unroll
  for (int o = 0; o < 32; ++o) acc[o] = 0.0f;
  float dbl[8];  // db partials of this thread's staged channels
#pragma unroll
  for (int j = 0; j < 8; ++j) dbl[j] = 0.0f;

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t v0 = t * WVT;
    __syncthreads();  // the previous tile's reads are done
    for (int p = threadIdx.x; p < WVT * (BCI / 8); p += NT) {
      const int g = p % (BCI / 8);
      const int pv = p / (BCI / 8);
      const int64_t v = v0 + pv;
      float vals[8];
      if (v < total) {
        load8(xp + v * a.cin + ci0 + 8 * g, vals);
        const int64_t po = a.pro_ns ? v / a.sv * a.pro_ns : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = ci0 + 8 * g + j;
          vals[j] = round_to<T>(prologue(vals[j], a.inv[po + c],
                                         a.shift[po + c], a.act));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) vals[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s_a[pv][8 * g + j] = vals[j];
    }
    // dy_tot items (voxel, sub, 8 output channels); NT is a multiple of
    // COG / 8, so a thread always stages the same channels.
    for (int p = threadIdx.x; p < WVT * nsub * (COG / 8); p += NT) {
      const int g = p % (COG / 8);
      const int sub = (p / (COG / 8)) % nsub;
      const int pv = p / (nsub * (COG / 8));
      const int64_t v = v0 + pv;
      float gv[8];
      if (v < total) {
        const int64_t off = out_voxel(a, v, sub) * a.cout + co0 + 8 * g;
        load8(dyp + off, gv);
        if (a.ds != nullptr) {
          float yv[8];
          load8(yp + off, yv);
          const int64_t so = a.st_ns ? v / a.sv * a.st_ns : 0;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            gv[j] = dy_tot(gv[j], yv[j], a.ds[so + co0 + 8 * g + j],
                           a.dq[so + co0 + 8 * g + j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dbl[j] += gv[j];
          gv[j] = round_to<T>(gv[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) gv[j] = 0.0f;
      }
      float4* dst = reinterpret_cast<float4*>(&s_g[pv][sub][8 * g]);
      dst[0] = make_float4(gv[0], gv[1], gv[2], gv[3]);
      dst[1] = make_float4(gv[4], gv[5], gv[6], gv[7]);
    }
    __syncthreads();
    // Thread (ci = lane, group grp) owns outputs o = grp * nout + k of
    // the flattened (sub, co) axis.
    for (int pv = 0; pv < WVT; ++pv) {
      const float av = s_a[pv][lane];
      const float* gr = &s_g[pv][0][0] + grp * nout;
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (k < nout) acc[k] = fmaf(av, gr[k], acc[k]);
    }
  }

#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k >= nout) break;
    const int o = grp * nout + k;
    const int sub = o / COG;
    const int co = o % COG;
    atomicAdd(a.dw + ((int64_t)sub * a.cin + ci0 + lane) * a.cout + co0 + co,
              acc[k]);
  }
  if (do_db) {
    __syncthreads();  // s_db's initialization is visible
    const int g = threadIdx.x % (COG / 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) atomicAdd(&s_db[8 * g + j], dbl[j]);
    __syncthreads();
    if (threadIdx.x < COG) atomicAdd(a.db + co0 + threadIdx.x,
                                     s_db[threadIdx.x]);
  }
}

// -- Rows 22 and 23: one pass over the recomputed upconv output. Thread
// (sub-position, 8-channel group g) of each of a block's 16 voxels in
// flight; a grid-stride walk over the carry's voxels keeps each
// thread's (sub, g), so it sums 8 channels in registers; lanes of one g
// reduce by shuffles, then the block in shared memory, then one atomic
// per channel and block. Row 22 (DYT = false): the sums of y and y^2
// into (s, q). Row 23 (DYT = true): dy_tot = ds + 2 y dq, its float32
// sum into s (the bias gradient), and dy_tot rounded into a.dx (E, of
// the upconv output's shape).
template <typename T, bool DYT>
__global__ void __launch_bounds__(NT) upconv_pass_kernel(const UpArgs a) {
  __shared__ float s_red[2][COG];
  const int g = threadIdx.x % 4;
  const int sub = (threadIdx.x / 4) % 4;
  const int co0 = blockIdx.y * COG;
  const int64_t total = (int64_t)a.n * a.d * a.h * a.wd;
  if (threadIdx.x < 2 * COG) s_red[threadIdx.x / COG][threadIdx.x % COG] = 0;
  float st[8], sq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j] = sq[j] = 0.0f;
  for (int64_t v = (int64_t)blockIdx.x * (NT / 16) + threadIdx.x / 16;
       v < total; v += (int64_t)gridDim.x * (NT / 16)) {
    float y[8];
    upconv_value8<T>(a.vup, v, sub, co0 + 8 * g, y);
    if constexpr (DYT) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[j] = dy_tot(0.0f, y[j], a.ds[co0 + 8 * g + j],
                      a.dq[co0 + 8 * g + j]);
        st[j] += y[j];
      }
      store8(static_cast<T*>(a.dx) + out_voxel(a, v, sub) * a.cout + co0
                 + 8 * g,
             y);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        st[j] += y[j];
        sq[j] = fmaf(y[j], y[j], sq[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      st[j] += __shfl_xor_sync(0xffffffffu, st[j], off);
      sq[j] += __shfl_xor_sync(0xffffffffu, sq[j], off);
    }
  __syncthreads();  // s_red's initialization is visible
  if (threadIdx.x % 32 < 4) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      atomicAdd(&s_red[0][8 * g + j], st[j]);
      atomicAdd(&s_red[1][8 * g + j], sq[j]);
    }
  }
  __syncthreads();
  if (threadIdx.x < COG) {
    atomicAdd(a.s + co0 + threadIdx.x, s_red[0][threadIdx.x]);
    if (!DYT) atomicAdd(a.q + co0 + threadIdx.x, s_red[1][threadIdx.x]);
  }
}

// The per-sample pass's chunk: carry voxels of one sample a block takes
// (16 in flight, 32 steps).
constexpr int PASS_VOX = 512;

// The pass's per-sample mode (its own kernel, so that the batch form's
// code stays as it was): block (chunk, channel block, sample) takes the
// chunk's voxels of sample blockIdx.z, the carry's prologue row and
// (row 23) the ds, dq rows of that sample; row 22's sums go into its
// partial row (slot blockIdx.x), the warps added in turn; row 23's dbu
// stays global.
template <typename T, bool DYT>
__global__ void __launch_bounds__(NT) upconv_pass_ps_kernel(const UpArgs a) {
  __shared__ float s_red[2][COG];
  const int g = threadIdx.x % 4;
  const int sub = (threadIdx.x / 4) % 4;
  const int co0 = blockIdx.y * COG;
  const int64_t v0 = blockIdx.z * a.spv + (int64_t)blockIdx.x * PASS_VOX;
  const int64_t send = (blockIdx.z + 1) * a.spv;   // the sample's end
  const int64_t vend = v0 + PASS_VOX < send ? v0 + PASS_VOX : send;
  const int64_t pc = blockIdx.z * a.pro_ns;   // the carry's rows
  const float* ds = a.ds + blockIdx.z * a.st_ns;
  const float* dq = a.dq + blockIdx.z * a.st_ns;
  if (threadIdx.x < 2 * COG) s_red[threadIdx.x / COG][threadIdx.x % COG] = 0;
  float st[8], sq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j] = sq[j] = 0.0f;
  for (int64_t v = v0 + threadIdx.x / 16; v < vend; v += NT / 16) {
    float y[8];
    upconv_value8_row<T>(a.vup, v, sub, co0 + 8 * g, y, pc);
    if constexpr (DYT) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[j] = dy_tot(0.0f, y[j], ds[co0 + 8 * g + j], dq[co0 + 8 * g + j]);
        st[j] += y[j];
      }
      store8(static_cast<T*>(a.dx) + out_voxel(a, v, sub) * a.cout + co0
                 + 8 * g,
             y);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        st[j] += y[j];
        sq[j] = fmaf(y[j], y[j], sq[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      st[j] += __shfl_xor_sync(0xffffffffu, st[j], off);
      sq[j] += __shfl_xor_sync(0xffffffffu, sq[j], off);
    }
  __syncthreads();  // s_red's initialization is visible
  if constexpr (DYT) {
    if (threadIdx.x % 32 < 4) {
#pragma unroll
      for (int j = 0; j < 8; ++j) atomicAdd(&s_red[0][8 * g + j], st[j]);
    }
    __syncthreads();
    if (threadIdx.x < COG)
      atomicAdd(a.s + co0 + threadIdx.x, s_red[0][threadIdx.x]);
    return;
  }
  // The warps in turn, then the chunk's partial row of its sample.
  for (int w = 0; w < NT / 32; ++w) {
    if (threadIdx.x / 32 == w && threadIdx.x % 32 < 4) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s_red[0][8 * g + j] += st[j];
        s_red[1][8 * g + j] += sq[j];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < COG) {
    float* const row = a.part
        + ((int64_t)blockIdx.z * gridDim.x + blockIdx.x) * 2 * a.cout + co0;
    row[threadIdx.x] = s_red[0][threadIdx.x];
    row[a.cout + threadIdx.x] = s_red[1][threadIdx.x];
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

// K7's two kernels: dgrad (when dx is given), then wgrad. dinv,
// dshift, dw and db must be zeroed by the caller.
int launch_upconv_bwd(const UpArgs& a, int dtype, void* stream) {
  const int64_t total = (int64_t)a.n * a.d * a.h * a.wd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == e3::DT_BF16;
  if (a.dx != nullptr) {
    // The per-sample grid (``part``): blocks of one sample's voxels.
    const int64_t nv = a.part != nullptr ? a.sv : total;
    const dim3 grid((unsigned)((nv + BV - 1) / BV), a.cin / BCI,
                    a.part != nullptr ? a.n : 1);
    if (bf16)
      upconv_dgrad_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(a);
    else
      upconv_dgrad_kernel<float><<<grid, NT, 0, st>>>(a);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  const int64_t ntiles = (total + WVT - 1) / WVT;
  const int per_split = (a.cin / BCI) * (a.cout / COG);
  int64_t splits = (4 * (int64_t)sm_count() + per_split - 1) / per_split;
  if (splits > ntiles) splits = ntiles;
  if (splits < 1) splits = 1;
  const dim3 grid((unsigned)splits, a.cin / BCI, a.cout / COG);
  if (bf16)
    upconv_wgrad_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(a);
  else
    upconv_wgrad_kernel<float><<<grid, NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The per-sample mode's partial rows a sample (ps_reduce.cuh): its
// blocks of 32 * (8 / (kd * 4)) input voxels.
extern "C" int64_t e3_upconv_bnact_ps_parts(int d, int h, int wd, int kd) {
  const int vpb = 32 * (8 / (kd * 4));
  return ((int64_t)d * h * wd + vpb - 1) / vpb;
}

// K3, float32 body (bf16 is e3_upconv_bnact_tc). ``pro_ns`` and ``ws``:
// the per-sample mode's, as e3_upconv_bnact_tc's (with
// e3_upconv_bnact_ps_parts rows a sample).
extern "C" int e3_upconv_bnact(int dtype, const void* x, const float* inv,
                               const float* shift, int pro_ns,
                               const float* wt, const float* bias, void* y,
                               float* s, float* q, float* ws, int n, int d,
                               int h, int wd, int cin, int cout, int kd,
                               int act, void* stream) {
  UpArgs a = {};
  a.x = x;
  a.inv = inv;
  a.shift = shift;
  a.wt = wt;
  a.bias = bias;
  a.y = y;
  a.s = s;
  a.q = q;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  a.kd = kd;
  a.act = act;
  a.pro_ns = pro_ns;
  a.part = ws;
  if (ws != nullptr) a.s = ws;   // the statistics' pass
  a.spv = pro_ns || ws != nullptr ? (int64_t)d * h * wd : 0;
  if (dtype != e3::DT_F32)  // bf16 runs e3_upconv_bnact_tc (upconv_tc.cu)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.spv && n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int vpb = 32 * (8 / (kd * 4));
  const int64_t total = a.spv ? a.spv : (int64_t)n * d * h * wd;
  const dim3 grid((unsigned)((total + vpb - 1) / vpb), cout / COG,
                  a.spv ? n : 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  upconv_bnact_kernel<float><<<grid, NT, 0, st>>>(a);
  cudaError_t rc = cudaGetLastError();
  if (rc == cudaSuccess && ws != nullptr)
    rc = ps_reduce(ws, n, e3_upconv_bnact_ps_parts(d, h, wd, kd), 2 * cout,
                   s, st);
  return static_cast<int>(rc);
}

// The per-sample mode's partial rows a sample of K7's CUDA-core dgrad
// (ps_reduce.cuh): its blocks of BV input voxels.
extern "C" int64_t e3_upconv_bnact_bwd_ps_parts(int d, int h, int wd) {
  return ((int64_t)d * h * wd + BV - 1) / BV;
}

// K7: dgrad (when dx is given) and wgrad. dinv, dshift, dw and db must
// be zeroed by the caller. The per-sample mode: ``st_ns`` (cout) for ds,
// dq rows of (n, cout); ``pro_ns`` (cin) for prologue rows of (n, cin),
// with a workspace ``ws`` (ps_workspace_floats of n samples,
// e3_upconv_bnact_bwd_ps_parts rows of 2 cin) when dx is given: dinv and
// dshift then come per sample, in a fixed order, as (n, 2, cin) in
// ``dinv`` (``dshift`` unused, nothing zeroed).
extern "C" int e3_upconv_bnact_bwd(int dtype, const void* x,
                                   const float* inv, const float* shift,
                                   int pro_ns, const float* wt,
                                   const void* dy, const void* y,
                                   const float* ds, const float* dq,
                                   int st_ns, void* dx, float* dinv,
                                   float* dshift, float* ws, float* dw,
                                   float* db, int n, int d, int h, int wd,
                                   int cin, int cout, int kd, int act,
                                   void* stream) {
  if (ws != nullptr && (n > 65535 || pro_ns != cin || dx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  UpArgs a = {};
  a.x = x;
  a.inv = inv;
  a.shift = shift;
  a.pro_ns = pro_ns;
  a.wt = wt;
  a.dy = dy;
  a.y = const_cast<void*>(y);  // the forward output, only read here
  a.ds = ds;
  a.dq = dq;
  a.st_ns = ds != nullptr ? st_ns : 0;
  a.dx = dx;
  a.dinv = dinv;
  a.dshift = dshift;
  a.part = ws;
  a.dw = dw;
  a.db = db;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  a.kd = kd;
  a.act = act;
  a.sv = (int64_t)d * h * wd;
  int rc = launch_upconv_bwd(a, dtype, stream);
  if (rc == 0 && ws != nullptr)
    rc = static_cast<int>(ps_reduce(ws, n, e3_upconv_bnact_bwd_ps_parts(
                                               d, h, wd),
                                    2 * cin, dinv,
                                    static_cast<cudaStream_t>(stream)));
  return rc;
}

namespace {

// The vup entries' K7 arguments. ``cc_ns``: the per-sample mode's
// carry prologue rows (K7's pro_ns, its rows found by the sample's
// voxels sv), 0 for the batch form.
UpArgs vup_up_args(const void* carry, const float* invc,
                   const float* shiftc, int cc_ns, const float* wu,
                   const float* bu, int n, int d, int h, int wd, int cc,
                   int cu, int actc) {
  UpArgs a = {};
  a.x = carry;
  a.inv = invc;
  a.shift = shiftc;
  a.wt = wu;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cin = cc;
  a.cout = cu;
  a.kd = 1;
  a.act = actc;
  a.vup = vup_args(carry, cc, invc, shiftc, wu, bu, cu, actc);
  a.pro_ns = cc_ns;
  a.spv = a.sv = (int64_t)d * h * wd;
  return a;
}

// The one-pass kernel over the carry's voxels, at most 8 blocks an SM;
// in the per-sample mode (PS) its (chunk, channel block, sample) grid.
template <bool DYT, bool PS = false>
int launch_upconv_pass(const UpArgs& a, int dtype, void* stream) {
  const int64_t total = (int64_t)a.n * a.d * a.h * a.wd;
  int64_t blocks = (total + NT / 16 - 1) / (NT / 16);
  const int64_t cap = 8 * (int64_t)sm_count();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, a.cout / COG);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (PS) {
    if (a.n > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 pgrid((unsigned)((a.spv + PASS_VOX - 1) / PASS_VOX),
                     a.cout / COG, a.n);
    if (dtype == e3::DT_BF16)
      upconv_pass_ps_kernel<__nv_bfloat16, DYT><<<pgrid, NT, 0, st>>>(a);
    else
      upconv_pass_ps_kernel<float, DYT><<<pgrid, NT, 0, st>>>(a);
  } else if (dtype == e3::DT_BF16) {
    upconv_pass_kernel<__nv_bfloat16, DYT><<<grid, NT, 0, st>>>(a);
  } else {
    upconv_pass_kernel<float, DYT><<<grid, NT, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7's two kernels on the chain's E; with ``ws`` (the per-sample mode)
// dinvc and dshiftc come per sample as (n, 2, cc) in ``a.dinv``.
int launch_chain(UpArgs& a, int dtype, float* ws, void* stream) {
  a.part = ws;
  int rc = launch_upconv_bwd(a, dtype, stream);
  if (rc == 0 && ws != nullptr)
    rc = static_cast<int>(ps_reduce(
        ws, a.n, e3_upconv_bnact_bwd_ps_parts(a.d, a.h, a.wd), 2 * a.cin,
        a.dinv, static_cast<cudaStream_t>(stream)));
  return rc;
}

}  // namespace

// The per-sample mode's partial rows a sample of row 22's CUDA-core pass
// (ps_reduce.cuh): its chunks of PASS_VOX carry voxels.
extern "C" int64_t e3_upconv_stats_ps_parts(int d, int h, int wd) {
  return ((int64_t)d * h * wd + PASS_VOX - 1) / PASS_VOX;
}

// Row 22: s and q (cu,) must be zeroed by the caller. (n, d, h, wd) are
// the carry's dims. The per-sample mode: ``cc_ns`` (cc) for the carry's
// prologue rows of (n, cc) and a workspace ``ws`` (ps_workspace_floats of
// n samples, e3_upconv_stats_ps_parts rows of 2 cu): the sums per sample,
// in a fixed order, as (n, 2, cu) in ``s`` (``q`` unused, nothing
// zeroed).
extern "C" int e3_upconv_stats(int dtype, const void* carry,
                               const float* invc, const float* shiftc,
                               int cc_ns, const float* wu, const float* bu,
                               float* s, float* q, float* ws, int n, int d,
                               int h, int wd, int cc, int cu, int actc,
                               void* stream) {
  UpArgs a = vup_up_args(carry, invc, shiftc, cc_ns, wu, bu, n, d, h, wd, cc,
                         cu, actc);
  a.s = s;
  a.q = q;
  if (ws == nullptr && cc_ns == 0)
    return launch_upconv_pass<false>(a, dtype, stream);
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.part = ws;
  const int rc = launch_upconv_pass<false, true>(a, dtype, stream);
  if (rc != 0) return rc;
  return static_cast<int>(ps_reduce(ws, n, e3_upconv_stats_ps_parts(d, h, wd),
                                    2 * cu, s,
                                    static_cast<cudaStream_t>(stream)));
}

// Row 23: from the statistics cotangents ds, dq (cu,), E = round(ds +
// 2 y dq) into ``e`` (n, d, 2 h, 2 wd, cu) and its float32 sum into dbu,
// then the chain into dcarry, dinvc, dshiftc and dwu. dbu, dinvc,
// dshiftc, dwu and ``db`` (cu,; K7's sum of E, not a result) must be
// zeroed by the caller. The per-sample mode: ``cc_ns`` (cc) and ``st_ns``
// (cu) for the (n, .) rows of the carry's prologue and of ds, dq, with a
// workspace ``ws`` (ps_workspace_floats of n samples,
// e3_upconv_bnact_bwd_ps_parts(d, h, wd) rows of 2 cc): dinvc and dshiftc
// per sample, in a fixed order, as (n, 2, cc) in ``dinvc`` (``dshiftc``
// unused); dwu and dbu global.
extern "C" int e3_upconv_stats_bwd(int dtype, const void* carry,
                                   const float* invc, const float* shiftc,
                                   int cc_ns, const float* wu,
                                   const float* bu, const float* ds,
                                   const float* dq, int st_ns, void* e,
                                   void* dcarry, float* dinvc,
                                   float* dshiftc, float* ws, float* dwu,
                                   float* dbu, float* db, int n, int d,
                                   int h, int wd, int cc, int cu, int actc,
                                   void* stream) {
  const bool ps = cc_ns != 0 || st_ns != 0 || ws != nullptr;
  if (ps && (cc_ns != cc || st_ns != cu || ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  UpArgs a = vup_up_args(carry, invc, shiftc, cc_ns, wu, bu, n, d, h, wd, cc,
                         cu, actc);
  a.ds = ds;
  a.dq = dq;
  a.st_ns = st_ns;
  a.dx = e;
  a.s = dbu;
  const int rc = ps ? launch_upconv_pass<true, true>(a, dtype, stream)
                    : launch_upconv_pass<true>(a, dtype, stream);
  if (rc != 0) return rc;
  UpArgs c = vup_up_args(carry, invc, shiftc, cc_ns, wu, nullptr, n, d, h,
                         wd, cc, cu, actc);
  c.dy = e;
  c.dx = dcarry;
  c.dinv = dinvc;
  c.dshift = dshiftc;
  c.dw = dwu;
  c.db = db;
  return launch_chain(c, dtype, ws, stream);
}

// Row 9's chain: from E (n, d, 2 h, 2 wd, cu), the rounded cotangent of
// the upconv output, into dcarry, dinvc, dshiftc and dwu (zeroed by the
// caller); ``db`` (cu,) receives K7's sum of E and is not a result. The
// per-sample mode: ``cc_ns`` (cc) for the carry's prologue rows of
// (n, cc), with a workspace ``ws`` as e3_upconv_stats_bwd's: dinvc and
// dshiftc per sample as (n, 2, cc) in ``dinvc``.
extern "C" int e3_conv_vup_chain(int dtype, const void* carry,
                                 const float* invc, const float* shiftc,
                                 int cc_ns, const float* wu, const void* e,
                                 void* dcarry, float* dinvc, float* dshiftc,
                                 float* ws, float* dwu, float* db, int n,
                                 int d, int h, int wd, int cc, int cu,
                                 int actc, void* stream) {
  if ((cc_ns != 0 || ws != nullptr) && (cc_ns != cc || ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  UpArgs a = vup_up_args(carry, invc, shiftc, cc_ns, wu, nullptr, n, d, h,
                         wd, cc, cu, actc);
  a.dy = e;
  a.dx = dcarry;
  a.dinv = dinvc;
  a.dshift = dshiftc;
  a.dw = dwu;
  a.db = db;
  return launch_chain(a, dtype, ws, stream);
}
