// The two bodies of the fused (kd, 3, 3) 'same' convolution, shared by
// K1 conv_bnact (forward, conv_bnact.cu) and K4 conv_bnact_dgrad (the
// input gradient, conv_bnact_bwd.cu). Both are the same implicit GEMM;
// they differ in the step that stages an input value and in the
// epilogue:
//
//   forward (DG = false): the staged value is the prologue
//     act(x * inv + shift) of input i (one or two inputs: the decoder's
//     concat merge is the list; the concat never exists in memory); the
//     epilogue adds the float32 bias, stores the output rounded to the
//     activation dtype and, when asked, sums each output channel's
//     value and square (the batch statistics of the STORED value).
//   dgrad (DG = true): the staged value is dy_tot = dy + ds + 2 y dq of
//     the forward output (the statistics cotangent folded in on load);
//     the weights are the forward's, flipped and transposed, so the
//     'same' conv of dy_tot is the gradient g of the prologued input;
//     the epilogue reads the forward input x, forms
//     gm = g * act'(x * inv + shift), stores dx = gm * inv rounded to
//     the dtype, and sums dinv = sum(gm * x) and dshift = sum(gm).
//
// The staged operand is rounded to the activation dtype before the
// multiply (forward: the prologued input; dgrad: dy_tot), exactly where
// the JAX kernels round it; the weights arrive rounded to that dtype;
// accumulation is float32.
//
// Cross-block sums (statistics, dinv, dshift) use float32 atomics: each
// warp first reduces its lanes with shuffles, each block its warps in
// shared memory, and one atomicAdd per channel and block goes to device
// memory. The order of those adds changes from run to run, so results
// agree with the plain version to float32 rounding of the sum (the
// tolerances of the tests and chip_smoke.py allow for it).
//
// Two bodies:
//   - the vup merge conv (forward and dgrad) in bfloat16 with every
//     staged channel count a multiple of 16 runs on the tensor cores: an
//     implicit GEMM over taps x 16-channel steps with WMMA 16x16x16 bf16
//     fragments and float32 accumulators (K1's plain bf16 forward runs
//     conv_tc.cu, K4's plain bf16 dgrad dgrad_tc.cu; neither launches
//     this one);
//   - float32, and any channel count, run on the CUDA cores: each
//     shared-memory weight read (a warp-wide broadcast of 4 output
//     channels) serves 2 output rows, and each staged input value 9
//     taps and 32 output channels.
// Zero padding is applied AFTER the load step (a halo voxel is 0, not
// act(0 * inv + shift)), so halo voxels carry no gradient either.
//
// The vup instantiations (VUP = true; the vup merge conv of
// conv_vup.cu, JAX's conv_bnact_flat_vup) take input 0 VIRTUAL: the
// (1, 2, 2) upconv of the deeper level's carry (ConvArgs::vup),
// recomputed per staged voxel by upconv_value8 (upconv_vup.cuh). The
// forward stages act(u * inv0 + shift0) of that value u; the dgrad
// epilogue recomputes u for act' and dinv0, and stores
// E = round(gm * inv0), the cotangent of the upconv output, where dx0
// would go. Every other instantiation compiles exactly as before.
#pragma once

#include <mma.h>

#include "common.cuh"
#include "upconv_vup.cuh"

namespace {

using namespace e3;

constexpr int TW = 32;          // output columns per block (one warp row)
constexpr int TYR = 8;          // thread rows per block
constexpr int RPT = 2;          // output rows per thread
constexpr int TH = TYR * RPT;   // output rows per block
constexpr int CK = 8;           // input channels staged per step
constexpr int COG = 32;         // output channels per block
constexpr int HH = TH + 2;      // staged rows (with halo)
constexpr int HW = TW + 2;      // staged columns (with halo)
constexpr int NT = TW * TYR;    // threads per block

struct ConvArgs {
  // Staged operand: the forward inputs, or (dgrad) dy as input 0.
  const void* x[2];
  const float* inv[2];
  const float* shift[2];
  int cin[2];
  int nin;
  const float* wt;    // (kd, 3, 3, cin[0] + cin[1], cout), float32
  const float* bias;  // (cout,), float32 (forward)
  void* y;            // (n, d, h, w, cout) output (forward)
  float* s;           // (cout,) sums of the stored output, or null
  float* q;           // (cout,) sums of squares, or null
  // dgrad only: dy_tot's operands and the forward inputs.
  const void* yv;     // forward output y (n, d, h, w, cin[0])
  const float* ds;    // (cin[0],) statistics cotangents, or null
  const float* dq;
  const void* xe[2];  // forward inputs; output channel c < ce[0] is x0's
  int ce[2];
  const float* einv;  // (ce[0] + ce[1],) forward prologue vectors
  const float* eshift;
  void* dx[2];        // input gradients, like xe
  float* dinv;        // (ce[0] + ce[1],) prologue gradients
  float* dshift;
  int n, d, h, wd, cout, kd, act;
  VupArgs vup;        // vup instantiations: input 0's carry (kd == 1)
};

// Load 8 (NC = 8) or 16 staged values of voxel ``vox`` from channel
// ``cb`` of operand i: the prologue of the input (forward) or dy_tot
// (dgrad), in float32, not yet rounded. The tensor-core body (NC = 16)
// stages whole 16-channel steps; the CUDA-core body (NC = 8) may meet a
// tail of fewer channels (C_in = 1 or 3), read as zeros.
template <bool DG, typename T, int NC>
__device__ __forceinline__ void load_operand(const ConvArgs& a, int i,
                                             int64_t vox, int cb,
                                             float* v) {
  const int ci = a.cin[i];
  const T* src = static_cast<const T*>(a.x[i]) + vox * ci + cb;
  auto load = [&](const T* p, float* out) {
#pragma unroll
    for (int g = 0; g < NC / 8; ++g) {
      if (NC == 16)
        load8(p + 8 * g, out + 8 * g);
      else
        load8_tail(p + 8 * g, ci, cb + 8 * g, out + 8 * g);
    }
  };
  load(src, v);
  if (DG) {
    if (a.ds != nullptr) {
      float yv[NC];
      load(static_cast<const T*>(a.yv) + vox * ci + cb, yv);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (NC == 16 || cb + c < ci)
          v[c] = dy_tot(v[c], yv[c], a.ds[cb + c], a.dq[cb + c]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (NC == 16 || cb + c < ci)
        v[c] = prologue(v[c], a.inv[i][cb + c], a.shift[i][cb + c], a.act);
  }
}

// The staged value of virtual input 0 (vup forward): the prologue
// act(u * inv0 + shift0) of the recomputed upconv output u at voxel
// (nz, gh, gw), nz the n * d + depth index; not yet rounded.
template <typename T, int NC>
__device__ __forceinline__ void vup_operand(const ConvArgs& a, int64_t nz,
                                            int gh, int gw, int cb,
                                            float* v) {
  const int64_t cv = vup_parent(nz, gh, gw, a.h, a.wd);
  const int sub = vup_sub(gh, gw);
#pragma unroll
  for (int g = 0; g < NC / 8; ++g)
    upconv_value8<T>(a.vup, cv, sub, cb + 8 * g, v + 8 * g);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    v[c] = prologue(v[c], a.inv[0][cb + c], a.shift[0][cb + c], a.act);
}

// One staged value group of operand i at voxel (gh, gw) of plane
// ``plane`` (= nz * h): load_operand, or the vup forward's virtual
// input 0.
template <bool DG, bool VUP, typename T, int NC>
__device__ __forceinline__ void stage_operand(const ConvArgs& a, int i,
                                              int64_t plane, int64_t nz,
                                              int gh, int gw, int cb,
                                              float* v) {
  if constexpr (VUP && !DG) {
    if (i == 0) {
      vup_operand<T, NC>(a, nz, gh, gw, cb, v);
      return;
    }
  }
  load_operand<DG, T, NC>(a, i, (plane + gh) * a.wd + gw, cb, v);
}

// Epilogue of 8 consecutive output channels o .. o + 7 of voxel ``vox``
// from their float32 sums ``acc``. Forward: bias, store, and (ST) the
// rounded values' sums into st (8 sums, then 8 sums of squares). Dgrad:
// the prologue gradient as described at the top; st gets dinv then
// dshift. ST is a template argument so that the forward without
// statistics (serving) keeps no sums in registers.
template <bool DG, bool ST, typename T, bool VUP = false>
__device__ __forceinline__ void epilogue8(const ConvArgs& a, int64_t vox,
                                          int o, const float* acc,
                                          float* st) {
  if (!DG) {
    float r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = acc[j] + a.bias[o + j];
    store8(static_cast<T*>(a.y) + vox * a.cout + o, r);
    if (!ST) return;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = round_to<T>(r[j]);
      st[j] += v;
      st[8 + j] = fmaf(v, v, st[8 + j]);
    }
    return;
  }
  const int i = o >= a.ce[0];
  const int cl = o - (i ? a.ce[0] : 0);
  const int ci = a.ce[i];
  float x[8], r[8];
  if constexpr (VUP) {
    if (i == 0) {  // the recomputed upconv output, the forward's bits
      const int ww = (int)(vox % a.wd);
      const int64_t t = vox / a.wd;
      upconv_value8<T>(a.vup, vup_parent(t / a.h, (int)(t % a.h), ww, a.h,
                                         a.wd),
                       vup_sub((int)(t % a.h), ww), cl, x);
    } else {
      load8(static_cast<const T*>(a.xe[i]) + vox * ci + cl, x);
    }
  } else {
    load8(static_cast<const T*>(a.xe[i]) + vox * ci + cl, x);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float inv = a.einv[o + j];
    const float gm = acc[j] * act_grad(pre_act(x[j], inv, a.eshift[o + j]),
                                       a.act);
    r[j] = gm * inv;
    st[j] = fmaf(gm, x[j], st[j]);
    st[8 + j] += gm;
  }
  store8(static_cast<T*>(a.dx[i]) + vox * ci + cl, r);
}

// Add a block's per-channel partial sums (COG channels, two quantities)
// into the device-memory totals: shared memory, then one atomic per
// channel.
__device__ __forceinline__ void flush_block_sums(float (*red)[COG],
                                                 float* out0, float* out1,
                                                 int co0) {
  __syncthreads();
  if (threadIdx.x < COG) {
    atomicAdd(out0 + co0 + threadIdx.x, red[0][threadIdx.x]);
    atomicAdd(out1 + co0 + threadIdx.x, red[1][threadIdx.x]);
  }
}

template <bool DG, bool ST, typename T, bool VUP = false>
__global__ void __launch_bounds__(NT) conv_body_kernel(const ConvArgs a) {
  __shared__ float s_in[CK][HH][HW];
  __shared__ __align__(16) float s_w[9][CK][COG];
  __shared__ float s_red[2][COG];

  const int tx = threadIdx.x % TW;
  const int ty = threadIdx.x / TW;
  const int tiles_w = (a.wd + TW - 1) / TW;
  const int tiles = ((a.h + TH - 1) / TH) * tiles_w;
  const int tile = blockIdx.x % tiles;
  const int nd = blockIdx.x / tiles;  // n * d + depth index
  const int h0 = (tile / tiles_w) * TH;
  const int w0 = (tile % tiles_w) * TW;
  const int n = nd / a.d;
  const int d = nd % a.d;
  const int co0 = blockIdx.z * COG;
  const int ct = a.cin[0] + a.cin[1];
  if (threadIdx.x < 2 * COG) s_red[threadIdx.x / COG][threadIdx.x % COG] = 0;

  float acc[RPT][COG];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int o = 0; o < COG; ++o) acc[r][o] = 0.0f;

  int coff = 0;  // first weight input channel of input i
  for (int i = 0; i < a.nin; ++i) {
    const int ci = a.cin[i];
    for (int dz = 0; dz < a.kd; ++dz) {
      const int zd = d + dz - a.kd / 2;
      if (zd < 0 || zd >= a.d) continue;  // zero padding in depth
      const int64_t plane = (int64_t)(n * a.d + zd) * a.h;
      for (int cb = 0; cb < ci; cb += CK) {
        __syncthreads();  // the previous step's reads are done
        for (int p = threadIdx.x; p < HH * HW; p += NT) {
          const int hy = p / HW;
          const int hx = p % HW;
          const int gh = h0 + hy - 1;
          const int gw = w0 + hx - 1;
          float v[CK];
          if (gh >= 0 && gh < a.h && gw >= 0 && gw < a.wd) {
            stage_operand<DG, VUP, T, CK>(a, i, plane, (int64_t)n * a.d + zd,
                                          gh, gw, cb, v);
#pragma unroll
            for (int c = 0; c < CK; ++c)
              v[c] = (cb + c < ci) ? round_to<T>(v[c]) : 0.0f;
          } else {
#pragma unroll
            for (int c = 0; c < CK; ++c) v[c] = 0.0f;
          }
#pragma unroll
          for (int c = 0; c < CK; ++c) s_in[c][hy][hx] = v[c];
        }
        for (int q = threadIdx.x; q < 9 * CK * COG; q += NT) {
          const int o = q % COG;
          const int c = (q / COG) % CK;
          const int t = q / (COG * CK);
          s_w[t][c][o] = (cb + c < ci)
              ? a.wt[((int64_t)(dz * 9 + t) * ct + coff + cb + c) * a.cout
                    + co0 + o]
              : 0.0f;
        }
        __syncthreads();
#pragma unroll 1
        for (int t = 0; t < 9; ++t) {
          const int ky = t / 3;
          const int kx = t % 3;
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            float av[RPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r)
              av[r] = s_in[c][ty * RPT + r + ky][tx + kx];
            const float4* wr = reinterpret_cast<const float4*>(&s_w[t][c][0]);
#pragma unroll
            for (int q = 0; q < COG / 4; ++q) {
              const float4 wv = wr[q];
#pragma unroll
              for (int r = 0; r < RPT; ++r) {
                acc[r][4 * q + 0] = fmaf(av[r], wv.x, acc[r][4 * q + 0]);
                acc[r][4 * q + 1] = fmaf(av[r], wv.y, acc[r][4 * q + 1]);
                acc[r][4 * q + 2] = fmaf(av[r], wv.z, acc[r][4 * q + 2]);
                acc[r][4 * q + 3] = fmaf(av[r], wv.w, acc[r][4 * q + 3]);
              }
            }
          }
        }
      }
    }
    coff += ci;
  }

  // Epilogue: st[q] collects this thread's partial sums (statistics or
  // prologue gradients) of channels 8q .. 8q + 7 over its rows.
  float st[COG / 8][16];
#pragma unroll
  for (int q = 0; q < COG / 8; ++q)
#pragma unroll
    for (int j = 0; j < 16; ++j) st[q][j] = 0.0f;
  const int w = w0 + tx;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int h = h0 + ty * RPT + r;
    if (h >= a.h || w >= a.wd) continue;
    const int64_t vox = ((int64_t)nd * a.h + h) * a.wd + w;
#pragma unroll
    for (int q = 0; q < COG / 8; ++q)
      epilogue8<DG, ST, T, VUP>(a, vox, co0 + 8 * q, &acc[r][8 * q],
                                st[q]);
  }
  if (!ST) return;
  float st0[COG], st1[COG];
#pragma unroll
  for (int q = 0; q < COG / 8; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      st0[8 * q + j] = st[q][j];
      st1[8 * q + j] = st[q][8 + j];
    }
  const float t0 = warp_reduce_scatter32(st0);
  const float t1 = warp_reduce_scatter32(st1);
  __syncthreads();  // s_red's initialization is visible
  atomicAdd(&s_red[0][threadIdx.x % 32], t0);
  atomicAdd(&s_red[1][threadIdx.x % 32], t1);
  if (DG)
    flush_block_sums(s_red, a.dinv, a.dshift, co0);
  else
    flush_block_sums(s_red, a.s, a.q, co0);
}

// Tensor-core body (bfloat16, staged channel counts % 16 == 0). Block:
// 8 warps, one output row each, MW columns; a warp holds SEG x 2
// accumulator fragments (16 voxels x 16 output channels each).
constexpr int MW = 64;              // output columns per block
constexpr int MH = 8;               // output rows per block (warps)
constexpr int MCK = 16;             // input channels per step (MMA depth)
constexpr int MHH = MH + 2;         // staged rows (with halo)
constexpr int MHW = MW + 2;         // staged columns (with halo)
constexpr int SEG = MW / 16;        // 16-voxel segments per warp

template <bool DG, bool ST, bool VUP = false>
__global__ void __launch_bounds__(256) conv_body_mma_kernel(
    const ConvArgs a) {
  using namespace nvcuda;
  // Staged operand: position (row, col) holds MCK channels.
  __shared__ __align__(128) __nv_bfloat16 s_in[MHH * MHW * MCK];
  __shared__ __align__(128) __nv_bfloat16 s_w[9 * MCK * COG];
  __shared__ __align__(128) float s_out[MH][16 * 16];
  __shared__ float s_red[2][COG];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles_w = (a.wd + MW - 1) / MW;
  const int tiles = ((a.h + MH - 1) / MH) * tiles_w;
  const int tile = blockIdx.x % tiles;
  const int nd = blockIdx.x / tiles;
  const int h0 = (tile / tiles_w) * MH;
  const int w0 = (tile % tiles_w) * MW;
  const int n = nd / a.d;
  const int d = nd % a.d;
  const int co0 = blockIdx.z * COG;
  const int ct = a.cin[0] + a.cin[1];
  if (threadIdx.x < 2 * COG) s_red[threadIdx.x / COG][threadIdx.x % COG] = 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[SEG][2];
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    wmma::fill_fragment(acc[s][0], 0.0f);
    wmma::fill_fragment(acc[s][1], 0.0f);
  }

  int coff = 0;
  for (int i = 0; i < a.nin; ++i) {
    const int ci = a.cin[i];
    for (int dz = 0; dz < a.kd; ++dz) {
      const int zd = d + dz - a.kd / 2;
      if (zd < 0 || zd >= a.d) continue;  // zero padding in depth
      const int64_t plane = (int64_t)(n * a.d + zd) * a.h;
      for (int cb = 0; cb < ci; cb += MCK) {
        __syncthreads();  // the previous step's fragment loads are done
        for (int p = threadIdx.x; p < MHH * MHW; p += 256) {
          const int gh = h0 + p / MHW - 1;
          const int gw = w0 + p % MHW - 1;
          float v[MCK];
          if (gh >= 0 && gh < a.h && gw >= 0 && gw < a.wd) {
            stage_operand<DG, VUP, __nv_bfloat16, MCK>(
                a, i, plane, (int64_t)n * a.d + zd, gh, gw, cb, v);
          } else {
#pragma unroll
            for (int c = 0; c < MCK; ++c) v[c] = 0.0f;
          }
          // Staging as bf16 is the rounding to the activation dtype.
          store8(&s_in[p * MCK], v);
          store8(&s_in[p * MCK + 8], v + 8);
        }
        // s_w[t][c][o], rounded exactly (the weights are bf16 values).
        for (int q = threadIdx.x; q < 9 * MCK * COG; q += 256) {
          const int o = q % COG;
          const int c = (q / COG) % MCK;
          const int t = q / (COG * MCK);
          s_w[q] = __float2bfloat16_rn(
              a.wt[((int64_t)(dz * 9 + t) * ct + coff + cb + c) * a.cout
                   + co0 + o]);
        }
        __syncthreads();
#pragma unroll 1
        for (int t = 0; t < 9; ++t) {
          const int ky = t / 3;
          const int kx = t % 3;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b0, b1;
          wmma::load_matrix_sync(b0, &s_w[t * MCK * COG], COG);
          wmma::load_matrix_sync(b1, &s_w[t * MCK * COG + 16], COG);
#pragma unroll
          for (int s = 0; s < SEG; ++s) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> af;
            wmma::load_matrix_sync(
                af, &s_in[((warp + ky) * MHW + s * 16 + kx) * MCK], MCK);
            wmma::mma_sync(acc[s][0], af, b0, acc[s][0]);
            wmma::mma_sync(acc[s][1], af, b1, acc[s][1]);
          }
        }
      }
    }
    coff += ci;
  }

  // Epilogue: each fragment goes through the warp's shared scratch;
  // lane l takes voxel l / 2, output channels (l % 2) * 8 .. + 8 of the
  // fragment, and keeps its per-channel partial sums in st[f].
  const int h = h0 + warp;
  const int vox_l = lane / 2;
  const int half = lane % 2;
  float st[2][16];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 16; ++j) st[f][j] = 0.0f;
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      wmma::store_matrix_sync(s_out[warp], acc[s][f], 16,
                              wmma::mem_row_major);
      __syncwarp();
      const int w = w0 + s * 16 + vox_l;
      if (h < a.h && w < a.wd) {
        float r[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          r[j] = s_out[warp][vox_l * 16 + half * 8 + j];
        epilogue8<DG, ST, __nv_bfloat16, VUP>(
            a, ((int64_t)nd * a.h + h) * a.wd + w, co0 + f * 16 + half * 8,
            r, st[f]);
      }
      __syncwarp();
    }
  }
  if (!ST) return;
  // Lanes of one parity hold the same channels: sum over the other
  // four lane bits, then lanes 0 and 1 add their 16 x 2 channels.
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int off = 2; off < 32; off <<= 1)
        st[f][j] += __shfl_xor_sync(0xffffffffu, st[f][j], off);
  __syncthreads();  // s_red's initialization is visible
  if (lane < 2) {
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        atomicAdd(&s_red[0][f * 16 + lane * 8 + j], st[f][j]);
        atomicAdd(&s_red[1][f * 16 + lane * 8 + j], st[f][8 + j]);
      }
  }
  if (DG)
    flush_block_sums(s_red, a.dinv, a.dshift, co0);
  else
    flush_block_sums(s_red, a.s, a.q, co0);
}

// Launch the body that fits: tensor cores for the vup instantiations in
// bf16 when every staged channel count is a multiple of 16 (K1's and
// K4's plain bf16 bodies are conv_tc.cu and dgrad_tc.cu, so their WMMA
// instantiations are not compiled, nor K4's bf16 CUDA-core one, which
// this launch refuses), else the CUDA cores. ST: the block
// sums (statistics, or dinv and dshift). grid.x walks the (h, w) tiles
// of every (n, depth) slab, the slab index outermost, so N * D is not
// bounded by grid.y's 65535; a grid.x past 2^31 - 1 is refused.
template <bool DG, bool ST, bool VUP = false>
cudaError_t launch_conv_body_st(const ConvArgs& a, int dtype,
                                cudaStream_t s) {
  const bool mma = VUP && dtype == DT_BF16 && a.cin[0] % MCK == 0
      && (a.nin < 2 || a.cin[1] % MCK == 0);
  const int64_t tiles = mma
      ? (int64_t)((a.h + MH - 1) / MH) * ((a.wd + MW - 1) / MW)
      : (int64_t)((a.h + TH - 1) / TH) * ((a.wd + TW - 1) / TW);
  const int64_t blocks = tiles * a.n * a.d;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, 1, a.cout / COG);
  if constexpr (VUP) {
    if (mma) {
      conv_body_mma_kernel<DG, ST, VUP><<<grid, 256, 0, s>>>(a);
      return cudaSuccess;
    }
  }
  if (dtype != DT_BF16) {
    conv_body_kernel<DG, ST, float, VUP><<<grid, NT, 0, s>>>(a);
  } else if constexpr (DG && !VUP) {
    return cudaErrorInvalidValue;   // K4's bf16 body is dgrad_tc.cu
  } else {
    conv_body_kernel<DG, ST, __nv_bfloat16, VUP><<<grid, NT, 0, s>>>(a);
  }
  return cudaSuccess;
}

template <bool DG, bool VUP = false>
int launch_conv_body(const ConvArgs& a, int dtype, cudaStream_t s) {
  cudaError_t rc;
  if constexpr (DG)
    rc = launch_conv_body_st<true, true, VUP>(a, dtype, s);
  else if (a.s != nullptr)
    rc = launch_conv_body_st<false, true, VUP>(a, dtype, s);
  else
    rc = launch_conv_body_st<false, false, VUP>(a, dtype, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
