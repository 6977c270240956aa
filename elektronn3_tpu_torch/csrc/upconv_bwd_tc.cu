// K7 upconv_bnact_bwd, bfloat16 bodies: the merged backward of K3's
// transposed convolution whose kernel equals its stride, (1, 2, 2) or
// (2, 2, 2), as two GEMMs on the tensor cores. Input voxel v feeds the
// nsub = kd * 4 output voxels out(v, sub), one per weight tap sub =
// (a, b, c), so
//   dgrad: g[v, ci] = sum over (sub, co) of dy_tot[out(v, sub), co]
//                     * W[sub, ci, co],
//          then gm = g * act'(x * inv + shift) (float32), dx = gm * inv
//          rounded once, dinv = sum(gm * x), dshift = sum(gm);
//   wgrad: dW[sub, ci, co] = sum over v of a[v, ci]
//                            * dy_tot[out(v, sub), co],
//          with a the RECOMPUTED prologued input rounded to bf16, and
//          db = sum of the float32 dy_tot.
// dy_tot = dy + ds + 2 y dq is formed in float32 and rounded to bf16
// before either product: with a statistics cotangent, by a pre-pass
// (launch_dytot, below) that reads dy and y once, writes the rounded
// dy_tot into a scratch of dy's shape and sums db from the float32
// values; the two GEMMs then read that scratch as their dy. The function, its rounding points and its
// plain version are those of upconv_bnact.cu, which keeps the CUDA-core
// bodies for float32 (whose tests hold 1e-4 of the scale) and for the
// vup path's chain (e3_conv_vup_chain, and e3_upconv_stats_bwd where it
// runs, call them by name, whatever the dtype).
//
// Replaces, for bf16, the TPU kernels listed in upconv_bnact.cu:
//   ops/flat_fused64.py::_upconv64_bwd, _upconv122_64_bwd,
//   _upconv122_f64_bwd, _upconv_f64in_bwd_call; ops/flat_fused.py::
//   _upconv_bwd.
//
// What bounds it on the card: the bytes. Both products do 2 * C_in
// FLOP per dy value (16 to 256 FLOP per byte moved at the main path's
// shapes, under the H100's ridge of 295), and dy and y are the largest
// tensors (kd * 4 times x's voxels). The design reads them few times:
//   - dgrad: a block takes BM = 128 input voxels and NB = 32, 64 or 128
//     input channels (grid.y splits C_in = 256), M = voxels, N = C_in,
//     K = nsub * C_out. The A operand is the dy rows at the voxels'
//     nsub output voxels, gathered with 16-byte cp.async (zero-filled
//     past the end), 4 k16 steps a stage in a 2-stage ring. The B
//     operand is K3's packed weight
//     (pack_upconv_weight: (C_in / 16, nsub * C_out, 16)), whose rows
//     are K-major, read through ldmatrix .trans. 8 warps, each 32 input
//     channels x 16 to 64 voxels of mma.sync m16n8k16. The epilogue
//     works on the accumulator registers: the prologue's gradient, dx
//     stored two channels a lane, dinv and dshift by shuffles, shared
//     atomics and one device atomic per channel and block. It reads dy
//     once per input-channel block: once, twice at C_in = 256.
//   - wgrad: nsub GEMMs of C_in x C_out over K = the input voxels. A
//     block owns a slice of CS = 32 (kd = 2) or 64 (kd = 1) input
//     channels and 64 output channels and walks a strided share of
//     tiles of 32 (kd = 2) or 64 (kd = 1) voxels: x's tile (prologued in place, rounded, 0 past the
//     end) and the dy rows of the tile's nsub * 32 output voxels, in a
//     2-stage cp.async ring (without a statistics cotangent the blocks
//     of the first slice sum db from the staged dy). Warp w takes tap
//     w % nsub and 32 input channels: 2 x 8 m16n8 tiles, 64 float32
//     sums a lane, added into dW once at the end. Both operands are
//     voxel-major, so both come through ldmatrix .trans. It reads dy
//     once per input-channel slice (C_in / CS times: 4 at the (2, 2, 2)
//     128 -> 64, once at the (1, 2, 2) 64 -> 32); the slices of one
//     tile are consecutive blocks, so L2 serves the repeats.
// So dy and y are read once by the pre-pass, and dy_tot 1 + C_in / CS
// times (2 + C_in / CS at C_in = 256) by the GEMMs. Staging y in the
// GEMMs instead (one in-place pass per stage) read y as often as dy and
// halved the wgrad's occupancy: 1.3 to 2 times slower at the main
// path's shapes on the H100.
// Staged rows are padded to an odd number of 16-byte units (or, for the
// dgrad's 32-byte k16 rows, XOR-swizzled as in tc.cuh), so the 8 rows
// of an ldmatrix phase are conflict-free.
//
// mma.sync rather than wgmma, as in upconv_tc.cu: the bytes, not the
// tensor-core rate, set the bound here, and mma.sync's fragments let
// the epilogue work on registers whose layout this file controls.
//
// The per-sample mode (group and instance norm): ds, dq and the prologue
// are (n, C) rows at sample strides (0 for the batch form). The pre-pass
// reads the row of each voxel's sample. With an (n, cin) prologue the
// dgrad's grid is (block of a sample, channel block, sample), so no block
// spans two samples: it stages its sample's prologue row, and its dinv
// and dshift go, in a fixed order (its warps' shuffles, then its rows of
// warps in turn), into its partial row, which ps_reduce (ps_reduce.cuh)
// sums in a fixed order; the wgrad's tiles may span two samples, so its
// prologue pass reads each voxel's sample's row. dW and db stay global.
#include "ps_reduce.cuh"
#include "tc.cuh"

namespace {

using namespace e3;

constexpr int NT = 256;   // 8 warps

struct UpBwdArgs {
  const __nv_bfloat16* x;    // (n, d, h, w, cin)
  const float* inv;          // (cin,), or null (identity prologue)
  const float* shift;
  int pro_ns;                // per sample: (n, cin) rows' stride, or 0
  int64_t sv;                // input voxels of a sample (d * h * w)
  float* part;               // per sample: dinv, dshift partial rows
  const __nv_bfloat16* wp;   // (cin / 16, nsub * cout, 16) packed weight
  const __nv_bfloat16* dy;   // (n, kd * d, 2 h, 2 w, cout): dy_tot
  __nv_bfloat16* dx;         // (n, d, h, w, cin), or null (no dgrad)
  float* dinv;               // (cin,), zeroed
  float* dshift;
  float* dw;                 // (kd, 2, 2, cin, cout), zeroed
  float* db;                 // (cout,), zeroed; null: the pre-pass sums
  int n, d, h, wd, cin, cout, kd, act;
  int combos, splits;        // wgrad's grid
};

// Output voxel of sub-position (0, 0, 0) of input voxel v, or -1 past
// the end; a sub-position adds sub_off.
__device__ __forceinline__ int64_t out_base(const UpBwdArgs& a, int64_t v,
                                            int64_t total) {
  if (v >= total) return -1;
  const int ww = (int)(v % a.wd);
  const int64_t t = v / a.wd;
  const int hh = (int)(t % a.h);
  const int64_t nd = t / a.h;
  return (((nd / a.d) * (a.d * a.kd) + (nd % a.d) * a.kd) * (2 * a.h)
          + 2 * hh) * (2 * (int64_t)a.wd) + 2 * ww;
}

__device__ __forceinline__ int64_t sub_off(const UpBwdArgs& a, int sub) {
  const int64_t row = 2 * (int64_t)a.wd;
  return (sub >> 2) * (2 * a.h) * row + ((sub >> 1) & 1) * row + (sub & 1);
}

// ---------------------------------------------------------------- dgrad

constexpr int BM = 128;   // input voxels per block
constexpr int KS = 4;     // k16 steps per stage

template <int NB>
struct DCfg {
  static constexpr int WARPS_N = NB / 32;        // 1, 2, 4
  static constexpr int WARPS_M = 8 / WARPS_N;    // 8, 4, 2
  static constexpr int WM = BM / WARPS_M;        // 16, 32, 64
  static constexpr int MI = WM / 16;             // m16 tiles a warp
  static constexpr int ABYTES = KS * BM * 32;    // dy of a stage
  static constexpr int BBYTES = KS * NB * 32;    // weights of a stage
  static constexpr int STAGE = ABYTES + BBYTES;  // a ring slot
};

template <int NB>
size_t dgrad_smem() {
  return (size_t)2 * DCfg<NB>::STAGE + (size_t)BM * 8 + (size_t)4 * NB * 4;
}

template <int NB, bool PRO>
__global__ void __launch_bounds__(NT, 2)
upconv_dgrad_tc_kernel(const UpBwdArgs a) {
  using C = DCfg<NB>;
  constexpr int STAGE = C::STAGE;
  extern __shared__ __align__(128) unsigned char smem[];
  int64_t* s_ob = reinterpret_cast<int64_t*>(smem + 2 * STAGE);  // [BM]
  float* s_inv = reinterpret_cast<float*>(s_ob + BM);            // [NB]
  float* s_shift = s_inv + NB;
  float* s_red = s_shift + NB;                                   // [2][NB]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / C::WARPS_N;
  const int wn = warp % C::WARPS_N;
  // The per-sample grid's block covers voxels of sample blockIdx.z only.
  const bool psg = a.part != nullptr;
  const int64_t vbase = psg ? blockIdx.z * a.sv : 0;
  const int64_t total = psg ? vbase + a.sv
                            : (int64_t)a.n * a.d * a.h * a.wd;
  const int64_t v0 = vbase + (int64_t)blockIdx.x * BM;
  const int ci0 = blockIdx.y * NB;
  const int64_t po = (int64_t)blockIdx.z * a.pro_ns;   // its prologue row
  const int ccn = a.cout / 16;               // k16 steps per sub-position
  const int nk = a.kd * 4 * ccn;             // k16 steps
  const int nstages = (nk + KS - 1) / KS;
  const int ncol = a.kd * 4 * a.cout;
  const int kg = a.cin / 16;                 // 16-channel groups of C_in

  for (int r = tid; r < BM; r += NT) s_ob[r] = out_base(a, v0 + r, total);
  for (int c = tid; c < NB; c += NT) {
    s_inv[c] = PRO && ci0 + c < a.cin ? a.inv[po + ci0 + c] : 1.0f;
    s_shift[c] = PRO && ci0 + c < a.cin ? a.shift[po + ci0 + c] : 0.0f;
    s_red[c] = s_red[NB + c] = 0.0f;
  }
  __syncthreads();  // s_ob is read by the loads

  auto load = [&](int st) {
    if (st < nstages) {
      unsigned char* sa = smem + (st % 2) * STAGE;
      unsigned char* sb = sa + C::ABYTES;
      const int nkk = min(KS, nk - st * KS);
      for (int p = tid; p < nkk * BM * 2; p += NT) {
        const int hf = p & 1;
        const int r = (p >> 1) % BM;
        const int kk = (p >> 1) / BM;
        const int kst = st * KS + kk;
        const int sub = kst / ccn;
        const int64_t ob = s_ob[r];
        const int64_t off = ob >= 0
            ? (ob + sub_off(a, sub)) * a.cout + (kst % ccn) * 16 + hf * 8
            : 0;
        cp_async16(smem_u32(sa + kk * (BM * 32) + swz(r, hf)), a.dy + off,
                   ob >= 0);
      }
      for (int p = tid; p < nkk * NB * 2; p += NT) {
        const int hf = p & 1;
        const int row = p >> 1;          // (kk, group, k row)
        const int krow = row % 16;
        const int grp = (row / 16) % (NB / 16);
        const int kk = row / NB;
        const bool ok = ci0 / 16 + grp < kg;
        cp_async16(smem_u32(sb + swz(row, hf)),
                   ok ? a.wp + ((int64_t)(ci0 / 16 + grp) * ncol
                                + (st * KS + kk) * 16 + krow) * 16 + hf * 8
                      : a.wp,
                   ok);
      }
    }
    cp_async_commit();
  };

  float acc[C::MI][4][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;

  // The lane's ldmatrix rows: A (voxel rows, plain) and B (k rows of
  // the warp's two 16-channel groups, transposed).
  const uint32_t arow = swz(wm * C::WM + (lane & 15), lane >> 4);
  const uint32_t brow = swz((lane & 7) + 8 * ((lane >> 3) & 1), lane >> 4)
      + wn * 2 * 16 * 32;

  load(0);
  for (int st = 0; st < nstages; ++st) {
    cp_async_wait<0>();  // stage st has landed
    __syncthreads();     // for every thread; stage st - 1's MMAs done
    load(st + 1);
    unsigned char* sa = smem + (st % 2) * STAGE;
    const int nkk = min(KS, nk - st * KS);
    const uint32_t ua = smem_u32(sa) + arow;
    const uint32_t ub = smem_u32(sa + C::ABYTES) + brow;
    for (int kk = 0; kk < nkk; ++kk) {
      uint32_t bf[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t q[4];
        ldmatrix_x4_trans(ub + (kk * (NB / 16) + p) * 16 * 32, q);
        bf[2 * p][0] = q[0];
        bf[2 * p][1] = q[1];
        bf[2 * p + 1][0] = q[2];
        bf[2 * p + 1][1] = q[3];
      }
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi) {
        uint32_t af[4];
        ldmatrix_x4(ua + kk * (BM * 32) + mi * 16 * 32, af);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_bf16_16816(acc[mi][nj], af, bf[nj][0], bf[nj][1]);
      }
    }
  }

  // Epilogue from the accumulators: lane (g, t4) holds voxels g and
  // g + 8 of each m16 tile, input channels 2 t4 and 2 t4 + 1 of each n8
  // tile.
  const int g = lane / 4;
  const int t4 = lane % 4;
  float si[4][2], ss[4][2];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int cl = wn * 32 + nj * 8 + 2 * t4;    // channel in the block
    const int c = ci0 + cl;
    si[nj][0] = si[nj][1] = ss[nj][0] = ss[nj][1] = 0.0f;
    if (c >= a.cin) continue;
    const float i0 = s_inv[cl], i1 = s_inv[cl + 1];
    const float h0 = s_shift[cl], h1 = s_shift[cl + 1];
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int64_t v = v0 + wm * C::WM + mi * 16 + g + 8 * hr;
        if (v >= total) continue;
        float gm0 = acc[mi][nj][2 * hr];
        float gm1 = acc[mi][nj][2 * hr + 1];
        const int64_t off = v * a.cin + c;
        if (PRO) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(a.x + off));
          gm0 *= act_grad(pre_act(xv.x, i0, h0), a.act);
          gm1 *= act_grad(pre_act(xv.y, i1, h1), a.act);
          si[nj][0] += gm0 * xv.x;
          si[nj][1] += gm1 * xv.y;
          ss[nj][0] += gm0;
          ss[nj][1] += gm1;
          gm0 *= i0;
          gm1 *= i1;
        }
        *reinterpret_cast<__nv_bfloat162*>(a.dx + off) =
            __floats2bfloat162_rn(gm0, gm1);
      }
  }
  if (!PRO) return;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        si[nj][e] += __shfl_xor_sync(0xffffffffu, si[nj][e], off);
        ss[nj][e] += __shfl_xor_sync(0xffffffffu, ss[nj][e], off);
      }
  if (psg) {
    // The per-sample mode: the rows of warps in turn (the warps of a row
    // hold distinct channels), then the block's partial row, slot
    // blockIdx.x of sample blockIdx.z.
    for (int r = 0; r < C::WARPS_M; ++r) {
      if (wm == r && g == 0) {
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = wn * 32 + nj * 8 + 2 * t4 + e;
            s_red[cl] += si[nj][e];
            s_red[NB + cl] += ss[nj][e];
          }
      }
      __syncthreads();
    }
    float* const row = a.part
        + ((int64_t)blockIdx.z * gridDim.x + blockIdx.x) * 2 * a.cin;
    for (int c = tid; c < NB && ci0 + c < a.cin; c += NT) {
      row[ci0 + c] = s_red[c];
      row[a.cin + ci0 + c] = s_red[NB + c];
    }
    return;
  }
  if (g == 0) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = wn * 32 + nj * 8 + 2 * t4 + e;
        atomicAdd(&s_red[cl], si[nj][e]);
        atomicAdd(&s_red[NB + cl], ss[nj][e]);
      }
  }
  __syncthreads();
  for (int c = tid; c < NB && ci0 + c < a.cin; c += NT) {
    atomicAdd(a.dinv + ci0 + c, s_red[c]);
    atomicAdd(a.dshift + ci0 + c, s_red[NB + c]);
  }
}

// ---------------------------------------------------------------- wgrad

constexpr int COB = 64;       // output channels per block
constexpr int DP = COB * 2 + 16;   // dy row pitch, bytes (9 x 16)

template <int NSUB>
struct WCfg {
  // Input voxels per tile: 64 at kd = 1, 32 at kd = 2, where 64 would
  // make the ring 157 KB and leave one block an SM (12% faster and 18%
  // slower than 32 at the main path's shapes on the H100).
  static constexpr int TV = NSUB == 4 ? 64 : 32;
  static constexpr int CS = 256 / NSUB;          // 32 or 64 channels
  static constexpr int XP = CS * 2 + 16;         // x row pitch, bytes
  static constexpr int XBYTES = TV * XP;
  static constexpr int GBYTES = NSUB * TV * DP;  // dy of a tile
  static constexpr int STAGE = XBYTES + GBYTES;  // a ring slot
};

template <int NSUB>
size_t wgrad_smem() {
  return (size_t)2 * WCfg<NSUB>::STAGE + (size_t)2 * WCfg<NSUB>::CS * 4
      + (size_t)COB * 4;
}

template <int NSUB, bool PRO>
__global__ void __launch_bounds__(NT)
upconv_wgrad_tc_kernel(const UpBwdArgs a) {
  using C = WCfg<NSUB>;
  constexpr int STAGE = C::STAGE;
  constexpr int TV = C::TV;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_inv = reinterpret_cast<float*>(smem + 2 * STAGE);   // [CS]
  float* s_shift = s_inv + C::CS;
  float* s_db = s_shift + C::CS;                               // [COB]

  const int tid = threadIdx.x;
  const int nsl = (a.cin + C::CS - 1) / C::CS;
  const int combo = (int)(blockIdx.x % a.combos);
  const int split = (int)(blockIdx.x / a.combos);
  const int slice = combo % nsl;
  const int cb = slice * C::CS;
  const int co0 = (combo / nsl) * COB;
  const int cw = min(C::CS, a.cin - cb);
  const bool do_db = slice == 0 && a.db != nullptr;
  const int64_t total = (int64_t)a.n * a.d * a.h * a.wd;
  const int64_t ntiles = (total + TV - 1) / TV;
  if (split >= ntiles) return;

  for (int c = tid; c < C::CS; c += NT) {
    s_inv[c] = PRO && c < cw ? a.inv[cb + c] : 1.0f;
    s_shift[c] = PRO && c < cw ? a.shift[cb + c] : 0.0f;
  }
  for (int c = tid; c < COB; c += NT) s_db[c] = 0.0f;

  // Thread tid stages (and sums for db) the dy rows of tile voxels
  // tid / 8 + 32 k, 8 output channels (tid % 8), for every sub-position.
  const int gv = tid / 8;
  const int gch = tid % 8;
  const bool gch_ok = co0 + gch * 8 < a.cout;
  auto load = [&](int64_t t, int slot) {
    unsigned char* sx = smem + slot * STAGE;
    for (int p = tid; p < TV * (C::CS / 8); p += NT) {
      const int ch = p % (C::CS / 8);
      if (ch * 8 >= cw) continue;
      const int64_t v = t * TV + p / (C::CS / 8);
      const bool ok = v < total;
      cp_async16(smem_u32(sx + (p / (C::CS / 8)) * C::XP + ch * 16),
                 ok ? a.x + v * a.cin + cb + ch * 8 : a.x, ok);
    }
    unsigned char* sg = sx + C::XBYTES;
#pragma unroll
    for (int k = 0; k < TV / 32; ++k) {
      const int64_t ob = out_base(a, t * TV + gv + 32 * k, total);
      const bool ok = ob >= 0 && gch_ok;
#pragma unroll
      for (int sub = 0; sub < NSUB; ++sub) {
        const int64_t off = ok
            ? (ob + sub_off(a, sub)) * a.cout + co0 + gch * 8 : 0;
        const uint32_t dst = (sub * TV + gv + 32 * k) * DP + gch * 16;
        cp_async16(smem_u32(sg + dst), a.dy + off, ok);
      }
    }
  };

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int sub = warp % NSUB;
  const int mg = warp / NSUB;                 // 32-channel group
  // Row addresses of the transposed loads: A (x: voxels 0-7 / 8-15,
  // channel halves), B (dy: voxels 0-7 / 8-15, n8 tiles 2p, 2p + 1).
  const uint32_t a_lane = ((lane & 7) + 8 * (lane >> 4)) * C::XP
      + mg * 64 + ((lane >> 3) & 1) * 16;
  const uint32_t b_lane = (sub * TV + (lane & 7) + 8 * ((lane >> 3) & 1))
      * DP + (lane >> 4) * 16;
  const int nmt = min(2, max(0, (cw - mg * 32) / 16));   // active m16
  const int npair = min(4, (a.cout - co0) / 16);         // active n16

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nj][e] = 0.0f;
  float dbl[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) dbl[j] = 0.0f;

  load(split, 0);
  cp_async_commit();
  int slot = 0;
  for (int64_t t = split; t < ntiles; t += a.splits, slot ^= 1) {
    cp_async_wait<0>();  // tile t has landed
    __syncthreads();     // for every thread; the other slot is free
    if (t + a.splits < ntiles) load(t + a.splits, slot ^ 1);
    cp_async_commit();
    unsigned char* sx = smem + slot * STAGE;
    unsigned char* sg = sx + C::XBYTES;
    if (do_db) {
      // Rows past the end and channels past C_out were zero-filled.
#pragma unroll
      for (int s = 0; s < NSUB * TV / 32; ++s) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            sg + (s * 32 + gv) * DP + gch * 16);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          dbl[2 * j] += f.x;
          dbl[2 * j + 1] += f.y;
        }
      }
    }
    if (PRO) {
      if (a.pro_ns == 0) {
        for (int p = tid; p < TV * (C::CS / 8); p += NT) {
          const int ch = p % (C::CS / 8);
          if (ch * 8 >= cw) continue;
          prologue_half(reinterpret_cast<uint4*>(
                            sx + (p / (C::CS / 8)) * C::XP + ch * 16),
                        s_inv + ch * 8, s_shift + ch * 8, a.act,
                        t * TV + p / (C::CS / 8) < total);
        }
      } else {
        // The per-sample mode: the row of each voxel's sample (a tile
        // may span two), from device memory.
        for (int p = tid; p < TV * (C::CS / 8); p += NT) {
          const int ch = p % (C::CS / 8);
          if (ch * 8 >= cw) continue;
          const int64_t v = t * TV + p / (C::CS / 8);
          const int64_t po = v < total ? v / a.sv * a.pro_ns + cb + ch * 8
                                       : 0;
          prologue_half(reinterpret_cast<uint4*>(
                            sx + (p / (C::CS / 8)) * C::XP + ch * 16),
                        a.inv + po, a.shift + po, a.act, v < total);
        }
      }
      __syncthreads();
    }
    const uint32_t ua = smem_u32(sx) + a_lane;
    const uint32_t ub = smem_u32(sg) + b_lane;
#pragma unroll
    for (int ks = 0; ks < TV / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt < nmt) ldmatrix_x4_trans(ua + ks * 16 * C::XP + mt * 32,
                                        af[mt]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p >= npair) break;
        uint32_t q[4];
        ldmatrix_x4_trans(ub + ks * 16 * DP + p * 32, q);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt >= nmt) break;
          mma_bf16_16816(acc[mt][2 * p], af[mt], q[0], q[1]);
          mma_bf16_16816(acc[mt][2 * p + 1], af[mt], q[2], q[3]);
        }
      }
    }
  }

  // dW[sub]: lane (g, t4) holds input channels g and g + 8 of each m16
  // tile, output channels 2 t4 and 2 t4 + 1 of each n8 tile.
  const int g = lane / 4;
  const int t4 = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt >= nmt) break;
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      if (nj >= 2 * npair) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = cb + mg * 32 + mt * 16 + g + 8 * (e >> 1);
        const int co = co0 + nj * 8 + 2 * t4 + (e & 1);
        atomicAdd(a.dw + ((int64_t)sub * a.cin + c) * a.cout + co,
                  acc[mt][nj][e]);
      }
    }
  }
  if (do_db) {
    __syncthreads();  // s_db's initialization is visible
#pragma unroll
    for (int j = 0; j < 8; ++j) atomicAdd(&s_db[gch * 8 + j], dbl[j]);
    __syncthreads();
    for (int c = tid; c < COB && co0 + c < a.cout; c += NT)
      atomicAdd(a.db + co0 + c, s_db[c]);
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

template <int NB, bool PRO>
cudaError_t launch_dgrad(const UpBwdArgs& a, cudaStream_t stream) {
  const size_t smem = dgrad_smem<NB>();
  auto kern = upconv_dgrad_tc_kernel<NB, PRO>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  // The per-sample grid (``part``): blocks of one sample's voxels.
  const int64_t total = a.part != nullptr
      ? a.sv : (int64_t)a.n * a.d * a.h * a.wd;
  const int64_t blocks = (total + BM - 1) / BM;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (a.cin + NB - 1) / NB,
                  a.part != nullptr ? a.n : 1);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NB>
cudaError_t dgrad_nb(const UpBwdArgs& a, cudaStream_t st) {
  return a.inv != nullptr ? launch_dgrad<NB, true>(a, st)
                          : launch_dgrad<NB, false>(a, st);
}

// One wave of wgrad blocks: as many splits of every (slice, output
// block) combo as fill the SMs at the kernel's occupancy, at most one a
// tile.
template <int NSUB, bool PRO>
cudaError_t launch_wgrad(UpBwdArgs a, cudaStream_t stream) {
  const size_t smem = wgrad_smem<NSUB>();
  auto kern = upconv_wgrad_tc_kernel<NSUB, PRO>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                     smem);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t total = (int64_t)a.n * a.d * a.h * a.wd;
  const int64_t ntiles = (total + WCfg<NSUB>::TV - 1) / WCfg<NSUB>::TV;
  a.combos = ((a.cin + WCfg<NSUB>::CS - 1) / WCfg<NSUB>::CS)
      * ((a.cout + COB - 1) / COB);
  int64_t splits = (int64_t)per_sm * sm_count() / a.combos;
  if (splits > ntiles) splits = ntiles;
  if (splits < 1) splits = 1;
  a.splits = (int)splits;
  const int64_t blocks = splits * a.combos;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NSUB>
cudaError_t wgrad_nsub(const UpBwdArgs& a, cudaStream_t st) {
  return a.inv != nullptr ? launch_wgrad<NSUB, true>(a, st)
                          : launch_wgrad<NSUB, false>(a, st);
}

// The pre-pass: thread t of a block of ``nt`` (a multiple of c / 8)
// owns channels 8 (t % (c / 8)) to + 8 of every voxel it visits, so it
// sums db in registers; then shared atomics, then one device atomic per
// channel and block. In the per-sample mode a thread reloads its ds and
// dq where its voxel's sample changes (rarely: a thread's voxels are a
// grid's stride apart).
__global__ void __launch_bounds__(256)
dytot_kernel(const __nv_bfloat16* dy, const __nv_bfloat16* y,
             const float* ds, const float* dq, int st_ns, int64_t spv,
             __nv_bfloat16* e, float* db, int64_t nchunks, int c) {
  __shared__ float s_db[kDytotMaxC];
  for (int i = threadIdx.x; i < c; i += blockDim.x) s_db[i] = 0.0f;
  __syncthreads();
  int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int c0 = (int)(p % (c / 8)) * 8;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float sds[8], sdq[8], acc[8];
  auto rows = [&](int64_t smp) {   // sample smp's ds and dq
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sds[j] = ds[smp * st_ns + c0 + j];
      sdq[j] = dq[smp * st_ns + c0 + j];
    }
  };
  auto chunk = [&](int64_t q) {
    uint4 u = reinterpret_cast<const uint4*>(dy)[q];
    const uint4 yv = reinterpret_cast<const uint4*>(y)[q];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    const __nv_bfloat162* hy = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 g = __bfloat1622float2(h[j]);
      const float2 t = __bfloat1622float2(hy[j]);
      const float v0 = dy_tot(g.x, t.x, sds[2 * j], sdq[2 * j]);
      const float v1 = dy_tot(g.y, t.y, sds[2 * j + 1], sdq[2 * j + 1]);
      acc[2 * j] += v0;
      acc[2 * j + 1] += v1;
      h[j] = __floats2bfloat162_rn(v0, v1);
    }
    reinterpret_cast<uint4*>(e)[q] = u;
  };
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
  if (st_ns == 0) {
    rows(0);
    for (; p < nchunks; p += stride) chunk(p);
  } else {
    int64_t cur = -1;   // the sample whose rows sds and sdq hold
    for (; p < nchunks; p += stride) {
      const int64_t smp = p / (c / 8) / spv;
      if (smp != cur) {
        cur = smp;
        rows(smp);
      }
      chunk(p);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) atomicAdd(&s_db[c0 + j], acc[j]);
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += blockDim.x) atomicAdd(db + i, s_db[i]);
}

}  // namespace

namespace e3 {

cudaError_t launch_dytot(const __nv_bfloat16* dy, const __nv_bfloat16* y,
                         const float* ds, const float* dq, int st_ns,
                         int64_t spv, __nv_bfloat16* e, float* db,
                         int64_t voxels, int c, cudaStream_t stream) {
  if (c % 8 || c > kDytotMaxC || c / 8 > 256 || (st_ns && spv < 1))
    return cudaErrorInvalidValue;
  const int nt = 256 - 256 % (c / 8);
  const int64_t nchunks = voxels * (c / 8);
  int64_t blocks = (nchunks + nt - 1) / nt;
  if (blocks > 8 * (int64_t)sm_count()) blocks = 8 * (int64_t)sm_count();
  if (blocks < 1) blocks = 1;
  dytot_kernel<<<(unsigned)blocks, nt, 0, stream>>>(dy, y, ds, dq, st_ns,
                                                    spv, e, db, nchunks, c);
  return cudaGetLastError();
}

}  // namespace e3

// The per-sample mode's partial rows a sample of K7's tensor-core dgrad
// (ps_reduce.cuh): its blocks of BM input voxels.
extern "C" int64_t e3_upconv_bnact_bwd_tc_ps_parts(int d, int h, int wd) {
  return ((int64_t)d * h * wd + BM - 1) / BM;
}

// K7, bf16 bodies: with a statistics cotangent (``ds``, ``dq``) the
// pre-pass into ``e`` (a scratch of dy's shape) and db, else db from the
// wgrad; then the dgrad (when ``dx`` is given) into dx, dinv and dshift,
// and the wgrad into dw (kd, 2, 2, cin, cout). dinv, dshift, dw and db
// are float32, zeroed by the caller. ``wp`` is K3's packed (cin / 16,
// kd * 4 * cout, 16) bf16 weight; ``inv``/``shift`` null means the
// identity prologue (dinv, dshift untouched); ``ds``/``dq`` null means
// no statistics cotangent (``y`` and ``e`` are then not used). The
// per-sample mode: ``st_ns`` (cout) for ds, dq rows of (n, cout);
// ``pro_ns`` (cin) for prologue rows of (n, cin), with a workspace ``ws``
// (ps_workspace_floats of n samples, e3_upconv_bnact_bwd_tc_ps_parts
// rows of 2 cin) when dx is given: dinv and dshift then come per sample,
// in a fixed order, as (n, 2, cin) in ``dinv`` (``dshift`` unused,
// nothing zeroed). Needs cin % 16 == 0 and cout % 32 == 0.
extern "C" int e3_upconv_bnact_bwd_tc(const void* x, const float* inv,
                                      const float* shift, int pro_ns,
                                      const void* wp, const void* dy,
                                      const void* y, const float* ds,
                                      const float* dq, int st_ns, void* e,
                                      void* dx, float* dinv, float* dshift,
                                      float* ws, float* dw, float* db, int n,
                                      int d, int h, int wd, int cin,
                                      int cout, int kd, int act,
                                      void* stream) {
  if (cin % 16 || cout % 32 || (kd != 1 && kd != 2)
      || (ds != nullptr && e == nullptr)
      || (ws != nullptr && (inv == nullptr || pro_ns != cin || n > 65535
                            || dx == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  UpBwdArgs a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.inv = inv;
  a.shift = shift;
  a.pro_ns = inv != nullptr ? pro_ns : 0;
  a.sv = (int64_t)d * h * wd;
  a.part = ws;
  a.wp = static_cast<const __nv_bfloat16*>(wp);
  a.dy = static_cast<const __nv_bfloat16*>(dy);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.dinv = dinv;
  a.dshift = dshift;
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
  cudaError_t rc = cudaSuccess;
  if (ds != nullptr) {
    rc = e3::launch_dytot(a.dy, static_cast<const __nv_bfloat16*>(y), ds, dq,
                          st_ns, (int64_t)d * h * wd * kd * 4,
                          static_cast<__nv_bfloat16*>(e), db,
                          (int64_t)n * d * h * wd * kd * 4, cout, st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    a.dy = static_cast<const __nv_bfloat16*>(e);
    a.db = nullptr;
  }
  if (dx != nullptr) {
    rc = cin % 128 == 0 ? dgrad_nb<128>(a, st)
        : cin % 64 == 0 ? dgrad_nb<64>(a, st) : dgrad_nb<32>(a, st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  rc = kd == 2 ? wgrad_nsub<8>(a, st) : wgrad_nsub<4>(a, st);
  if (rc == cudaSuccess && ws != nullptr)
    rc = ps_reduce(ws, n, e3_upconv_bnact_bwd_tc_ps_parts(d, h, wd),
                   2 * cin, dinv, st);
  return static_cast<int>(rc);
}
