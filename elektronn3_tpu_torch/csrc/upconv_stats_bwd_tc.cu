// Rows 22 and 23, upconv_stats and upconv_stats_bwd, bfloat16 bodies.
//
// Row 22 (upconv_stats_tc_kernel): the per-channel float32 sum and sum of
// squares of the rounded (1, 2, 2) upconv u of the carry, u never
// stored. It is row 23's GEMM 1 with a statistics epilogue: a block walks
// tiles of BM = 64 carry voxels (the raw carry in a 2-stage cp.async
// ring, prologued and rounded in place into a), recomputes u with
// vup_mma on K3's packed weight (staged once a block) and vup_round, and
// sums each lane's rounded values in registers for its walk; at the end
// shuffles over the lanes of a channel, shared atomics, then one device
// atomic per channel and block, as K3's tensor-core epilogue. Replaces,
// for bf16, ops/flat_fused64.py::upconv122_stats_from_flat64 (its
// pallas_call); float32 keeps upconv_bnact.cu's pass (upconv_value8).
// What bounds it: the carry's bytes (0.026 ms at bench.py's up_2) against
// 2 x 64 x 128 FLOP a carry voxel on the tensor cores.
//
// Row 23: the backward of the vup path's statistics pass (row 22) as ONE
// kernel on the tensor cores. Row 22 sums the (1, 2, 2) upconv u of the carry into u's batch statistics
// without storing u; its backward takes the statistics cotangents ds, dq
// (C_u,) to the carry, its prologue and the upconv's weight and bias.
// Per carry voxel v, with x the raw carry and prec = x * invc + shiftc:
//   a = round(act_c(prec));
//   y[sub] = round(bu + a . Wu[sub])              (the recompute);
//   e = ds + 2 y dq in float32: dbu sums e, E = round(e);
//   g = sum over sub of E[sub] . Wu[sub]^T;
//   gm = g * act_c'(prec): dinvc = sum(gm * x), dshiftc = sum(gm),
//   dcarry = round(gm * invc);
//   dWu[sub] = sum over v of a^T E[sub].
// The function, its rounding points and its plain version
// (vup.upconv_stats_bwd_plain) are those of the CUDA-core path in
// upconv_bnact.cu (e3_upconv_stats_bwd: one pass writes E into a scratch
// of u's shape, then K7's CUDA-core bodies on it), which float32 keeps.
//
// Replaces, for bf16, the TPU kernel of the JAX package
//   ops/flat_fused64.py::_upconv122_stats_bwd (its pallas_call), which
//   returns dchunk, dM0, dM1, dbl, dinv and dshift from one call whose E
//   never leaves VMEM.
//
// What bounds it on the card: the bytes. A (1, 2, 2) upconv of stride
// (1, 2, 2) is local to one carry voxel, so the whole backward is three
// small GEMMs on a tile of carry voxels: it must read the carry once and
// write dcarry once (2 x 87.2 MB at bench.py's (8, 44, 44, 44, 64),
// 0.052 ms at 3.35 TB/s), against 33.5 GFLOP (0.034 ms at 989 TFLOP/s).
// The design keeps E and y on the chip:
//   - a block walks a strided share of tiles of BM = 64 carry voxels
//     over the flat N * D * H2 * W2 index (no grid-dimension limit; the
//     ragged end is zero-filled and masked); it stages K3's packed
//     weight (cc / 16, 4 cu, 16) once, and the raw carry tile in a
//     2-stage cp.async ring, kept raw for dinvc and act' beside a
//     prologued, rounded copy a;
//   - GEMM 1, the recompute (vup_mma, upconv_vup.cuh): Y = a Wu, M = 64,
//     N = 4 cu, K = cc; its epilogue, on the accumulator registers, forms
//     y, e, the dbu partials and E, stored as bf16 into shared memory
//     (64 x 4 cu, 16 KB at cu = 32), never to device memory;
//   - GEMM 2, the dgrad: G = E Wu^T, M = 64, N = cc, K = 4 cu, B the same
//     packed weight through ldmatrix .trans (as K7's tensor-core dgrad
//     reads it); its epilogue is K7's: gm, dcarry stored two channels a
//     lane, dinvc and dshiftc in registers across tiles;
//   - GEMM 3, the wgrad: dWu += a^T E, M = cc, N = 4 cu, K = 64; both
//     operands voxel-major in shared memory, so both through ldmatrix
//     .trans (as in K5's and K7's tensor-core wgrads); the cc x 4 cu
//     float32 sums (32 a lane at 64 x 32) live for the block's walk;
//   - at the end, shuffles, shared atomics and one float32 device atomic
//     per weight, channel and block (their order, hence the last bits,
//     changes from run to run).
// dbu is summed from the float32 e, never from E, as JAX sums it; K7's
// "db of E" scratch and the 174.4 MB scratch E of the CUDA-core path do
// not exist here. Template cases: cc in {32, 64, 96, 128} and cu in
// {32, 64} (vup.vup_body names the CUDA-core path for others).
//
// mma.sync rather than wgmma and TMA, as in the other tensor-core
// bodies (upconv_tc.cu, wgrad_tc.cu, upconv_bwd_tc.cu): the
// bytes, not the tensor-core rate, set the bound; the three GEMMs are
// 64 rows deep and chained through shared memory in one block, and
// mma.sync's fragments let the epilogues work on registers whose layout
// this file controls.
//
// The per-sample mode of both rows (group and instance norm; JAX's
// want_stats='per_sample', flat_fused64.py:2930, and its backward) runs
// kernels of its own (the batch ones keep their code): a tile of BM
// carry voxels never spans two samples (a sample's voxel count need not
// be a multiple of BM: its last tile is ragged and masked). A block walks
// a strided share of groups of PS_TILES consecutive tiles of one sample;
// the carry's prologue and ds, dq are that sample's rows (staged in
// shared memory where the walk enters another sample); at the end of
// each group its sums (row 22: u's sums and sums of squares; row 23:
// dinvc and dshiftc), each warp's in its own slot of shared memory and
// the slots summed in a fixed order, go into the group's partial row of
// its sample, which ps_reduce sums in a fixed order into (n, 2, C): the
// same bits on every run and for every batch size. Row 23's dWu and dbu
// stay global.
#include "ps_reduce.cuh"
#include "tc.cuh"
#include "upconv_vup.cuh"

namespace {

using namespace e3;

constexpr int BM = VBM;   // carry voxels a tile
constexpr int NT = 256;   // 8 warps

struct StatsBwdArgs {
  const __nv_bfloat16* x;    // (total, cc) raw carry
  const float* invc;         // (cc,) its prologue
  const float* shiftc;
  const __nv_bfloat16* wp;   // (cc / 16, 4 cu, 16) packed upconv weight
  const float* bu;           // (cu,) float32 bias
  const float* ds;           // (cu,) statistics cotangents
  const float* dq;
  __nv_bfloat16* dx;         // (total, cc) dcarry
  float* dinv;               // (cc,), zeroed
  float* dshift;
  float* dw;                 // (2, 2, cc, cu), zeroed
  float* db;                 // (cu,), zeroed
  int64_t total;             // carry voxels
  int act;
};

// The per-sample kernels' arguments (a type of their own, so that the
// batch kernels' stay as they were): the rows' sample strides (invc,
// shiftc: cc; ds, dq: cu), the carry voxels of a sample, the samples and
// the groups' partial rows (n, groups of a sample, 2 cc or 2 cu).
struct StatsPsArgs : StatsBwdArgs {
  int cc_ns, st_ns;
  int64_t spv;
  int n;
  float* part;
};

// The per-sample mode's tiles of a group: the group's sums go into its
// partial row at its end (each warp's into its own slot of shared
// memory, one barrier, the slots summed in a fixed order). Short groups
// keep the blocks' shares of the walk even.
constexpr int PS_TILES = 4;

// The groups of a sample of ``spv`` carry voxels.
inline int64_t e3_ps_groups(int64_t spv) {
  return ((spv + BM - 1) / BM + PS_TILES - 1) / PS_TILES;
}

// The per-sample walk: step j of a block is tile j % PS_TILES of group
// blockIdx.x + (j / PS_TILES) gridDim.x; a group is PS_TILES tiles of
// one sample (those past the sample's end masked empty). ``at`` gives
// the tile's first voxel v0 and its sample's end vend (valid rows r:
// v0 + r < vend), false past the block's last group.
struct PsWalk {
  int64_t tps, gps, ngroups;
  __device__ PsWalk(const StatsPsArgs& a)
      : tps((a.spv + BM - 1) / BM), gps((tps + PS_TILES - 1) / PS_TILES),
        ngroups(a.n * gps) {}
  __device__ bool at(const StatsPsArgs& a, int64_t j, int64_t& v0,
                     int64_t& vend, int64_t& smp, int64_t& grp) const {
    grp = blockIdx.x + (j / PS_TILES) * gridDim.x;
    if (grp >= ngroups) return false;
    smp = grp / gps;
    v0 = smp * a.spv + ((grp % gps) * PS_TILES + j % PS_TILES) * BM;
    vend = (smp + 1) * a.spv;
    return true;
  }
};

// Stage the raw carry rows v0 .. v0 + BM (zero-filled from vend on).
template <int CC>
__device__ __forceinline__ void load_rows(const StatsPsArgs& a,
                                          unsigned char* dst, int xp,
                                          int64_t v0, int64_t vend) {
  for (int i = threadIdx.x; i < BM * (CC / 8); i += NT) {
    const int r = i / (CC / 8);
    const int ch = i % (CC / 8);
    const int64_t v = v0 + r;
    const bool ok = v < vend;
    cp_async16(smem_u32(dst + r * xp + ch * 16),
               ok ? a.x + v * CC + ch * 8 : a.x, ok);
  }
}

template <int CC, int CU>
struct SCfg : ChainCfg<CC, CU> {
  using B = ChainCfg<CC, CU>;
  static constexpr int XBYTES = BM * B::XP;
  static constexpr int EBYTES = BM * B::EP;
  static constexpr int VECS = 4 * CC + 4 * CU;   // floats
  static constexpr int SMEM = B::WBYTES + 3 * XBYTES + EBYTES + VECS * 4;
  static constexpr int CHUNKS = B::NCOL / 128;   // GEMM 1 column chunks
  // Two blocks an SM where the GEMM 3 sums (CC * CU / 64 a lane) leave
  // room for them.
  static constexpr int MIN_BLOCKS = CC * CU <= 2048 ? 2 : 1;
  // Row 22: the weight, the ring and a, the vectors and the block sums.
  static constexpr int STATS_SMEM = B::WBYTES + 3 * XBYTES
      + (2 * CC + 3 * CU) * 4;
  // The per-sample kernels: the staged sample's invc and shiftc, bu, then
  // row 23's ds and dq of that sample, its dbu sums and the warp rows'
  // slots of dinvc and dshiftc (4 x 2 CC), or row 22's warps' slots of
  // the sums (8 x 2 CU).
  static constexpr int PS_SMEM = B::WBYTES + 3 * XBYTES + EBYTES
      + (10 * CC + 4 * CU) * 4;
  static constexpr int PS_STATS_SMEM = B::WBYTES + 3 * XBYTES
      + (2 * CC + 17 * CU) * 4;
};

template <int CC, int CU>
__global__ void __launch_bounds__(NT, SCfg<CC, CU>::MIN_BLOCKS)
upconv_stats_bwd_tc_kernel(const StatsBwdArgs a) {
  using C = SCfg<CC, CU>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_w = smem;                    // [CC/16][NCOL][32], swz
  unsigned char* s_x = s_w + C::WBYTES;         // 2 x [BM][XP] raw ring
  unsigned char* s_a = s_x + 2 * C::XBYTES;     // [BM][XP] prologued
  unsigned char* s_e = s_a + C::XBYTES;         // [BM][EP] E
  float* s_inv = reinterpret_cast<float*>(s_e + C::EBYTES);   // [CC]
  float* s_shift = s_inv + CC;
  float* s_bu = s_shift + CC;                   // [CU]
  float* s_ds = s_bu + CU;
  float* s_dq = s_ds + CU;
  float* s_red = s_dq + CU;                     // [2 CC + CU]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int64_t ntiles = (a.total + BM - 1) / BM;

  for (int c = tid; c < CC; c += NT) {
    s_inv[c] = a.invc[c];
    s_shift[c] = a.shiftc[c];
    s_red[c] = s_red[CC + c] = 0.0f;
  }
  for (int c = tid; c < CU; c += NT) {
    s_bu[c] = a.bu[c];
    s_ds[c] = a.ds[c];
    s_dq[c] = a.dq[c];
    s_red[2 * CC + c] = 0.0f;
  }
  // The packed weight, once: row kc * NCOL + column, two 16-byte halves.
  for (int i = tid; i < CC / 16 * C::NCOL * 2; i += NT)
    cp_async16(smem_u32(s_w + swz(i >> 1, i & 1)),
               a.wp + (int64_t)(i >> 1) * 16 + (i & 1) * 8, true);

  auto load = [&](int64_t t, int slot) {
    unsigned char* dst = s_x + slot * C::XBYTES;
    for (int i = tid; i < BM * (CC / 8); i += NT) {
      const int r = i / (CC / 8);
      const int ch = i % (CC / 8);
      const int64_t v = t * BM + r;
      const bool ok = v < a.total;
      cp_async16(smem_u32(dst + r * C::XP + ch * 16),
                 ok ? a.x + v * CC + ch * 8 : a.x, ok);
    }
  };
  load(blockIdx.x, 0);
  cp_async_commit();

  // Warp layouts. GEMM 1: 2 (32 rows) x 4 (32 columns of a 128-column
  // chunk); GEMMs 2 and 3 as the chain's (upconv_vup.cuh).
  const int wm1 = warp % 2, wn1 = warp / 2;
  const int wm2 = warp % 4, wn2 = warp / 4;
  const uint32_t a1_lane = smem_u32(s_a) + (wm1 * 32 + (lane & 15)) * C::XP
      + (lane >> 4) * 16;
  const uint32_t w1_lane = smem_u32(s_w)
      + swz((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  const ChainLanes<CC, CU> lanes(s_e, s_w, s_a, warp, lane);

  float acc3[C::MI3][C::NJ3][4];
#pragma unroll
  for (int mt = 0; mt < C::MI3; ++mt)
#pragma unroll
    for (int nj = 0; nj < C::NJ3; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc3[mt][nj][e] = 0.0f;
  float si[C::NJ2][2], ss[C::NJ2][2], dbl[4][2];
#pragma unroll
  for (int nj = 0; nj < C::NJ2; ++nj)
    si[nj][0] = si[nj][1] = ss[nj][0] = ss[nj][1] = 0.0f;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) dbl[nj][0] = dbl[nj][1] = 0.0f;

  int slot = 0;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, slot ^= 1) {
    cp_async_wait<0>();  // tile t (and the weight) has landed
    __syncthreads();     // for every thread; the other slot is free
    if (t + gridDim.x < ntiles) load(t + gridDim.x, slot ^ 1);
    cp_async_commit();
    const unsigned char* sx = s_x + slot * C::XBYTES;
    const int64_t v0 = t * BM;

    // a = round(act_c(x * invc + shiftc)), 0 past the end.
    for (int i = tid; i < BM * (CC / 8); i += NT) {
      const int r = i / (CC / 8);
      const int ch = i % (CC / 8);
      uint4* d = reinterpret_cast<uint4*>(s_a + r * C::XP + ch * 16);
      *d = *reinterpret_cast<const uint4*>(sx + r * C::XP + ch * 16);
      prologue_half(d, s_inv + ch * 8, s_shift + ch * 8, a.act,
                    v0 + r < a.total);
    }
    __syncthreads();

    // GEMM 1, the recompute; epilogue: y, e = ds + 2 y dq, the dbu
    // partials of e, and E = round(e) into s_e (0 past the end).
#pragma unroll
    for (int j = 0; j < C::CHUNKS; ++j) {
      const int col[2] = {j * 128 + wn1 * 32, j * 128 + wn1 * 32 + 16};
      float acc[2][4][4];
      vup_mma<2, 2>(a1_lane, C::XP, w1_lane, col, C::NCOL, CC / 16, acc);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int cl = col[0] + nj * 8 + 2 * t4;
        const int co = cl % CU;
        const float b0 = s_bu[co], b1 = s_bu[co + 1];
        const float ds0 = s_ds[co], ds1 = s_ds[co + 1];
        const float dq0 = s_dq[co], dq1 = s_dq[co + 1];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = wm1 * 32 + mi * 16 + g + 8 * hr;
            const bool ok = v0 + r < a.total;
            const float e0 = dy_tot(0.0f, vup_round(acc[mi][nj][2 * hr], b0),
                                    ds0, dq0);
            const float e1 = dy_tot(
                0.0f, vup_round(acc[mi][nj][2 * hr + 1], b1), ds1, dq1);
            if (ok) {
              dbl[nj][0] += e0;
              dbl[nj][1] += e1;
            }
            *reinterpret_cast<uint32_t*>(s_e + r * C::EP + cl * 2) =
                ok ? pack_bf16x2(e0, e1) : 0u;
          }
      }
    }
    __syncthreads();

    // GEMM 2, the dgrad, G = E Wu^T; K7's epilogue into dcarry.
    {
      float acc[C::NJ2][4];
      chain_gemm2<CC, CU>(lanes, wn2, acc);
      chain_dcarry<CC>(acc, sx, s_inv, s_shift, a.act, wm2, wn2, lane,
                       [&](int r) -> int64_t {
                         return v0 + r < a.total ? v0 + r : -1;
                       },
                       a.dx, si, ss);
    }

    // GEMM 3, the wgrad, dWu[sub3] += a^T E[sub3].
    chain_gemm3<CC, CU>(lanes, acc3);
  }

  chain_dw_flush<CC, CU>(acc3, a.dw, warp, lane);
  // dinvc, dshiftc and dbu: the lanes of one t4 hold the same channels.
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
    for (int nj = 0; nj < C::NJ2; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        si[nj][e] += __shfl_xor_sync(0xffffffffu, si[nj][e], off);
        ss[nj][e] += __shfl_xor_sync(0xffffffffu, ss[nj][e], off);
      }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dbl[nj][e] += __shfl_xor_sync(0xffffffffu, dbl[nj][e], off);
  }
  if (g == 0) {
#pragma unroll
    for (int nj = 0; nj < C::NJ2; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wn2 * (CC / 2) + nj * 8 + 2 * t4 + e;
        atomicAdd(&s_red[c], si[nj][e]);
        atomicAdd(&s_red[CC + c], ss[nj][e]);
      }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        atomicAdd(&s_red[2 * CC + (wn1 * 32) % CU + nj * 8 + 2 * t4 + e],
                  dbl[nj][e]);
  }
  __syncthreads();
  for (int c = tid; c < CC; c += NT) {
    atomicAdd(a.dinv + c, s_red[c]);
    atomicAdd(a.dshift + c, s_red[CC + c]);
  }
  for (int c = tid; c < CU; c += NT) atomicAdd(a.db + c, s_red[2 * CC + c]);
}

// Row 22: (s, q) (CU,) float32 sums of the rounded recompute u over every
// carry voxel and sub-position, into a.dinv and a.dshift. GEMM 1's layout
// and loads are row 23's.
template <int CC, int CU>
__global__ void __launch_bounds__(NT, 2)
upconv_stats_tc_kernel(const StatsBwdArgs a) {
  using C = SCfg<CC, CU>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_w = smem;                    // [CC/16][NCOL][32], swz
  unsigned char* s_x = s_w + C::WBYTES;         // 2 x [BM][XP] raw ring
  unsigned char* s_a = s_x + 2 * C::XBYTES;     // [BM][XP] prologued
  float* s_inv = reinterpret_cast<float*>(s_a + C::XBYTES);   // [CC]
  float* s_shift = s_inv + CC;
  float* s_bu = s_shift + CC;                   // [CU]
  float* s_red = s_bu + CU;                     // [2 CU]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int64_t ntiles = (a.total + BM - 1) / BM;

  for (int c = tid; c < CC; c += NT) {
    s_inv[c] = a.invc[c];
    s_shift[c] = a.shiftc[c];
  }
  for (int c = tid; c < CU; c += NT) {
    s_bu[c] = a.bu[c];
    s_red[c] = s_red[CU + c] = 0.0f;
  }
  for (int i = tid; i < CC / 16 * C::NCOL * 2; i += NT)
    cp_async16(smem_u32(s_w + swz(i >> 1, i & 1)),
               a.wp + (int64_t)(i >> 1) * 16 + (i & 1) * 8, true);
  auto load = [&](int64_t t, int slot) {
    unsigned char* dst = s_x + slot * C::XBYTES;
    for (int i = tid; i < BM * (CC / 8); i += NT) {
      const int r = i / (CC / 8);
      const int ch = i % (CC / 8);
      const int64_t v = t * BM + r;
      const bool ok = v < a.total;
      cp_async16(smem_u32(dst + r * C::XP + ch * 16),
                 ok ? a.x + v * CC + ch * 8 : a.x, ok);
    }
  };
  load(blockIdx.x, 0);
  cp_async_commit();

  const int wm1 = warp % 2, wn1 = warp / 2;
  const uint32_t a1_lane = smem_u32(s_a) + (wm1 * 32 + (lane & 15)) * C::XP
      + (lane >> 4) * 16;
  const uint32_t w1_lane = smem_u32(s_w)
      + swz((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  // This lane's sums of columns j * 128 + wn1 * 32 + nj * 8 + 2 t4 (+ 1).
  float sm[C::CHUNKS][4][2], sq[C::CHUNKS][4][2];
#pragma unroll
  for (int j = 0; j < C::CHUNKS; ++j)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
      sm[j][nj][0] = sm[j][nj][1] = sq[j][nj][0] = sq[j][nj][1] = 0.0f;

  int slot = 0;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, slot ^= 1) {
    cp_async_wait<0>();  // tile t (and the weight) has landed
    __syncthreads();     // for every thread; the other slot is free
    if (t + gridDim.x < ntiles) load(t + gridDim.x, slot ^ 1);
    cp_async_commit();
    const unsigned char* sx = s_x + slot * C::XBYTES;
    const int64_t v0 = t * BM;
    for (int i = tid; i < BM * (CC / 8); i += NT) {
      const int r = i / (CC / 8);
      const int ch = i % (CC / 8);
      uint4* d = reinterpret_cast<uint4*>(s_a + r * C::XP + ch * 16);
      *d = *reinterpret_cast<const uint4*>(sx + r * C::XP + ch * 16);
      prologue_half(d, s_inv + ch * 8, s_shift + ch * 8, a.act, true);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < C::CHUNKS; ++j) {
      const int col[2] = {j * 128 + wn1 * 32, j * 128 + wn1 * 32 + 16};
      float acc[2][4][4];
      vup_mma<2, 2>(a1_lane, C::XP, w1_lane, col, C::NCOL, CC / 16, acc);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int co = (col[0] + nj * 8 + 2 * t4) % CU;
        const float b0 = s_bu[co], b1 = s_bu[co + 1];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            if (v0 + wm1 * 32 + mi * 16 + g + 8 * hr >= a.total) continue;
            const float u0 = vup_round(acc[mi][nj][2 * hr], b0);
            const float u1 = vup_round(acc[mi][nj][2 * hr + 1], b1);
            sm[j][nj][0] += u0;
            sm[j][nj][1] += u1;
            sq[j][nj][0] = fmaf(u0, u0, sq[j][nj][0]);
            sq[j][nj][1] = fmaf(u1, u1, sq[j][nj][1]);
          }
      }
    }
  }
  // The lanes of one t4 hold the same columns.
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < C::CHUNKS; ++j)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sm[j][nj][e] += __shfl_xor_sync(0xffffffffu, sm[j][nj][e], off);
          sq[j][nj][e] += __shfl_xor_sync(0xffffffffu, sq[j][nj][e], off);
        }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < C::CHUNKS; ++j)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = (j * 128 + wn1 * 32 + nj * 8 + 2 * t4 + e) % CU;
          atomicAdd(&s_red[co], sm[j][nj][e]);
          atomicAdd(&s_red[CU + co], sq[j][nj][e]);
        }
  }
  __syncthreads();
  for (int c = tid; c < CU; c += NT) {
    atomicAdd(a.dinv + c, s_red[c]);
    atomicAdd(a.dshift + c, s_red[CU + c]);
  }
}

// Row 23's per-sample mode (see the top): row 23's kernel, tile by tile
// on the per-sample walk.
template <int CC, int CU>
__global__ void __launch_bounds__(NT, SCfg<CC, CU>::MIN_BLOCKS)
upconv_stats_bwd_ps_tc_kernel(const StatsPsArgs a) {
  using C = SCfg<CC, CU>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_w = smem;                    // [CC/16][NCOL][32], swz
  unsigned char* s_x = s_w + C::WBYTES;         // 2 x [BM][XP] raw ring
  unsigned char* s_a = s_x + 2 * C::XBYTES;     // [BM][XP] prologued
  unsigned char* s_e = s_a + C::XBYTES;         // [BM][EP] E
  float* s_inv = reinterpret_cast<float*>(s_e + C::EBYTES);  // [CC]
  float* s_shift = s_inv + CC;
  float* s_bu = s_shift + CC;                   // [CU]
  float* s_ds = s_bu + CU;                      // [CU]
  float* s_dq = s_ds + CU;
  float* s_db = s_dq + CU;                      // [CU] dbu
  float* s_slot = s_db + CU;                    // [4][2 CC] a warp row's

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const PsWalk walk(a);

  for (int c = tid; c < CU; c += NT) {
    s_bu[c] = a.bu[c];
    s_db[c] = 0.0f;
  }
  for (int i = tid; i < CC / 16 * C::NCOL * 2; i += NT)
    cp_async16(smem_u32(s_w + swz(i >> 1, i & 1)),
               a.wp + (int64_t)(i >> 1) * 16 + (i & 1) * 8, true);
  int64_t v0, vend, smp, grp;
  if (!walk.at(a, 0, v0, vend, smp, grp)) return;
  load_rows<CC>(a, s_x, C::XP, v0, vend);
  cp_async_commit();

  const int wm1 = warp % 2, wn1 = warp / 2;
  const int wm2 = warp % 4, wn2 = warp / 4;
  const uint32_t a1_lane = smem_u32(s_a) + (wm1 * 32 + (lane & 15)) * C::XP
      + (lane >> 4) * 16;
  const uint32_t w1_lane = smem_u32(s_w)
      + swz((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  const ChainLanes<CC, CU> lanes(s_e, s_w, s_a, warp, lane);

  float acc3[C::MI3][C::NJ3][4];
#pragma unroll
  for (int mt = 0; mt < C::MI3; ++mt)
#pragma unroll
    for (int nj = 0; nj < C::NJ3; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc3[mt][nj][e] = 0.0f;
  float si[C::NJ2][2], ss[C::NJ2][2], dbl[4][2];
#pragma unroll
  for (int nj = 0; nj < C::NJ2; ++nj)
    si[nj][0] = si[nj][1] = ss[nj][0] = ss[nj][1] = 0.0f;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) dbl[nj][0] = dbl[nj][1] = 0.0f;

  int slot = 0;
  int64_t staged = -1;   // the sample whose rows are staged
  for (int64_t j = 0;; ++j, slot ^= 1) {
    cp_async_wait<0>();  // tile j (and the weight) has landed
    __syncthreads();     // for every thread; the other slot is free
    int64_t nv0, nvend, nsmp, ngrp;
    if (walk.at(a, j + 1, nv0, nvend, nsmp, ngrp))
      load_rows<CC>(a, s_x + (slot ^ 1) * C::XBYTES, C::XP, nv0, nvend);
    cp_async_commit();
    const unsigned char* sx = s_x + slot * C::XBYTES;
    if (smp != staged) {   // the walk entered another sample: its rows
      for (int c = tid; c < CC; c += NT) {
        s_inv[c] = a.invc[smp * a.cc_ns + c];
        s_shift[c] = a.shiftc[smp * a.cc_ns + c];
      }
      for (int c = tid; c < CU; c += NT) {
        s_ds[c] = a.ds[smp * a.st_ns + c];
        s_dq[c] = a.dq[smp * a.st_ns + c];
      }
      __syncthreads();
      staged = smp;
    }
    const float* rinv = s_inv;
    const float* rshift = s_shift;
    const float* rds = s_ds;
    const float* rdq = s_dq;

    if (v0 < vend) {   // a tile past the sample's end (its last group) is
                       // empty: nothing to compute
      for (int i = tid; i < BM * (CC / 8); i += NT) {
        const int r = i / (CC / 8);
        const int ch = i % (CC / 8);
        uint4* d = reinterpret_cast<uint4*>(s_a + r * C::XP + ch * 16);
        *d = *reinterpret_cast<const uint4*>(sx + r * C::XP + ch * 16);
        prologue_half(d, rinv + ch * 8, rshift + ch * 8, a.act, v0 + r < vend);
      }
      __syncthreads();

#pragma unroll
      for (int jc = 0; jc < C::CHUNKS; ++jc) {
        const int col[2] = {jc * 128 + wn1 * 32, jc * 128 + wn1 * 32 + 16};
        float acc[2][4][4];
        vup_mma<2, 2>(a1_lane, C::XP, w1_lane, col, C::NCOL, CC / 16, acc);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int cl = col[0] + nj * 8 + 2 * t4;
          const int co = cl % CU;
          const float b0 = s_bu[co], b1 = s_bu[co + 1];
          const float ds0 = rds[co], ds1 = rds[co + 1];
          const float dq0 = rdq[co], dq1 = rdq[co + 1];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int r = wm1 * 32 + mi * 16 + g + 8 * hr;
              const bool ok = v0 + r < vend;
              const float e0 = dy_tot(0.0f, vup_round(acc[mi][nj][2 * hr], b0),
                                      ds0, dq0);
              const float e1 = dy_tot(
                  0.0f, vup_round(acc[mi][nj][2 * hr + 1], b1), ds1, dq1);
              if (ok) {
                dbl[nj][0] += e0;
                dbl[nj][1] += e1;
              }
              *reinterpret_cast<uint32_t*>(s_e + r * C::EP + cl * 2) =
                  ok ? pack_bf16x2(e0, e1) : 0u;
            }
        }
      }
      __syncthreads();
      {
        float acc[C::NJ2][4];
        chain_gemm2<CC, CU>(lanes, wn2, acc);
        chain_dcarry<CC>(acc, sx, rinv, rshift, a.act, wm2, wn2, lane,
                         [&](int r) -> int64_t {
                           return v0 + r < vend ? v0 + r : -1;
                         },
                         a.dx, si, ss);
      }
      chain_gemm3<CC, CU>(lanes, acc3);
    }
    if (j % PS_TILES == PS_TILES - 1) {
      // The group's dinvc and dshiftc: the lanes of one t4 hold the same
      // channels; each GEMM 2 warp row's into its slot (its two warps
      // hold the two halves of the channels); the slots in order into
      // the group's partial row.
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int nj = 0; nj < C::NJ2; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            si[nj][e] += __shfl_xor_sync(0xffffffffu, si[nj][e], off);
            ss[nj][e] += __shfl_xor_sync(0xffffffffu, ss[nj][e], off);
          }
      if (g == 0) {
#pragma unroll
        for (int nj = 0; nj < C::NJ2; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = wn2 * (CC / 2) + nj * 8 + 2 * t4 + e;
            s_slot[wm2 * 2 * CC + c] = si[nj][e];
            s_slot[wm2 * 2 * CC + CC + c] = ss[nj][e];
          }
      }
      __syncthreads();
      float* const row = a.part + grp * 2 * CC;   // (smp, grp % gps)
      for (int c = tid; c < 2 * CC; c += NT)
        row[c] = ((s_slot[c] + s_slot[2 * CC + c]) + s_slot[4 * CC + c])
            + s_slot[6 * CC + c];
#pragma unroll
      for (int nj = 0; nj < C::NJ2; ++nj)
        si[nj][0] = si[nj][1] = ss[nj][0] = ss[nj][1] = 0.0f;
    }
    if (!walk.at(a, j + 1, v0, vend, smp, grp)) break;
  }

  chain_dw_flush<CC, CU>(acc3, a.dw, warp, lane);
  // dbu: global, as the batch form's.
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dbl[nj][e] += __shfl_xor_sync(0xffffffffu, dbl[nj][e], off);
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        atomicAdd(&s_db[(wn1 * 32) % CU + nj * 8 + 2 * t4 + e], dbl[nj][e]);
  }
  __syncthreads();
  for (int c = tid; c < CU; c += NT) atomicAdd(a.db + c, s_db[c]);
}

// Row 22's per-sample mode (see the top): row 22's kernel on the
// per-sample walk, each group's sums into its partial row.
template <int CC, int CU>
__global__ void __launch_bounds__(NT, 2)
upconv_stats_ps_tc_kernel(const StatsPsArgs a) {
  using C = SCfg<CC, CU>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_w = smem;                    // [CC/16][NCOL][32], swz
  unsigned char* s_x = s_w + C::WBYTES;         // 2 x [BM][XP] raw ring
  unsigned char* s_a = s_x + 2 * C::XBYTES;     // [BM][XP] prologued
  float* s_inv = reinterpret_cast<float*>(s_a + C::XBYTES);  // [CC]
  float* s_shift = s_inv + CC;
  float* s_bu = s_shift + CC;                   // [CU]
  float* s_slot = s_bu + CU;                    // [8][2 CU] a warp's

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const PsWalk walk(a);

  for (int c = tid; c < CU; c += NT) s_bu[c] = a.bu[c];
  for (int i = tid; i < CC / 16 * C::NCOL * 2; i += NT)
    cp_async16(smem_u32(s_w + swz(i >> 1, i & 1)),
               a.wp + (int64_t)(i >> 1) * 16 + (i & 1) * 8, true);
  int64_t v0, vend, smp, grp;
  if (!walk.at(a, 0, v0, vend, smp, grp)) return;
  load_rows<CC>(a, s_x, C::XP, v0, vend);
  cp_async_commit();

  const int wm1 = warp % 2, wn1 = warp / 2;
  const uint32_t a1_lane = smem_u32(s_a) + (wm1 * 32 + (lane & 15)) * C::XP
      + (lane >> 4) * 16;
  const uint32_t w1_lane = smem_u32(s_w)
      + swz((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  float sm[C::CHUNKS][4][2], sq[C::CHUNKS][4][2];
#pragma unroll
  for (int jc = 0; jc < C::CHUNKS; ++jc)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
      sm[jc][nj][0] = sm[jc][nj][1] = sq[jc][nj][0] = sq[jc][nj][1] = 0.0f;

  int slot = 0;
  int64_t staged = -1;   // the sample whose rows are staged
  for (int64_t j = 0;; ++j, slot ^= 1) {
    cp_async_wait<0>();  // tile j (and the weight) has landed
    __syncthreads();     // for every thread; the other slot is free
    int64_t nv0, nvend, nsmp, ngrp;
    if (walk.at(a, j + 1, nv0, nvend, nsmp, ngrp))
      load_rows<CC>(a, s_x + (slot ^ 1) * C::XBYTES, C::XP, nv0, nvend);
    cp_async_commit();
    const unsigned char* sx = s_x + slot * C::XBYTES;
    if (smp != staged) {   // the walk entered another sample: its rows
      for (int c = tid; c < CC; c += NT) {
        s_inv[c] = a.invc[smp * a.cc_ns + c];
        s_shift[c] = a.shiftc[smp * a.cc_ns + c];
      }
      __syncthreads();
      staged = smp;
    }
    const float* rinv = s_inv;
    const float* rshift = s_shift;
    if (v0 < vend) {   // a tile past the sample's end (its last group) is
                       // empty: nothing to compute
      for (int i = tid; i < BM * (CC / 8); i += NT) {
        const int r = i / (CC / 8);
        const int ch = i % (CC / 8);
        uint4* d = reinterpret_cast<uint4*>(s_a + r * C::XP + ch * 16);
        *d = *reinterpret_cast<const uint4*>(sx + r * C::XP + ch * 16);
        prologue_half(d, rinv + ch * 8, rshift + ch * 8, a.act, true);
      }
      __syncthreads();
#pragma unroll
      for (int jc = 0; jc < C::CHUNKS; ++jc) {
        const int col[2] = {jc * 128 + wn1 * 32, jc * 128 + wn1 * 32 + 16};
        float acc[2][4][4];
        vup_mma<2, 2>(a1_lane, C::XP, w1_lane, col, C::NCOL, CC / 16, acc);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int co = (col[0] + nj * 8 + 2 * t4) % CU;
          const float b0 = s_bu[co], b1 = s_bu[co + 1];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              if (v0 + wm1 * 32 + mi * 16 + g + 8 * hr >= vend) continue;
              const float u0 = vup_round(acc[mi][nj][2 * hr], b0);
              const float u1 = vup_round(acc[mi][nj][2 * hr + 1], b1);
              sm[jc][nj][0] += u0;
              sm[jc][nj][1] += u1;
              sq[jc][nj][0] = fmaf(u0, u0, sq[jc][nj][0]);
              sq[jc][nj][1] = fmaf(u1, u1, sq[jc][nj][1]);
            }
        }
      }
    }
    if (j % PS_TILES == PS_TILES - 1) {
      // The group's sums: over the lanes of one t4; a warp's (its chunks
      // in order: at C_u 64 both hold the same channels) into its slot;
      // the slots in order into the group's partial row (a warp covers
      // 32 channels: at C_u 64 the warps of wn1 % 2 == c / 32 cover c).
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int jc = 0; jc < C::CHUNKS; ++jc)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              sm[jc][nj][e] += __shfl_xor_sync(0xffffffffu, sm[jc][nj][e],
                                               off);
              sq[jc][nj][e] += __shfl_xor_sync(0xffffffffu, sq[jc][nj][e],
                                               off);
            }
      if (g == 0) {
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float vs = 0.0f, vq = 0.0f;
#pragma unroll
            for (int jc = 0; jc < C::CHUNKS; ++jc) {
              vs += sm[jc][nj][e];
              vq += sq[jc][nj][e];
            }
            const int co = (wn1 * 32 + nj * 8 + 2 * t4 + e) % CU;
            s_slot[warp * 2 * CU + co] = vs;
            s_slot[warp * 2 * CU + CU + co] = vq;
          }
      }
      __syncthreads();
      float* const row = a.part + grp * 2 * CU;   // (smp, grp % gps)
      for (int c = tid; c < 2 * CU; c += NT) {
        const int co = c % CU;
        float v = 0.0f;
        for (int w = 0; w < NT / 32; ++w)
          if (CU == 32 || (w / 2) % 2 == co / 32) v += s_slot[w * 2 * CU + c];
        row[c] = v;
      }
#pragma unroll
      for (int jc = 0; jc < C::CHUNKS; ++jc)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          sm[jc][nj][0] = sm[jc][nj][1] = sq[jc][nj][0] = sq[jc][nj][1] =
              0.0f;
    }
    if (!walk.at(a, j + 1, v0, vend, smp, grp)) break;
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

// One wave of blocks of ``kern`` at its occupancy, at most one a tile.
cudaError_t launch_wave(void (*kern)(StatsBwdArgs), int smem,
                        const StatsBwdArgs& a, cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                     smem);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t ntiles = (a.total + BM - 1) / BM;
  int64_t blocks = (int64_t)per_sm * sm_count();
  if (blocks > ntiles) blocks = ntiles;
  if (blocks < 1) return cudaSuccess;   // no voxels
  kern<<<(unsigned)blocks, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// One wave of blocks of a per-sample kernel at its occupancy, at most
// one a group.
cudaError_t launch_wave_ps(void (*kern)(StatsPsArgs), int smem,
                           const StatsPsArgs& a, cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                     smem);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t groups = (int64_t)a.n * e3_ps_groups(a.spv);
  int64_t blocks = (int64_t)per_sm * sm_count();
  if (blocks > groups) blocks = groups;
  if (blocks < 1) return cudaSuccess;   // no voxels
  kern<<<(unsigned)blocks, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// Row 23 (stats = false) or row 22 (stats = true).
template <int CC, int CU>
cudaError_t launch(const StatsBwdArgs& a, bool stats, cudaStream_t stream) {
  using C = SCfg<CC, CU>;
  return stats ? launch_wave(upconv_stats_tc_kernel<CC, CU>, C::STATS_SMEM,
                             a, stream)
               : launch_wave(upconv_stats_bwd_tc_kernel<CC, CU>, C::SMEM, a,
                             stream);
}

// The per-sample kernels of rows 23 and 22.
template <int CC, int CU>
cudaError_t launch(const StatsPsArgs& a, bool stats, cudaStream_t stream) {
  using C = SCfg<CC, CU>;
  return stats ? launch_wave_ps(upconv_stats_ps_tc_kernel<CC, CU>,
                                C::PS_STATS_SMEM, a, stream)
               : launch_wave_ps(upconv_stats_bwd_ps_tc_kernel<CC, CU>,
                                C::PS_SMEM, a, stream);
}

template <int CC, typename Args>
cudaError_t launch_cu(const Args& a, int cu, bool stats, cudaStream_t st) {
  if (cu == 32) return launch<CC, 32>(a, stats, st);
  if (cu == 64) return launch<CC, 64>(a, stats, st);
  return cudaErrorInvalidValue;
}

template <typename Args>
int launch_cc(const Args& a, int cc, int cu, bool stats, cudaStream_t st) {
  cudaError_t rc;
  switch (cc) {
    case 32: rc = launch_cu<32>(a, cu, stats, st); break;
    case 64: rc = launch_cu<64>(a, cu, stats, st); break;
    case 96: rc = launch_cu<96>(a, cu, stats, st); break;
    case 128: rc = launch_cu<128>(a, cu, stats, st); break;
    default: rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}

// The per-sample kernels' arguments from the batch ones.
StatsPsArgs ps_args(const StatsBwdArgs& a, int cc_ns, int st_ns, int n,
                    int d, int h, int wd, float* ws) {
  StatsPsArgs p;
  static_cast<StatsBwdArgs&>(p) = a;
  p.cc_ns = cc_ns;
  p.st_ns = st_ns;
  p.spv = (int64_t)d * h * wd;
  p.n = n;
  p.part = ws;
  return p;
}

}  // namespace

// The per-sample mode's partial rows a sample of rows 22 and 23
// (ps_reduce.cuh): its groups of PS_TILES tiles of BM carry voxels.
extern "C" int64_t e3_upconv_stats_tc_ps_parts(int d, int h, int wd) {
  return e3_ps_groups((int64_t)d * h * wd);
}

// Row 23, bf16 body: from the statistics cotangents ds, dq (cu,) into
// dcarry (the carry's shape, bf16), dinvc, dshiftc (cc,), dwu (2, 2, cc,
// cu) and dbu (cu,), float32 and zeroed by the caller. ``wp`` is K3's
// packed (cc / 16, 4 cu, 16) bf16 weight; invc, shiftc, bu, ds and dq
// are (cc,) and (cu,) float32 vectors (none null). (n, d, h, wd) are the
// carry's dims. Needs cc in {32, 64, 96, 128} and cu in {32, 64}. The
// per-sample mode (a workspace ``ws`` given: ps_workspace_floats of n
// samples, e3_upconv_stats_tc_ps_parts rows of 2 cc): invc, shiftc (n,
// cc) and ds, dq (n, cu) rows at the strides ``cc_ns`` = cc and ``st_ns``
// = cu; dinvc and dshiftc per sample as (n, 2, cc) in ``dinvc``
// (``dshiftc`` unused, neither zeroed); dwu and dbu global.
extern "C" int e3_upconv_stats_bwd_tc(const void* carry, const float* invc,
                                      const float* shiftc, int cc_ns,
                                      const void* wp, const float* bu,
                                      const float* ds, const float* dq,
                                      int st_ns, void* dcarry, float* dinvc,
                                      float* dshiftc, float* ws, float* dwu,
                                      float* dbu, int n, int d, int h,
                                      int wd, int cc, int cu, int actc,
                                      void* stream) {
  if (ws != nullptr && (cc_ns != cc || st_ns != cu || n > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  StatsBwdArgs a = {};
  a.x = static_cast<const __nv_bfloat16*>(carry);
  a.invc = invc;
  a.shiftc = shiftc;
  a.wp = static_cast<const __nv_bfloat16*>(wp);
  a.bu = bu;
  a.ds = ds;
  a.dq = dq;
  a.dx = static_cast<__nv_bfloat16*>(dcarry);
  a.dinv = dinvc;
  a.dshift = dshiftc;
  a.dw = dwu;
  a.db = dbu;
  a.total = (int64_t)n * d * h * wd;
  a.act = actc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ws == nullptr) return launch_cc(a, cc, cu, false, st);
  const int rc = launch_cc(ps_args(a, cc_ns, st_ns, n, d, h, wd, ws), cc,
                           cu, false, st);
  if (rc != 0) return rc;
  return static_cast<int>(ps_reduce(ws, n, e3_upconv_stats_tc_ps_parts(d, h,
                                                                        wd),
                                    2 * cc, dinvc, st));
}

// Row 22, bf16 body: s and q (cu,) float32, zeroed by the caller, += the
// sums of the rounded upconv output and of its squares. Arguments as
// e3_upconv_stats_bwd_tc's; same template cases. The per-sample mode (a
// workspace ``ws``: ps_workspace_floats of n samples,
// e3_upconv_stats_tc_ps_parts rows of 2 cu): invc, shiftc (n, cc) rows
// at ``cc_ns`` = cc, the sums per sample as (n, 2, cu) in ``s`` (``q``
// unused, nothing zeroed).
extern "C" int e3_upconv_stats_tc(const void* carry, const float* invc,
                                  const float* shiftc, int cc_ns,
                                  const void* wp, const float* bu, float* s,
                                  float* q, float* ws, int n, int d, int h,
                                  int wd, int cc, int cu, int actc,
                                  void* stream) {
  if (ws != nullptr && (cc_ns != cc || n > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  StatsBwdArgs a = {};
  a.x = static_cast<const __nv_bfloat16*>(carry);
  a.invc = invc;
  a.shiftc = shiftc;
  a.wp = static_cast<const __nv_bfloat16*>(wp);
  a.bu = bu;
  a.dinv = s;     // row 22's sums take row 23's prologue-gradient slots
  a.dshift = q;
  a.total = (int64_t)n * d * h * wd;
  a.act = actc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ws == nullptr) return launch_cc(a, cc, cu, true, st);
  const int rc = launch_cc(ps_args(a, cc_ns, 0, n, d, h, wd, ws), cc, cu,
                           true, st);
  if (rc != 0) return rc;
  return static_cast<int>(ps_reduce(ws, n, e3_upconv_stats_tc_ps_parts(d, h,
                                                                        wd),
                                    2 * cu, s, st));
}
