// Row 23, upconv_stats_bwd, bfloat16 body: the backward of the vup
// path's statistics pass (row 22) as ONE kernel on the tensor cores. Row
// 22 sums the (1, 2, 2) upconv u of the carry into u's batch statistics
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
// {32, 64} (vup.vup_bwd_body names the CUDA-core path for others).
//
// mma.sync rather than wgmma and TMA, as in the other tensor-core
// bodies (upconv_tc.cu, wgrad_tc.cu, upconv_bwd_tc.cu): the
// bytes, not the tensor-core rate, set the bound; the three GEMMs are
// 64 rows deep and chained through shared memory in one block, and
// mma.sync's fragments let the epilogues work on registers whose layout
// this file controls.
#include "tc.cuh"
#include "upconv_vup.cuh"

namespace {

using namespace e3;

constexpr int BM = 64;    // carry voxels a tile
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

template <int CC, int CU>
struct SCfg {
  static constexpr int NCOL = 4 * CU;            // (sub, co) columns
  static constexpr int XP = CC * 2 + 16;         // carry / a row pitch
  static constexpr int EP = NCOL * 2 + 16;       // E row pitch
  static constexpr int WBYTES = CC * NCOL * 2;
  static constexpr int XBYTES = BM * XP;
  static constexpr int EBYTES = BM * EP;
  static constexpr int VECS = 4 * CC + 4 * CU;   // floats
  static constexpr int SMEM = WBYTES + 3 * XBYTES + EBYTES + VECS * 4;
  static constexpr int CHUNKS = NCOL / 128;      // GEMM 1 column chunks
  static constexpr int NJ2 = CC / 16;            // GEMM 2 n8 tiles a warp
  static constexpr int MI3 = CC / 32;            // GEMM 3 m16 tiles a warp
  static constexpr int NJ3 = CU / 8;             // GEMM 3 n8 tiles a warp
  // Two blocks an SM where the GEMM 3 sums (CC * CU / 64 a lane) leave
  // room for them.
  static constexpr int MIN_BLOCKS = CC * CU <= 2048 ? 2 : 1;
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
  // chunk); GEMM 2: 4 (16 rows) x 2 (CC / 2 channels); GEMM 3: 2 (CC / 2
  // channels) x 4 (one sub-position's CU columns).
  const int wm1 = warp % 2, wn1 = warp / 2;
  const int wm2 = warp % 4, wn2 = warp / 4;
  const int wm3 = warp / 4, sub3 = warp % 4;
  const uint32_t a1_lane = smem_u32(s_a) + (wm1 * 32 + (lane & 15)) * C::XP
      + (lane >> 4) * 16;
  const uint32_t w1_lane = smem_u32(s_w)
      + swz((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  const uint32_t e2_lane = smem_u32(s_e) + (wm2 * 16 + (lane & 15)) * C::EP
      + (lane >> 4) * 16;
  const uint32_t w2_lane = smem_u32(s_w)
      + swz((lane & 7) + 8 * ((lane >> 3) & 1), lane >> 4);
  const uint32_t a3_lane = smem_u32(s_a)
      + ((lane & 7) + 8 * (lane >> 4)) * C::XP + wm3 * CC
      + ((lane >> 3) & 1) * 16;
  const uint32_t e3_lane = smem_u32(s_e)
      + ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::EP + sub3 * CU * 2
      + (lane >> 4) * 16;

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
#pragma unroll
      for (int nj = 0; nj < C::NJ2; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nj][e] = 0.0f;
#pragma unroll 4
      for (int ks = 0; ks < C::NCOL / 16; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(e2_lane + ks * 32, af);
#pragma unroll
        for (int p = 0; p < C::NJ2 / 2; ++p) {
          uint32_t q[4];
          const int kc = wn2 * (CC / 32) + p;   // 16-channel group
          ldmatrix_x4_trans(w2_lane + (kc * C::NCOL + ks * 16) * 32, q);
          mma_bf16_16816(acc[2 * p], af, q[0], q[1]);
          mma_bf16_16816(acc[2 * p + 1], af, q[2], q[3]);
        }
      }
      // Lane (g, t4): voxels g and g + 8 of the warp's 16, channels
      // 2 t4 and 2 t4 + 1 of each n8 tile.
#pragma unroll
      for (int nj = 0; nj < C::NJ2; ++nj) {
        const int c = wn2 * (CC / 2) + nj * 8 + 2 * t4;
        const float i0 = s_inv[c], i1 = s_inv[c + 1];
        const float h0 = s_shift[c], h1 = s_shift[c + 1];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = wm2 * 16 + g + 8 * hr;
          const int64_t v = v0 + r;
          if (v >= a.total) continue;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sx + r * C::XP
                                                       + c * 2));
          const float gm0 = acc[nj][2 * hr]
              * act_grad(pre_act(xv.x, i0, h0), a.act);
          const float gm1 = acc[nj][2 * hr + 1]
              * act_grad(pre_act(xv.y, i1, h1), a.act);
          si[nj][0] += gm0 * xv.x;
          si[nj][1] += gm1 * xv.y;
          ss[nj][0] += gm0;
          ss[nj][1] += gm1;
          *reinterpret_cast<__nv_bfloat162*>(a.dx + v * CC + c) =
              __floats2bfloat162_rn(gm0 * i0, gm1 * i1);
        }
      }
    }

    // GEMM 3, the wgrad, dWu[sub3] += a^T E[sub3].
#pragma unroll
    for (int ks = 0; ks < BM / 16; ++ks) {
      uint32_t af[C::MI3][4];
#pragma unroll
      for (int mt = 0; mt < C::MI3; ++mt)
        ldmatrix_x4_trans(a3_lane + ks * 16 * C::XP + mt * 32, af[mt]);
#pragma unroll
      for (int p = 0; p < C::NJ3 / 2; ++p) {
        uint32_t q[4];
        ldmatrix_x4_trans(e3_lane + ks * 16 * C::EP + p * 32, q);
#pragma unroll
        for (int mt = 0; mt < C::MI3; ++mt) {
          mma_bf16_16816(acc3[mt][2 * p], af[mt], q[0], q[1]);
          mma_bf16_16816(acc3[mt][2 * p + 1], af[mt], q[2], q[3]);
        }
      }
    }
  }

  // dWu: lane (g, t4) holds input channels g and g + 8 of each m16 tile,
  // output channels 2 t4 and 2 t4 + 1 of each n8 tile.
#pragma unroll
  for (int mt = 0; mt < C::MI3; ++mt)
#pragma unroll
    for (int nj = 0; nj < C::NJ3; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = wm3 * (CC / 2) + mt * 16 + g + 8 * (e >> 1);
        const int co = nj * 8 + 2 * t4 + (e & 1);
        atomicAdd(a.dw + ((int64_t)sub3 * CC + ci) * CU + co, acc3[mt][nj][e]);
      }
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

// One wave of blocks at the kernel's occupancy, at most one a tile.
template <int CC, int CU>
cudaError_t launch(const StatsBwdArgs& a, cudaStream_t stream) {
  constexpr int smem = SCfg<CC, CU>::SMEM;
  auto kern = upconv_stats_bwd_tc_kernel<CC, CU>;
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

template <int CC>
cudaError_t launch_cu(const StatsBwdArgs& a, int cu, cudaStream_t st) {
  if (cu == 32) return launch<CC, 32>(a, st);
  if (cu == 64) return launch<CC, 64>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Row 23, bf16 body: from the statistics cotangents ds, dq (cu,) into
// dcarry (the carry's shape, bf16), dinvc, dshiftc (cc,), dwu (2, 2, cc,
// cu) and dbu (cu,), float32 and zeroed by the caller. ``wp`` is K3's
// packed (cc / 16, 4 cu, 16) bf16 weight; invc, shiftc, bu, ds and dq
// are (cc,) and (cu,) float32 vectors (none null). (n, d, h, wd) are the
// carry's dims. Needs cc in {32, 64, 96, 128} and cu in {32, 64}.
extern "C" int e3_upconv_stats_bwd_tc(const void* carry, const float* invc,
                                      const float* shiftc, const void* wp,
                                      const float* bu, const float* ds,
                                      const float* dq, void* dcarry,
                                      float* dinvc, float* dshiftc,
                                      float* dwu, float* dbu, int n, int d,
                                      int h, int wd, int cc, int cu,
                                      int actc, void* stream) {
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
  cudaError_t rc;
  switch (cc) {
    case 32: rc = launch_cu<32>(a, cu, st); break;
    case 64: rc = launch_cu<64>(a, cu, st); break;
    case 96: rc = launch_cu<96>(a, cu, st); break;
    case 128: rc = launch_cu<128>(a, cu, st); break;
    default: rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}
