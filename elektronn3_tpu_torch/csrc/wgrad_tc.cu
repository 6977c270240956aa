// K5 conv_bnact_wgrad, bfloat16 body: the weight gradient of K1's
// (kd, 3, 3) 'same' conv over one or two NDHWC inputs,
//     dW[dz, ky, kx, ci, co] = sum over voxels pos of
//                              a[pos + (dz, ky, kx) - centre, ci]
//                              * dy_tot[pos, co],
// and db[co] = sum of the float32 dy_tot, as a split-K implicit GEMM on
// the tensor cores. The function, its rounding points and its plain
// version are those of conv_bnact_bwd.cu (which keeps the CUDA-core body
// for float32, for the network input's C_in of 1 or 3 and for the vup
// merge conv): a is the RECOMPUTED prologued input rounded to bf16 (0
// at the halo, after the prologue), dy_tot = dy + ds + 2 y dq is formed
// in float32, summed into db before it is rounded to bf16, and the
// products are summed in float32. It runs whenever every input's channel
// count is a multiple of 16 (the wrapper's wgrad_body).
//
// Replaces, for bf16, the wgrad halves of these TPU kernels of the JAX
// package (the list of conv_bnact_bwd.cu):
//   ops/flat_fused.py::_conv_bnact_bwd   (_fused_conv_bwd_kernel)
//   ops/flat_fused64.py::_conv64_bwd     (_conv64_bwd_kernel)
//   ops/flat_conv.py::_wgrad             (flat_conv3's dW, row 27: the
//                                        identity prologue skips the pass)
// (_conv1_bwd, the network input, keeps the CUDA-core body.)
//
// What bounds it on the card: at kd = 3 and C >= 64 arithmetic (the
// same FLOPs as K1's forward, 1 to 2 KFLOP per byte it must move); at
// kd = 1 and C = 32 the bytes of x, dy and y. The design:
//   - a block owns one depth tap dz, one slice of CS = 32 input channels
//     (16 where an input's channel count leaves a half slice) and
//     COB = 64 output channels (32 when C_out is not a multiple of 64),
//     and walks a strided share of the TH x TW = 8 x 16 voxel tiles of
//     the (n, depth) planes that tap reaches (tiles of planes where the
//     tap reads the zero padding are not walked);
//   - a tile's K is its 128 voxels, one k16 step a row of TW = 16;
//   - a 2-stage cp.async ring stages the next tile while this one
//     computes: the raw halo slab ((TH + 2) x (TW + 2) voxels x the
//     slice's channels, zero-filled outside the volume; one pass then
//     applies the prologue in place, rounds and writes 0 at the halo)
//     and the dy (and y) tile, from which one pass forms dy_tot, sums db
//     (the centre-dz blocks of the first slice only) and rounds; where
//     the blocks would read dy and y more than twice (slices x kd > 2),
//     a pre-pass (launch_dytot, upconv_bwd_tc.cu) forms the rounded
//     dy_tot and db once instead, and the blocks stage it alone;
//   - 6 warps, one per (ky, m16 tile of the slice); each keeps the three
//     kx taps x COB output channels in registers (96 a lane at
//     COB = 64). Per k16 step it loads the dy_tot fragments (B) once for
//     the three taps and one slab fragment (A) per tap; both operands
//     are voxel-major, so both come through ldmatrix .trans. The slab's
//     80-byte voxel pitch and the dy tile's 144- (80-) byte pitch are
//     odd multiples of 16 bytes, so the 8 rows of a phase are
//     conflict-free and a tap is a constant offset of every row address;
//   - at the end one float32 atomic per weight and block (the order of
//     the blocks' sums, hence the last bits, changes from run to run, as
//     in the CUDA-core body).
// Reads: x once per (output-channel block, dz), times the halo's
// 180 / 128; dy and y once per (input-channel slice, dz). At the
// 32 -> 32 kd = 1 conv that is each once; at the 64 + 64 -> 64 kd = 3
// merge the blocks read dy_tot 12 times (after the pre-pass's one read
// of dy and y), but the blocks that share a tile (consecutive block
// indices: the slice, output block and dz vary fastest) run side by
// side, so L2 serves most of the repeats.
//
// mma.sync rather than wgmma, as in conv_tc.cu: a tap's A operand is a
// shifted window of the staged slab that ldmatrix reads row by row at
// any offset; wgmma's shared-memory descriptors would need a re-staged
// copy per tap. That is left for a later step.
#include "tc.cuh"

namespace {

using namespace e3;

constexpr int TH = 8;                  // tile rows
constexpr int TW = 16;                 // tile columns: one k16 step
constexpr int SW = TW + 2;             // slab width
constexpr int NSLAB = (TH + 2) * SW;   // slab voxels
constexpr int CS = 32;                 // input channels of a slice
constexpr int SPITCH = CS * 2 + 16;    // slab voxel pitch, bytes
constexpr int NT = 192;                // 6 warps: (ky, m16 tile)
constexpr int SLAB = NSLAB * SPITCH;   // slab bytes of a stage

template <int COB>
struct WCfg {
  static constexpr int NJ = COB / 8;             // n8 tiles
  static constexpr int DPITCH = COB * 2 + 16;    // dy tile voxel pitch
  static constexpr int DYB = TH * TW * DPITCH;   // dy tile bytes
};

struct WgTcArgs {
  const __nv_bfloat16* x[2];
  const float* inv;          // (c0 + c1,) prologue, or null (identity)
  const float* shift;
  int cin[2];
  int groups0;               // slices of input 0
  const __nv_bfloat16* dy;   // (n, d, h, w, cout)
  const __nv_bfloat16* y;    // the forward output (read with ds)
  const float* ds;           // (cout,) statistics cotangents, or null
  const float* dq;
  float* dw;                 // (kd, 3, 3, c0 + c1, cout), zeroed
  float* db;                 // (cout,), zeroed; null: the pre-pass sums
  int n, d, h, wd, cout, kd, act;
  int combos;                // slices x output blocks x kd
  int splits;                // blocks per combo
};

// Bytes of a ring slot: the slab, the dy tile and, with a statistics
// cotangent, the y tile.
template <int COB, bool DYT>
struct Stage {
  static constexpr int BYTES = SLAB + (DYT ? 2 : 1) * WCfg<COB>::DYB;
};

template <int COB, bool DYT>
size_t wgrad_tc_smem() {
  return (size_t)2 * Stage<COB, DYT>::BYTES + (size_t)2 * CS * 4
      + (size_t)3 * COB * 4;
}

// A tile's place: its first row and column, the plane of its dy tile
// and that of its slab (dz planes away).
struct Tile {
  int h0, w0;
  int64_t oplane, iplane;
};

__device__ __forceinline__ Tile tile_at(const WgTcArgs& a, int64_t t,
                                        int dzp) {
  const int tiles_w = (a.wd + TW - 1) / TW;
  const int tiles_h = (a.h + TH - 1) / TH;
  const int nvd = a.d - abs(dzp);
  Tile tl;
  tl.w0 = (int)(t % tiles_w) * TW;
  t /= tiles_w;
  tl.h0 = (int)(t % tiles_h) * TH;
  t /= tiles_h;
  const int dd = (int)(t % nvd) + max(0, -dzp);
  tl.oplane = (t / nvd) * a.d + dd;
  tl.iplane = tl.oplane + dzp;
  return tl;
}

template <int COB, bool PRO, bool DYT>
__global__ void __launch_bounds__(NT, 2)
wgrad_tc_kernel(const WgTcArgs a) {
  using C = WCfg<COB>;
  constexpr int STAGE = Stage<COB, DYT>::BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_inv = reinterpret_cast<float*>(smem + 2 * STAGE);   // [CS]
  float* s_shift = s_inv + CS;
  float* s_ds = s_shift + CS;                                  // [COB]
  float* s_dq = s_ds + COB;
  float* s_db = s_dq + COB;

  const int tid = threadIdx.x;
  const int ncob = a.cout / COB;
  const int combo = (int)(blockIdx.x % a.combos);
  const int split = (int)(blockIdx.x / a.combos);
  const int dzi = combo % a.kd;
  const int cobi = (combo / a.kd) % ncob;
  const int slice = combo / (a.kd * ncob);
  const int i = slice >= a.groups0;
  const int cb = (slice - (i ? a.groups0 : 0)) * CS;
  const int ci = a.cin[i];
  const int cw = min(CS, ci - cb);          // 16 or 32
  const int coff = i ? a.cin[0] : 0;
  const int ct = a.cin[0] + a.cin[1];
  const int co0 = cobi * COB;
  const int dzp = dzi - a.kd / 2;
  const bool do_db = slice == 0 && dzp == 0 && a.db != nullptr;
  const int64_t ntiles = (int64_t)a.n * (a.d - abs(dzp))
      * ((a.h + TH - 1) / TH) * ((a.wd + TW - 1) / TW);
  if (split >= ntiles) return;
  const __nv_bfloat16* xp = a.x[i];

  if (PRO)
    for (int c = tid; c < cw; c += NT) {
      s_inv[c] = a.inv[coff + cb + c];
      s_shift[c] = a.shift[coff + cb + c];
    }
  if (DYT)
    for (int c = tid; c < COB; c += NT) {
      s_ds[c] = a.ds[co0 + c];
      s_dq[c] = a.dq[co0 + c];
    }
  for (int c = tid; c < COB; c += NT) s_db[c] = 0.0f;

  // Stage tile t into ring slot ``slot``.
  auto load = [&](int64_t t, int slot) {
    const Tile tl = tile_at(a, t, dzp);
    unsigned char* sx = smem + slot * STAGE;
    for (int p = tid; p < NSLAB * 4; p += NT) {
      const int ch = p & 3;
      if (ch * 8 >= cw) continue;
      const int vox = p >> 2;
      const int gh = tl.h0 + vox / SW - 1;
      const int gw = tl.w0 + vox % SW - 1;
      const bool ok = gh >= 0 && gh < a.h && gw >= 0 && gw < a.wd;
      cp_async16(smem_u32(sx + vox * SPITCH + ch * 16),
                 ok ? xp + ((tl.iplane * a.h + gh) * a.wd + gw) * ci + cb
                          + ch * 8
                    : xp,
                 ok);
    }
    unsigned char* sg = sx + SLAB;
    for (int p = tid; p < TH * TW * C::NJ; p += NT) {
      const int ch = p % C::NJ;
      const int vox = p / C::NJ;
      const int gh = tl.h0 + vox / TW;
      const int gw = tl.w0 + vox % TW;
      const bool ok = gh < a.h && gw < a.wd;
      const int64_t off = ok
          ? ((tl.oplane * a.h + gh) * a.wd + gw) * a.cout + co0 + ch * 8
          : 0;
      cp_async16(smem_u32(sg + vox * C::DPITCH + ch * 16), a.dy + off, ok);
      if (DYT)
        cp_async16(smem_u32(sg + C::DYB + vox * C::DPITCH + ch * 16),
                   a.y + off, ok);
    }
  };

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ky = warp % 3;
  const int mt = warp / 3;
  const bool mact = mt * 16 < cw;
  // Each lane's ldmatrix row: of the slab at tap (ky, 0) and output row
  // 0 (A: voxels 0-7 / 8-15 of the row, channel halves), and of the dy
  // tile at row 0 (B: voxels 0-7 / 8-15, n8 tiles 2p and 2p + 1).
  const uint32_t a_lane = ((lane & 7) + 8 * (lane >> 4) + ky * SW) * SPITCH
      + mt * 32 + ((lane >> 3) & 1) * 16;
  const uint32_t b_lane = ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::DPITCH
      + (lane >> 4) * 16;

  float acc[3][C::NJ][4];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int nj = 0; nj < C::NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[kx][nj][e] = 0.0f;
  float dbl[8];  // db partials of this thread's 8 channels
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
    unsigned char* sg = sx + SLAB;
    if (PRO || DYT || do_db) {
      const Tile tl = tile_at(a, t, dzp);
      if (PRO)
        for (int p = tid; p < NSLAB * 4; p += NT) {
          const int ch = p & 3;
          if (ch * 8 >= cw) continue;
          const int vox = p >> 2;
          const int gh = tl.h0 + vox / SW - 1;
          const int gw = tl.w0 + vox % SW - 1;
          prologue_half(reinterpret_cast<uint4*>(sx + vox * SPITCH
                                                 + ch * 16),
                        s_inv + ch * 8, s_shift + ch * 8, a.act,
                        gh >= 0 && gh < a.h && gw >= 0 && gw < a.wd);
        }
      if (DYT || do_db)
        for (int p = tid; p < TH * TW * C::NJ; p += NT) {
          const int ch = p % C::NJ;   // the same for every p of a thread
          const int vox = p / C::NJ;
          const bool ok = tl.h0 + vox / TW < a.h && tl.w0 + vox % TW < a.wd;
          uint4* gp = reinterpret_cast<uint4*>(sg + vox * C::DPITCH
                                               + ch * 16);
          const uint4* yp = DYT ? reinterpret_cast<const uint4*>(
              sg + C::DYB + vox * C::DPITCH + ch * 16) : nullptr;
          if (do_db)
            dytot_half(gp, yp, s_ds + ch * 8, s_dq + ch * 8, ok, dbl);
          else
            dytot_half(gp, yp, s_ds + ch * 8, s_dq + ch * 8, ok, nullptr);
        }
      __syncthreads();
    }
    if (mact) {
      const uint32_t ua = smem_u32(sx) + a_lane;
      const uint32_t ub = smem_u32(sg) + b_lane;
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        uint32_t bf[C::NJ][2];
#pragma unroll
        for (int p = 0; p < C::NJ / 2; ++p) {
          uint32_t q[4];
          ldmatrix_x4_trans(ub + r * TW * C::DPITCH + p * 32, q);
          bf[2 * p][0] = q[0];
          bf[2 * p][1] = q[1];
          bf[2 * p + 1][0] = q[2];
          bf[2 * p + 1][1] = q[3];
        }
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          uint32_t af[4];
          ldmatrix_x4_trans(ua + (r * SW + kx) * SPITCH, af);
#pragma unroll
          for (int nj = 0; nj < C::NJ; ++nj)
            mma_bf16_16816(acc[kx][nj], af, bf[nj][0], bf[nj][1]);
        }
      }
    }
  }

  // dW: lane (g, t4) holds input channels g and g + 8 of the warp's m16
  // tile, output channels 2 t4 and 2 t4 + 1 of each n8 tile.
  if (mact) {
    const int g = lane / 4;
    const int t4 = lane % 4;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int nj = 0; nj < C::NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = coff + cb + mt * 16 + g + 8 * (e >> 1);
          const int co = co0 + nj * 8 + 2 * t4 + (e & 1);
          atomicAdd(a.dw + ((int64_t)(dzi * 9 + ky * 3 + kx) * ct + c)
                               * a.cout + co,
                    acc[kx][nj][e]);
        }
  }
  if (do_db) {
    __syncthreads();  // s_db's initialization is visible
    const int ch = tid % C::NJ;
#pragma unroll
    for (int j = 0; j < 8; ++j) atomicAdd(&s_db[ch * 8 + j], dbl[j]);
    __syncthreads();
    for (int c = tid; c < COB; c += NT) atomicAdd(a.db + co0 + c, s_db[c]);
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

// One wave of blocks: as many splits of every combo as fill the SMs at
// the kernel's occupancy, at most one a tile.
template <int COB, bool PRO, bool DYT>
cudaError_t launch(WgTcArgs a, cudaStream_t stream) {
  const size_t smem = wgrad_tc_smem<COB, DYT>();
  auto kern = wgrad_tc_kernel<COB, PRO, DYT>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                     smem);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t ntiles = (int64_t)a.n * a.d * ((a.h + TH - 1) / TH)
      * ((a.wd + TW - 1) / TW);
  int64_t splits = (int64_t)per_sm * sm_count() / a.combos;
  if (splits > ntiles) splits = ntiles;
  if (splits < 1) splits = 1;
  a.splits = (int)splits;
  const int64_t blocks = splits * a.combos;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int COB>
cudaError_t launch_cob(const WgTcArgs& a, cudaStream_t st) {
  if (a.inv != nullptr)
    return a.ds != nullptr ? launch<COB, true, true>(a, st)
                           : launch<COB, true, false>(a, st);
  return a.ds != nullptr ? launch<COB, false, true>(a, st)
                         : launch<COB, false, false>(a, st);
}

}  // namespace

// K5, bf16 body: dW (kd, 3, 3, c0 + c1, cout) and db (cout,), float32,
// zeroed by the caller. ``inv``/``shift`` ((c0 + c1,) over the concat)
// null means the identity prologue; ``ds``/``dq`` null means no
// statistics cotangent (``y`` and ``e`` are then not used). With one and
// a scratch ``e`` of dy's shape (the wrapper passes it where the blocks
// would read dy and y more than twice: input-channel slices x kd > 2),
// the pre-pass (launch_dytot) first writes the rounded dy_tot into e and
// sums db, and the body reads e alone; with ``e`` null each block stages
// y beside dy and forms dy_tot in its pass. Needs c0, c1 % 16 == 0,
// cout % 32 == 0 and kd in {1, 3}.
extern "C" int e3_conv_bnact_wgrad_tc(int nin, const void* x0, int c0,
                                      const void* x1, int c1,
                                      const float* inv, const float* shift,
                                      const void* dy, const void* y,
                                      const float* ds, const float* dq,
                                      void* e, int cout, float* dw,
                                      float* db, int n, int d, int h,
                                      int wd, int kd, int act,
                                      void* stream) {
  if (c0 % 16 || (nin > 1 && c1 % 16) || cout % 32 || (kd != 1 && kd != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  WgTcArgs a = {};
  a.x[0] = static_cast<const __nv_bfloat16*>(x0);
  a.x[1] = static_cast<const __nv_bfloat16*>(x1);
  a.inv = inv;
  a.shift = shift;
  a.cin[0] = c0;
  a.cin[1] = nin > 1 ? c1 : 0;
  a.groups0 = (c0 + CS - 1) / CS;
  a.dy = static_cast<const __nv_bfloat16*>(dy);
  a.y = static_cast<const __nv_bfloat16*>(y);
  a.ds = ds;
  a.dq = dq;
  a.dw = dw;
  a.db = db;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cout = cout;
  a.kd = kd;
  a.act = act;
  const int cob = cout % 64 == 0 ? 64 : 32;
  a.combos = (a.groups0 + (a.cin[1] + CS - 1) / CS) * (cout / cob) * kd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ds != nullptr && e != nullptr) {
    const cudaError_t rc = e3::launch_dytot(
        a.dy, a.y, ds, dq, static_cast<__nv_bfloat16*>(e), db,
        (int64_t)n * d * h * wd, cout, st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    a.dy = static_cast<const __nv_bfloat16*>(e);
    a.ds = a.dq = nullptr;
    a.db = nullptr;
  }
  const cudaError_t rc = cob == 64 ? launch_cob<64>(a, st)
                                   : launch_cob<32>(a, st);
  return static_cast<int>(rc);
}
