// K5 conv_bnact_wgrad, bfloat16 body: the weight gradient of K1's
// (kd, 3, 3) 'same' conv over one or two NDHWC inputs,
//     dW[dz, ky, kx, ci, co] = sum over voxels pos of
//                              a[pos + (dz, ky, kx) - centre, ci]
//                              * dy_tot[pos, co],
// and db[co] = sum of the float32 dy_tot, as a split-K implicit GEMM on
// the tensor cores. The function, its rounding points and its plain
// version are those of conv_bnact_bwd.cu (which keeps the CUDA-core body
// for float32 and for the network input's C_in of 1 or 3): a is the
// RECOMPUTED prologued input rounded to bf16 (0
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
//
// The vup instantiation (Args = WgTcVupArgs; e3_conv_vup_wgrad_tc, the
// bf16 body of conv_vup_wgrad) replaces, for bf16, the wgrad half of
// ops/flat_fused.py::_conv_vup_bwd (row 9). Input 0 of the merge conv is
// the (1, 2, 2) upconv u of the deeper level's carry, which is never
// stored. A block of a slice of u stages, instead of the slab, the
// carry voxels under it (6 x 10 of them for the 10 x 18 slab, cc
// channels, in the same 2-stage ring), prologues and rounds them in
// place, and recomputes u on the tensor cores: one 64 x (4 x 32) x cc
// tile GEMM (vup_mma, upconv_vup.cuh, shared with row 23's body so both
// see the same bits of u) against the slice's columns of K3's packed
// weight, staged once a block. Its epilogue adds the bias, rounds,
// applies the merge conv's prologue, rounds, writes 0 outside the
// volume and stores the values into the slab at its voxel pitch: what
// the CUDA-core body (conv_bnact_bwd.cu, which float32 keeps) does one
// voxel at a time with upconv_value8, 64 FMAs per value. The slab takes
// 180 of the 240 values the GEMM computes (about a third more
// recompute, 3.7 GFLOP on top of the merge's 11 at bench.py's up_2).
// Slices of the skip input are staged as above. What bounds it: the
// bytes of carry, skip, dy and y (0.182 ms at that shape).
#include <type_traits>

#include "tc.cuh"
#include "upconv_vup.cuh"

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

// The vup merge conv's arguments (conv_vup_wgrad): input 0 is the
// (1, 2, 2) upconv of the carry, recomputed per tile on the tensor cores
// (vup_mma, upconv_vup.cuh); kd == 1 and the prologue is always applied.
// A type of its own, so that K5's other instantiations keep the argument
// layout, and the code, they compile to without it.
struct WgTcVupArgs : WgTcArgs {
  const __nv_bfloat16* carry;   // (n, d, h / 2, w / 2, cc) raw carry
  const float* invc;            // (cc,) its prologue
  const float* shiftc;
  const __nv_bfloat16* wup;     // (cc / 16, 4 cu, 16) packed upconv weight
  const float* bu;              // (cu,) float32 bias
  int cc, cu, actc;
  int combos_u;                 // the combos of u's slices (the first)
  int splits_u;                 // blocks per such combo
};

// The recompute's tile: the carry voxels under a TH x TW tile's halo
// slab, VR x VW of them (6 x 10), as the rows of one 64-row GEMM.
constexpr int VR = TH / 2 + 2;
constexpr int VW = TW / 2 + 2;
constexpr int VROWS = 64;
static_assert(VR * VW <= VROWS, "the carry tile is one 64-row GEMM");

// Extra shared memory of the vup instantiation: the carry ring (2 x 64
// rows of cc values at an odd number of 16-byte units), the slice's
// packed upconv columns (cc / 16 x 4 sub-positions x CS rows of 32
// bytes), and invc, shiftc (cc) and bu (CS).
inline size_t vup_smem(const WgTcArgs&) { return 0; }
inline size_t vup_smem(const WgTcVupArgs& a) {
  return (size_t)2 * VROWS * (a.cc * 2 + 16) + (size_t)a.cc * 4 * CS * 2
      + (size_t)(2 * a.cc + CS) * 4;
}

// The vup instantiation's wave: a tile of u's slices costs about
// (4 + 3 cc / 64) / 4 times a skip tile (the recompute GEMM and its
// epilogue; 1.8 times at cc = 64 on the H100), so u's combos take that
// many more splits of the wave, and every block ends at about the same
// time. A skip block's tile t runs beside a u block's, so L2 still
// serves dy and y to the second.
inline void set_vup_splits(WgTcArgs&, int64_t, int64_t, int64_t&) {}
inline void set_vup_splits(WgTcVupArgs& a, int64_t wave, int64_t ntiles,
                           int64_t& blocks) {
  const int64_t wu = 4 + 3 * a.cc / 64, ws = 4;
  const int64_t cs = a.combos - a.combos_u;
  int64_t ss = wave * ws / (wu * a.combos_u + ws * cs);
  if (ss > ntiles) ss = ntiles;
  if (ss < 1) ss = 1;
  int64_t su = ss * wu / ws;
  if (su > ntiles) su = ntiles;
  a.splits = (int)ss;
  a.splits_u = (int)su;
  blocks = su * a.combos_u + ss * cs;
}

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

template <int COB, bool PRO, bool DYT, typename Args = WgTcArgs>
__global__ void __launch_bounds__(NT, 2)
wgrad_tc_kernel(const Args a) {
  constexpr bool VUP = std::is_same<Args, WgTcVupArgs>::value;
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
  int combo = (int)(blockIdx.x % a.combos);
  int split = (int)(blockIdx.x / a.combos);
  int splits = a.splits;
  if constexpr (VUP) {
    // The first combos_u * splits_u blocks take u's slices (whose tiles
    // also run the recompute), the rest the skip's: a.splits each.
    const int nu = a.combos_u * a.splits_u;
    const int b = (int)blockIdx.x - nu;
    combo = b < 0 ? (int)blockIdx.x % a.combos_u
                  : a.combos_u + b % (a.combos - a.combos_u);
    split = b < 0 ? (int)blockIdx.x / a.combos_u
                  : b / (a.combos - a.combos_u);
    splits = b < 0 ? a.splits_u : a.splits;
  }
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
  // The vup slice: input 0's channels come from the recompute.
  const bool vup0 = VUP && i == 0;
  unsigned char* s_c = reinterpret_cast<unsigned char*>(s_db + COB);
  int cxp = 0, cxb = 0;
  unsigned char* s_wu = s_c;
  float* s_invc = s_db;
  float* s_shiftc = s_db;
  float* s_bu = s_db;
  if constexpr (VUP) {
    cxp = a.cc * 2 + 16;                  // carry row pitch, bytes
    cxb = VROWS * cxp;
    s_wu = s_c + 2 * cxb;                 // [cc / 16][4 x CS][32], swz
    s_invc = reinterpret_cast<float*>(s_wu + a.cc * 4 * CS * 2);
    s_shiftc = s_invc + a.cc;
    s_bu = s_shiftc + a.cc;               // [CS]
    if (vup0) {
      for (int c = tid; c < a.cc; c += NT) {
        s_invc[c] = a.invc[c];
        s_shiftc[c] = a.shiftc[c];
      }
      for (int c = tid; c < CS; c += NT) s_bu[c] = a.bu[cb + c];
      // The slice's columns of the packed weight: row (sub, j) of k16
      // step kc is packed column sub * cu + cb + j. With the first tile.
      for (int p = tid; p < a.cc / 16 * 4 * CS * 2; p += NT) {
        const int hf = p & 1;
        const int row = p >> 1;            // kc * 4 CS + sub * CS + j
        const int kc = row / (4 * CS);
        const int col = (row / CS % 4) * a.cu + cb + row % CS;
        cp_async16(smem_u32(s_wu + swz(row, hf)),
                   a.wup + ((int64_t)kc * 4 * a.cu + col) * 16 + hf * 8,
                   true);
      }
    }
  }

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
    if constexpr (VUP) {
      if (vup0) {
        // The carry voxels under the slab, rows 60-63 zero-filled.
        const int h2 = a.h / 2, w2 = a.wd / 2;
        unsigned char* sc = s_c + slot * cxb;
        for (int p = tid; p < VROWS * (a.cc / 8); p += NT) {
          const int r = p / (a.cc / 8);
          const int ch = p % (a.cc / 8);
          const int cr = tl.h0 / 2 - 1 + r / VW;
          const int cc = tl.w0 / 2 - 1 + r % VW;
          const bool ok = r < VR * VW && cr >= 0 && cr < h2 && cc >= 0
              && cc < w2;
          cp_async16(smem_u32(sc + r * cxp + ch * 16),
                     ok ? a.carry + ((tl.iplane * h2 + cr) * w2 + cc) * a.cc
                              + ch * 8
                        : a.carry,
                     ok);
        }
      }
    }
    for (int p = tid; p < NSLAB * 4; p += NT) {
      const int ch = p & 3;
      if (vup0 || ch * 8 >= cw) continue;
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
  for (int64_t t = split; t < ntiles; t += splits, slot ^= 1) {
    cp_async_wait<0>();  // tile t has landed
    __syncthreads();     // for every thread; the other slot is free
    if (t + splits < ntiles) load(t + splits, slot ^ 1);
    cp_async_commit();
    unsigned char* sx = smem + slot * STAGE;
    unsigned char* sg = sx + SLAB;
    if constexpr (VUP) {
      if (vup0) {
        // The carry tile's prologue, in place: rounded a.
        unsigned char* sc = s_c + slot * cxb;
        for (int p = tid; p < VROWS * (a.cc / 8); p += NT) {
          const int ch = p % (a.cc / 8);
          prologue_half(reinterpret_cast<uint4*>(sc + (p / (a.cc / 8)) * cxp
                                                 + ch * 16),
                        s_invc + ch * 8, s_shiftc + ch * 8, a.actc, true);
        }
      }
    }
    if (PRO || DYT || do_db) {
      const Tile tl = tile_at(a, t, dzp);
      if (PRO && !vup0)
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
    if constexpr (VUP) {
      if (vup0) {
        // The recompute: u of every carry voxel of the tile at its four
        // sub-positions for the slice's CS channels (64 x 4 CS, one unit
        // a (m16 tile, sub-position) of 16 rows x CS columns), then
        // bias, round, the merge conv's prologue, round, 0 outside the
        // volume, into the slab at its voxel pitch. 180 of the 240
        // values a tile computes fall inside the slab.
        const Tile tl = tile_at(a, t, dzp);
        const uint32_t c_lane = smem_u32(s_c + slot * cxb)
            + (lane & 15) * cxp + (lane >> 4) * 16;
        const uint32_t w_lane = smem_u32(s_wu)
            + swz((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
        const int g = lane / 4;
        const int t4 = lane % 4;
        for (int u = warp; u < VROWS / 16 * 4; u += NT / 32) {
          const int mi = u % (VROWS / 16);
          const int sub = u / (VROWS / 16);
          const int col[2] = {sub * CS, sub * CS + 16};
          float uacc[1][4][4];
          vup_mma<1, 2>(c_lane + mi * 16 * cxp, cxp, w_lane, col, 4 * CS,
                        a.cc / 16, uacc);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = mi * 16 + g + 8 * hr;
            const int hh = 2 * (tl.h0 / 2 - 1 + r / VW) + (sub >> 1);
            const int ww = 2 * (tl.w0 / 2 - 1 + r % VW) + (sub & 1);
            const int sy = hh - tl.h0 + 1;
            const int sxx = ww - tl.w0 + 1;
            if (r >= VR * VW || sy < 0 || sy >= TH + 2 || sxx < 0
                || sxx >= SW)
              continue;
            const bool ok = hh >= 0 && hh < a.h && ww >= 0 && ww < a.wd;
#pragma unroll
            for (int nj = 0; nj < 4; ++nj) {
              const int j = nj * 8 + 2 * t4;
              const float u0 = vup_round(uacc[0][nj][2 * hr], s_bu[j]);
              const float u1 = vup_round(uacc[0][nj][2 * hr + 1], s_bu[j + 1]);
              *reinterpret_cast<__nv_bfloat162*>(
                  sx + (sy * SW + sxx) * SPITCH + j * 2) = ok
                  ? __floats2bfloat162_rn(
                        prologue(u0, s_inv[j], s_shift[j], a.act),
                        prologue(u1, s_inv[j + 1], s_shift[j + 1], a.act))
                  : __floats2bfloat162_rn(0.0f, 0.0f);
            }
          }
        }
        __syncthreads();
      }
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
template <int COB, bool PRO, bool DYT, typename Args = WgTcArgs>
cudaError_t launch(Args a, cudaStream_t stream) {
  const size_t smem = wgrad_tc_smem<COB, DYT>() + vup_smem(a);
  auto kern = wgrad_tc_kernel<COB, PRO, DYT, Args>;
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
  int64_t blocks = splits * a.combos;
  set_vup_splits(a, (int64_t)per_sm * sm_count(), ntiles, blocks);
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

template <int COB>
cudaError_t launch_vup(const WgTcVupArgs& a, cudaStream_t st) {
  return a.ds != nullptr ? launch<COB, true, true, WgTcVupArgs>(a, st)
                         : launch<COB, true, false, WgTcVupArgs>(a, st);
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

// K5 of the vup merge conv, bf16 body (conv_vup_wgrad): input 0 is the
// (1, 2, 2) upconv of the carry (cu channels, recomputed per tile on the
// tensor cores from the raw carry, its prologue invc/shiftc/actc, K3's
// packed (cc / 16, 4 cu, 16) bf16 weight ``wup`` and the float32 bias
// ``bu``), input 1 the skip (cs channels); kd = 1. dW (1, 3, 3, cu + cs,
// cout) and db (cout,) are float32, zeroed by the caller. ``inv`` and
// ``shift`` ((cu + cs,), over the concat) must be given; ``ds``/``dq``
// and the pre-pass's scratch ``e`` as in e3_conv_bnact_wgrad_tc. Needs
// cc % 32 == 0 and cc <= 128, cu in {32, 64}, cs % 16 == 0 and
// cout % 32 == 0; (n, d, h, wd) are the skip's dims.
extern "C" int e3_conv_vup_wgrad_tc(const void* carry, int cc,
                                    const float* invc, const float* shiftc,
                                    const void* wup, const float* bu, int cu,
                                    int actc, const void* skip, int cs,
                                    const float* inv, const float* shift,
                                    const void* dy, const void* y,
                                    const float* ds, const float* dq,
                                    void* e, int cout, float* dw, float* db,
                                    int n, int d, int h, int wd, int act,
                                    void* stream) {
  if (cc % 32 || cc > 128 || (cu != 32 && cu != 64) || cs % 16
      || cout % 32 || h % 2 || wd % 2 || inv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  WgTcVupArgs a = {};
  a.x[1] = static_cast<const __nv_bfloat16*>(skip);
  a.inv = inv;
  a.shift = shift;
  a.cin[0] = cu;
  a.cin[1] = cs;
  a.groups0 = cu / CS;
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
  a.kd = 1;
  a.act = act;
  a.carry = static_cast<const __nv_bfloat16*>(carry);
  a.invc = invc;
  a.shiftc = shiftc;
  a.wup = static_cast<const __nv_bfloat16*>(wup);
  a.bu = bu;
  a.cc = cc;
  a.cu = cu;
  a.actc = actc;
  const int cob = cout % 64 == 0 ? 64 : 32;
  a.combos = (a.groups0 + (cs + CS - 1) / CS) * (cout / cob);
  a.combos_u = a.groups0 * (cout / cob);
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
  const cudaError_t rc = cob == 64 ? launch_vup<64>(a, st)
                                   : launch_vup<32>(a, st);
  return static_cast<int>(rc);
}
