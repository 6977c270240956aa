// Row 9's input gradients, conv_vup_dgrad, bfloat16 body: the backward of
// the vup merge conv (conv_tc.cu's e3_conv_vup_tc) into its skip input,
// its prologue vectors and, through the (1, 2, 2) upconv u that was never
// stored, into the deeper level's carry, its prologue and the upconv's
// weight, as ONE kernel on the tensor cores whose E never leaves the chip:
//     g   = round(dy_tot),  dy_tot = dy + ds + 2 y dq (float32)
//     gin = the 'same' (1, 3, 3) conv of g with the flipped, transposed
//           merge weight (K4's GEMM)
//   skip columns (K4's epilogue):
//     gm = gin * act'(skip * inv + shift), dskip = round(gm * inv),
//     dinv1 = sum gm * skip, dshift1 = sum gm;
//   u columns, u recomputed (vup_mma, upconv_vup.cuh):
//     gm = gin * act'(u * inv0 + shift0), dinv0 = sum gm * u,
//     dshift0 = sum gm, E = round(gm * inv0);
//   the chain (row 23's GEMMs 2 and 3, upconv_vup.cuh) on E:
//     G = E Wu^T, gm_c = G * act_c'(carry * invc + shiftc),
//     dcarry = round(gm_c * invc), dinvc = sum gm_c * carry,
//     dshiftc = sum gm_c, dWu = sum a^T E (a the prologued carry).
// The upconv bias gradient sum(gm * inv0) is inv0 * dshift0, formed by
// the wrapper (vup.conv_vup_dgrad_kernel). The function, its rounding
// points and its plain version (vup.conv_vup_dgrad_plain) are those of
// the CUDA-core path (conv_vup.cu's e3_conv_vup_dgrad, K4's VUP body,
// then e3_conv_vup_chain on a scratch E of u's shape), which float32
// keeps.
//
// Replaces, for bf16, the dgrad half of the TPU kernel of the JAX package
//   ops/flat_fused.py::_conv_vup_bwd (_fused_conv_bwd_kernel's vup mode,
//   its pallas_call), whose E never leaves VMEM.
//
// What bounds it on the card: the bytes of dy, y, skip, dskip, carry and
// dcarry, each moved once (0.260 ms at bench.py's up_2 on the H100's
// 3.35 TB/s), against K4's GEMM (2 x 9 x C_dy x (C_u + C_s) FLOP an
// output voxel) and three small GEMMs a carry voxel. The design:
//   - a work item is a TH x TW tile of output voxels of one (n, depth)
//     plane (K4's geometry with COB = 64: TH x TW = 8 x 32 or 16 x 16,
//     TW by the width as K1's) and 64 dx columns; the tile's origin and
//     TH and TW are even, so it covers exactly the four sub-positions of
//     TH / 2 x TW / 2 = 64 whole carry voxels, row 23's tile. Columns
//     0-63 (one item where C_u + C_s <= 64, bench.py's 32 + 32) hold all
//     of u's and the item runs the recompute and the chain; a wider skip
//     takes further items of 64 columns (the weight's columns padded with
//     zeros to a multiple of 64), which run K4's epilogue alone;
//   - one block an SM walks a strided share of the items (tile-major, so
//     the items of one tile run side by side and L2 serves dy and y to
//     the second), keeping dWu's sums in registers and the prologue
//     gradients' in shared memory for its walk, with K3's packed upconv
//     weight staged once;
//   - K4's GEMM: the raw dy and y slabs and the step's 9 taps of weights
//     through the 2-stage cp.async ring, dy_tot formed in place
//     (dytot_half), 8 warps of 64 x 32 mma.sync tiles (tap_mma9,
//     conv_tc.cuh);
//   - after the K loop the ring is free: the carry tile (loaded with the
//     first step) is prologued into a, GEMM 1 (vup_mma) recomputes u
//     into slot 1 as row 23's E layout (64 carry voxels x 4 C_u, bf16: u
//     is bf16 already), and the epilogue, on the accumulator registers,
//     reads u at each lane's (voxel, channel pair), forms gm, sums dinv0
//     and dshift0 and overwrites u with E in place (each entry is one
//     lane's); the skip's columns are K4's epilogue, on the item's skip
//     values staged in the other slot during the last K step (read from
//     device memory between the stores, they took 0.68 of 2.21 ms at
//     bench.py's up_2 on an H100: PERF.md); its addresses are shifts and
//     32-bit offsets from the tile's first voxel;
//   - GEMMs 2 and 3 on E, the carry tile and a, as row 23 runs them.
// The 174.4 MB scratch E of the CUDA-core path (at bench.py's up_2) does
// not exist here. Template cases: cc in {32, 64, 96, 128} and cu in
// {32, 64} (vup.vup_body names the CUDA-core path for others).
//
// mma.sync rather than wgmma, as in the other tensor-core bodies: K4's
// A operand is a shifted window of the staged slab per tap, and the four
// GEMMs chain through shared memory in one block.
//
// The per-sample mode (group and instance norm; PS, instantiations of
// their own; JAX's per_sample = inv.ndim == 3, flat_fused.py:968): ds,
// dq, the merge's prologue and the carry's are (n, C) rows at their
// sample strides, read by each item from its sample's rows (device
// memory through L1) where the batch form reads the block's staged
// ones. An item lies in one (n, depth) plane, so in one sample: its
// dinv and dshift columns and (with u's columns) its chain's dinvc and
// dshiftc sums go, the warps added in turn, into the partial row of its
// tile (slot d * tiles of a sample, ps_reduce.cuh), which ps_reduce sums
// in a fixed order into (n, 2, C): no float atomics across blocks, so
// the same bits on every run and for every batch size. dWu stays global.
#include <type_traits>

#include "conv_tc.cuh"
#include "ps_reduce.cuh"
#include "upconv_vup.cuh"

namespace {

using namespace e3;

constexpr int COB = 64;      // dx columns of a work item
using C = Cfg<COB>;          // 256 voxels: 4 x 2 warps of 64 x 32
constexpr int SKP = COB * 2 + 16;   // skip tile row pitch, bytes

struct VdArgs {
  const __nv_bfloat16* g;    // (n, d, h, w, cdy) dy
  const __nv_bfloat16* y;    // the forward output
  const float* ds;           // (cdy,) statistics cotangents (zeros: none)
  const float* dq;
  int cdy;
  const __nv_bfloat16* wp;   // (1, cdy / 16, 9, ctp, 16) flipped, transposed
  const __nv_bfloat16* skip; // (n, d, h, w, cs)
  int cu, cs, ctp, nz;       // ctp: cu + cs up to a multiple of 64; nz: / 64
  const float* inv;          // (cu + cs,) the merge's prologue
  const float* shift;
  __nv_bfloat16* dskip;
  float* dinv;               // (cu + cs,), zeroed
  float* dshift;
  const __nv_bfloat16* carry;   // (n, d, h / 2, w / 2, cc) raw carry
  const float* invc;         // (cc,) its prologue
  const float* shiftc;
  const __nv_bfloat16* wup;  // (cc / 16, 4 cu, 16) packed upconv weight
  const float* bu;           // (cu,) float32 bias
  __nv_bfloat16* dcarry;
  float* dinvc;              // (cc,), zeroed
  float* dshiftc;
  float* dwu;                // (2, 2, cc, cu), zeroed
  int n, d, h, wd, act, actc, tw;
  int64_t items;             // tiles x nz
};

// The per-sample mode's arguments (a type of their own, so that the batch
// form's code stays as it was): the rows' sample strides (ds, dq: cdy;
// the merge's prologue: cu + cs; the carry's: cc), and the partial rows
// of dinv, dshift (n, parts, 2 (cu + cs)) and of dinvc, dshiftc (n,
// parts, 2 cc), parts = d * tiles a sample.
struct VdPsArgs : VdArgs {
  int st_ns, pro_ns, cc_ns;
  float* part;
  float* partc;
};

// Shared memory: the ring, slot-major (slot s: its dy slab, its y slab
// and its 9 taps of weights; an item's steps take slots 0, 1, 0, ...,
// and after its K loop slot 1 holds E's rows, [VBM][EP]), the packed
// upconv weight, the raw carry tile and a, each carry row's voxel, the
// slab's voxel offsets, then ds, dq, the block's dinv and dshift sums
// (ctp each), invc, shiftc, the block's dinvc and dshiftc sums and bu.
template <int CC, int CU>
struct VdLayout {
  int npos, abytes, slot, s_w, s_x, s_ac, s_cv, s_off, s_f, total;
  __host__ __device__ VdLayout(int tw, int cdy, int ctp) {
    using K = ChainCfg<CC, CU>;
    npos = (C::M / tw + 2) * (tw + 2);
    abytes = npos * APITCH;
    slot = 2 * abytes + C::BSTAGE;
    s_w = KST * slot;
    s_x = s_w + K::WBYTES;
    s_ac = s_x + VBM * K::XP;
    s_cv = s_ac + VBM * K::XP;           // int64_t [VBM]
    s_off = s_cv + VBM * 8;              // int [npos]
    s_f = s_off + npos * 4;              // floats
    total = s_f + (2 * cdy + 2 * ctp + 4 * CC + CU) * 4;
  }
};

// A work item: its (n, depth) plane, its tile's origin, its first dx
// column and whether it holds u's columns (and so runs the chain).
struct Item {
  int64_t nd;
  int h0, w0, co0;
  bool vz;
};

template <int CC, int CU, typename Args = VdArgs>
__global__ void __launch_bounds__(NT, 1)
conv_vup_dgrad_tc_kernel(const Args a) {
  constexpr bool PS = std::is_same<Args, VdPsArgs>::value;
  using K = ChainCfg<CC, CU>;
  // E's rows and the skip tile each fit in a ring slot (at least 18 x
  // 18 slab voxels a slab).
  static_assert(VBM * K::EP <= 2 * 18 * 18 * APITCH + C::BSTAGE, "E");
  static_assert(C::M * SKP <= 2 * 18 * 18 * APITCH + C::BSTAGE, "skip");
  extern __shared__ __align__(128) unsigned char smem[];
  const int tw = a.tw;
  const int th = C::M / tw;
  const int hw = tw + 2;                      // slab width
  const int lg = tw == 32 ? 5 : 4;            // log2(tw)
  const VdLayout<CC, CU> L(tw, a.cdy, a.ctp);
  const int npos = L.npos;
  const int abytes = L.abytes;
  const int sb = L.slot;                      // bytes of a ring slot
  const int nsteps = a.cdy / 16;              // kd = 1
  // After the K loop E's rows take the last step's slot; the skip's
  // columns of the item arrive during the last step in the other slot.
  unsigned char* s_e = smem + ((nsteps - 1) % KST) * sb;
  unsigned char* s_sk = smem + (nsteps % KST) * sb;   // [M][SKP]
  unsigned char* s_w = smem + L.s_w;          // [CC/16][4 CU][32], swz
  unsigned char* s_x = smem + L.s_x;          // [VBM][XP] raw carry
  unsigned char* s_ac = smem + L.s_ac;        // [VBM][XP] prologued
  int64_t* s_cv = reinterpret_cast<int64_t*>(smem + L.s_cv);
  int* s_off = reinterpret_cast<int*>(smem + L.s_off);
  float* s_ds = reinterpret_cast<float*>(smem + L.s_f);   // [cdy]
  float* s_dq = s_ds + a.cdy;
  float* s_red = s_dq + a.cdy;                // [2][ctp] dinv, dshift
  float* s_invc = s_red + 2 * a.ctp;          // [CC]
  float* s_shiftc = s_invc + CC;
  float* s_redc = s_shiftc + CC;              // [2][CC] dinvc, dshiftc
  float* s_bu = s_redc + 2 * CC;              // [CU]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gr = lane / 4;
  const int t4 = lane % 4;
  const int wm = warp / C::WARPS_N;
  const int wn = warp % C::WARPS_N;
  const int tiles_w = (a.wd + tw - 1) / tw;
  const int tiles = ((a.h + th - 1) / th) * tiles_w;
  const int h2 = a.h / 2, w2 = a.wd / 2;
  const int ct = a.cu + a.cs;

  for (int c = tid; c < a.cdy; c += NT) {
    s_ds[c] = a.ds[c];
    s_dq[c] = a.dq[c];
  }
  for (int c = tid; c < 2 * a.ctp; c += NT) s_red[c] = 0.0f;
  for (int c = tid; c < CC; c += NT) {
    s_invc[c] = a.invc[c];
    s_shiftc[c] = a.shiftc[c];
    s_redc[c] = s_redc[CC + c] = 0.0f;
  }
  for (int c = tid; c < CU; c += NT) s_bu[c] = a.bu[c];
  // The packed upconv weight, once (landing with the first item's step).
  for (int i = tid; i < CC / 16 * K::NCOL * 2; i += NT)
    cp_async16(smem_u32(s_w + swz(i >> 1, i & 1)),
               a.wup + (int64_t)(i >> 1) * 16 + (i & 1) * 8, true);

  auto item_at = [&](int64_t it) {
    Item t;
    const int64_t ti = it / a.nz;
    const int tile = (int)(ti % tiles);
    t.nd = ti / tiles;
    t.h0 = (tile / tiles_w) * th;
    t.w0 = (tile % tiles_w) * tw;
    t.co0 = (int)(it % a.nz) * COB;
    t.vz = t.co0 == 0;
    return t;
  };
  // Each slab voxel's index in its plane, or -1 outside the volume.
  auto set_off = [&](const Item& t) {
    for (int pos = tid; pos < npos; pos += NT) {
      const int gh = t.h0 + pos / hw - 1;
      const int gw = t.w0 + pos % hw - 1;
      s_off[pos] = gh >= 0 && gh < a.h && gw >= 0 && gw < a.wd
          ? gh * a.wd + gw : -1;
    }
  };
  // Carry voxel r of the tile, (h0 / 2 + r / (tw / 2), w0 / 2 + r %
  // (tw / 2)), or -1 outside the volume; then its cp.async (no commit).
  auto set_cv = [&](const Item& t) {
    for (int r = tid; r < VBM; r += NT) {
      const int hc = t.h0 / 2 + r / (tw / 2);
      const int wc = t.w0 / 2 + r % (tw / 2);
      s_cv[r] = hc < h2 && wc < w2 ? (t.nd * h2 + hc) * w2 + wc : -1;
    }
  };
  auto load_carry = [&]() {
    for (int i = tid; i < VBM * (CC / 8); i += NT) {
      const int r = i / (CC / 8);
      const int ch = i % (CC / 8);
      const int64_t v = s_cv[r];
      cp_async16(smem_u32(s_x + r * K::XP + ch * 16),
                 v >= 0 ? a.carry + v * CC + ch * 8 : a.carry, v >= 0);
    }
  };
  // K4's step st of item t (k16 step st of dy's channels): its dy and y
  // slabs and its 9 taps of the item's 64 columns into slot st % KST.
  auto load = [&](const Item& t, int st) {
    const int64_t base = t.nd * a.h * a.wd * a.cdy + st * 16;
    unsigned char* sl = smem + (st % KST) * sb;
    for (int p = tid; p < npos * 2; p += NT) {
      const int off = s_off[p >> 1];
      const int64_t src =
          off >= 0 ? base + (int64_t)off * a.cdy + (p & 1) * 8 : 0;
      const int dst = (p >> 1) * APITCH + (p & 1) * 16;
      cp_async16(smem_u32(sl + dst), a.g + src, off >= 0);
      cp_async16(smem_u32(sl + abytes + dst), a.y + src, off >= 0);
    }
    unsigned char* db = sl + 2 * abytes;
    const __nv_bfloat16* wsrc =
        a.wp + ((int64_t)st * 9 * a.ctp + t.co0) * 16;
    for (int p = tid; p < 9 * COB * 2; p += NT) {
      const int row = p >> 1;         // tap * COB + dx column
      cp_async16(smem_u32(db + swz(row, p & 1)),
                 wsrc + ((int64_t)(row / COB) * a.ctp + row % COB) * 16
                     + (p & 1) * 8,
                 true);
    }
    cp_async_commit();
  };

  // The item's skip channels sk0 .. sk0 + nsk (nsk % 32 == 0) at the
  // tile's voxels, row m = r * tw + c, 0 outside the volume.
  auto load_skip = [&](const Item& t, int sk0, int nsk) {
    const int64_t v00 = (t.nd * a.h + t.h0) * a.wd + t.w0;
    for (int p = tid; p < C::M * (nsk / 8); p += NT) {
      const int m = p / (nsk / 8);
      const int ch = p % (nsk / 8);
      const int r = m >> lg;
      const int c = m & (tw - 1);
      const bool ok = t.h0 + r < a.h && t.w0 + c < a.wd;
      cp_async16(smem_u32(s_sk + m * SKP + ch * 16),
                 ok ? a.skip + (v00 + r * a.wd + c) * a.cs + sk0 + ch * 8
                    : a.skip,
                 ok);
    }
    cp_async_commit();
  };

  // Each lane's ldmatrix rows: K4's A (m16 tile mi at tap (0, 0)) and B
  // (tap 0) in slot 0, GEMM 1's (row 23's layout) and the chain's.
  uint32_t arow[C::MI];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi) {
    const int m = wm * C::WM + mi * 16 + (lane & 15);
    arow[mi] = smem_u32(smem) + ((m / tw) * hw + m % tw) * APITCH
        + (lane >> 4) * 16;
  }
  const uint32_t brow = smem_u32(smem) + 2 * abytes
      + swz(wn * 32 + (lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  const int wm1 = warp % 2, wn1 = warp / 2;
  const int wm2 = warp % 4, wn2 = warp / 4;
  const uint32_t a1_lane = smem_u32(s_ac) + (wm1 * 32 + (lane & 15)) * K::XP
      + (lane >> 4) * 16;
  const uint32_t w1_lane = smem_u32(s_w)
      + swz((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  const ChainLanes<CC, CU> lanes(s_e, s_w, s_ac, warp, lane);

  float acc3[K::MI3][K::NJ3][4];
#pragma unroll
  for (int mt = 0; mt < K::MI3; ++mt)
#pragma unroll
    for (int nj = 0; nj < K::NJ3; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc3[mt][nj][e] = 0.0f;

  for (int64_t it = blockIdx.x; it < a.items; it += gridDim.x) {
    const Item t = item_at(it);
    // The rows the item reads: the block's staged ones, or (PS) its
    // sample's.
    // PS: the item's sample and its tile's partial-row slot there.
    const float* rds = s_ds;
    const float* rdq = s_dq;
    const float* rinvc = s_invc;
    const float* rshiftc = s_shiftc;
    int64_t po = 0, prow = 0;
    if constexpr (PS) {
      const int64_t smp = t.nd / a.d;
      prow = it / a.nz;   // (smp, slot): the tile's index over the batch
      rds = a.ds + smp * a.st_ns;
      rdq = a.dq + smp * a.st_ns;
      rinvc = a.invc + smp * a.cc_ns;
      rshiftc = a.shiftc + smp * a.cc_ns;
      po = smp * a.pro_ns;
    }
    __syncthreads();   // the previous item's reads of shared memory done
    set_off(t);
    if (t.vz) set_cv(t);
    __syncthreads();
    if (t.vz) load_carry();
    load(t, 0);

    // K4's GEMM. The item's skip columns: none where u's fill them.
    const int sk0 = max(t.co0 - a.cu, 0);
    const int nsk = max(min(t.co0 + COB, ct) - max(t.co0, a.cu), 0);
    float acc[C::MI][4][4];
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;
    for (int st = 0; st < nsteps; ++st) {
      cp_async_wait<0>();        // step st (and the carry) has landed
      __syncthreads();           // for every thread; step st - 1's MMAs done
      if (st + 1 < nsteps) load(t, st + 1);
      else if (nsk > 0) load_skip(t, sk0, nsk);   // into the other slot
      const int so = (st % KST) * sb;
      for (int p = tid; p < npos * 2; p += NT) {
        const int c = st * 16 + (p & 1) * 8;
        const int o = so + (p >> 1) * APITCH + (p & 1) * 16;
        dytot_half(reinterpret_cast<uint4*>(smem + o),
                   reinterpret_cast<const uint4*>(smem + o + abytes),
                   rds + c, rdq + c, s_off[p >> 1] >= 0, nullptr);
      }
      __syncthreads();
      tap_mma9<COB>(acc, arow, so, brow + so, hw);
    }
    cp_async_wait<0>();  // the skip tile has landed
    __syncthreads();     // every warp's MMAs are done: the last slot is free
    if (t.vz) {
      // a = round(act_c(carry * invc + shiftc)), 0 outside the volume.
      for (int i = tid; i < VBM * (CC / 8); i += NT) {
        const int r = i / (CC / 8);
        const int ch = i % (CC / 8);
        uint4* dst = reinterpret_cast<uint4*>(s_ac + r * K::XP + ch * 16);
        *dst = *reinterpret_cast<const uint4*>(s_x + r * K::XP + ch * 16);
        prologue_half(dst, rinvc + ch * 8, rshiftc + ch * 8, a.actc,
                      s_cv[r] >= 0);
      }
      __syncthreads();
      // GEMM 1, the recompute: u (bf16 values) into E's rows.
#pragma unroll
      for (int j = 0; j < K::NCOL / 128; ++j) {
        const int col[2] = {j * 128 + wn1 * 32, j * 128 + wn1 * 32 + 16};
        float uacc[2][4][4];
        vup_mma<2, 2>(a1_lane, K::XP, w1_lane, col, K::NCOL, CC / 16, uacc);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int cl = col[0] + nj * 8 + 2 * t4;
          const float b0 = s_bu[cl % CU], b1 = s_bu[cl % CU + 1];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int r = wm1 * 32 + mi * 16 + gr + 8 * hr;
              *reinterpret_cast<uint32_t*>(s_e + r * K::EP + cl * 2) =
                  pack_bf16x2(vup_round(uacc[mi][nj][2 * hr], b0),
                              vup_round(uacc[mi][nj][2 * hr + 1], b1));
            }
        }
      }
      __syncthreads();
    }

    // The epilogue from the accumulators: lane (gr, t4) holds voxels gr
    // and gr + 8 of each m16 tile, dx columns 2 t4 and 2 t4 + 1 of each
    // n8 tile (u's or the skip's by warp: each has C % 32 == 0); row m of
    // the tile is voxel (r, c) = (m >> lg, m & (tw - 1)). x is u from E's
    // rows or the skip from its staged tile, both in shared memory; dskip
    // goes out at a 32-bit offset from the tile's first voxel.
    const int64_t v00 = (t.nd * a.h + t.h0) * a.wd + t.w0;
    float sx[4][2], sg[4][2];   // dinv and dshift partials
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int co = t.co0 + wn * 32 + nj * 8 + 2 * t4;
      sx[nj][0] = sx[nj][1] = sg[nj][0] = sg[nj][1] = 0.0f;
      if (co >= ct) continue;            // the weight's zero padding
      const bool isu = co < a.cu;
      const float inv0 = a.inv[po + co], inv1 = a.inv[po + co + 1];
      const float sh0 = a.shift[po + co], sh1 = a.shift[po + co + 1];
      unsigned char* eb = s_e + co * 2;                     // u's columns
      const unsigned char* kb = s_sk + (co - a.cu - sk0) * 2;   // the skip's
      __nv_bfloat16* dp = a.dskip + v00 * a.cs + co - a.cu;
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int m = wm * C::WM + mi * 16 + gr + 8 * hr;
          const int r = m >> lg;
          const int c = m & (tw - 1);
          uint32_t* ep = reinterpret_cast<uint32_t*>(
              eb + ((r >> 1) * (tw >> 1) + (c >> 1)) * K::EP
              + ((r & 1) * 2 + (c & 1)) * CU * 2);
          if (t.h0 + r >= a.h || t.w0 + c >= a.wd) {
            if (isu) *ep = 0u;            // E = 0 outside the volume
            continue;
          }
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  isu ? reinterpret_cast<const unsigned char*>(ep)
                      : kb + m * SKP));
          float g0 = acc[mi][nj][2 * hr]
              * act_grad(pre_act(x.x, inv0, sh0), a.act);
          float g1 = acc[mi][nj][2 * hr + 1]
              * act_grad(pre_act(x.y, inv1, sh1), a.act);
          sx[nj][0] = fmaf(g0, x.x, sx[nj][0]);
          sx[nj][1] = fmaf(g1, x.y, sx[nj][1]);
          sg[nj][0] += g0;
          sg[nj][1] += g1;
          g0 *= inv0;
          g1 *= inv1;
          if (isu)
            *ep = pack_bf16x2(g0, g1);
          else
            *reinterpret_cast<__nv_bfloat162*>(dp + (r * a.wd + c) * a.cs) =
                __floats2bfloat162_rn(g0, g1);
        }
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          sx[nj][e] += __shfl_xor_sync(0xffffffffu, sx[nj][e], o);
          sg[nj][e] += __shfl_xor_sync(0xffffffffu, sg[nj][e], o);
        }
    if constexpr (PS) {
      // The warp rows in turn (the warps of a row hold distinct
      // columns), then the item's columns into its tile's partial row.
      for (int w = 0; w < C::WARPS_M; ++w) {
        if (wm == w && gr == 0) {
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int co = t.co0 + wn * 32 + nj * 8 + 2 * t4 + e;
              if (co >= ct) continue;
              s_red[co] += sx[nj][e];
              s_red[a.ctp + co] += sg[nj][e];
            }
        }
        __syncthreads();
      }
      float* const row = a.part + prow * 2 * ct;
      for (int c = tid; c < COB; c += NT) {
        const int co = t.co0 + c;
        if (co >= ct) continue;
        row[co] = s_red[co];
        row[ct + co] = s_red[a.ctp + co];
        s_red[co] = s_red[a.ctp + co] = 0.0f;
      }
    } else if (gr == 0) {
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = t.co0 + wn * 32 + nj * 8 + 2 * t4 + e;
          if (co >= ct) continue;
          atomicAdd(&s_red[co], sx[nj][e]);
          atomicAdd(&s_red[a.ctp + co], sg[nj][e]);
        }
    }

    // The chain: GEMM 2 with K7's epilogue into dcarry, then GEMM 3.
    if (t.vz) {
      __syncthreads();   // E is complete
      float acc2[K::NJ2][4];
      float si[K::NJ2][2], ss[K::NJ2][2];
#pragma unroll
      for (int nj = 0; nj < K::NJ2; ++nj)
        si[nj][0] = si[nj][1] = ss[nj][0] = ss[nj][1] = 0.0f;
      chain_gemm2<CC, CU>(lanes, wn2, acc2);
      chain_dcarry<CC>(acc2, s_x, rinvc, rshiftc, a.actc, wm2, wn2, lane,
                       [&](int r) -> int64_t { return s_cv[r]; }, a.dcarry,
                       si, ss);
#pragma unroll
      for (int nj = 0; nj < K::NJ2; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            si[nj][e] += __shfl_xor_sync(0xffffffffu, si[nj][e], o);
            ss[nj][e] += __shfl_xor_sync(0xffffffffu, ss[nj][e], o);
          }
      if constexpr (PS) {
        // GEMM 2's warp rows in turn, then the tile's partial row.
        for (int w = 0; w < 4; ++w) {
          if (wm2 == w && gr == 0) {
#pragma unroll
            for (int nj = 0; nj < K::NJ2; ++nj)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = wn2 * (CC / 2) + nj * 8 + 2 * t4 + e;
                s_redc[c] += si[nj][e];
                s_redc[CC + c] += ss[nj][e];
              }
          }
          __syncthreads();
        }
        float* const row = a.partc + prow * 2 * CC;
        for (int c = tid; c < 2 * CC; c += NT) {
          row[c] = s_redc[c];
          s_redc[c] = 0.0f;
        }
      } else if (gr == 0) {
#pragma unroll
        for (int nj = 0; nj < K::NJ2; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = wn2 * (CC / 2) + nj * 8 + 2 * t4 + e;
            atomicAdd(&s_redc[c], si[nj][e]);
            atomicAdd(&s_redc[CC + c], ss[nj][e]);
          }
      }
    }
    if (t.vz) chain_gemm3<CC, CU>(lanes, acc3);
  }

  chain_dw_flush<CC, CU>(acc3, a.dwu, warp, lane);
  if (PS) return;   // the prologue gradients went into the partial rows
  __syncthreads();
  for (int c = tid; c < ct; c += NT) {
    atomicAdd(a.dinv + c, s_red[c]);
    atomicAdd(a.dshift + c, s_red[a.ctp + c]);
  }
  for (int c = tid; c < CC; c += NT) {
    atomicAdd(a.dinvc + c, s_redc[c]);
    atomicAdd(a.dshiftc + c, s_redc[CC + c]);
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

// One wave of blocks at the kernel's occupancy, at most one an item.
template <int CC, int CU, typename Args>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int smem = VdLayout<CC, CU>(a.tw, a.cdy, a.ctp).total;
  auto kern = conv_vup_dgrad_tc_kernel<CC, CU, Args>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                     smem);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int64_t blocks = (int64_t)per_sm * sm_count();
  if (blocks > a.items) blocks = a.items;
  if (blocks < 1) return cudaSuccess;   // no voxels
  kern<<<(unsigned)blocks, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int CC, typename Args>
cudaError_t launch_cu(const Args& a, cudaStream_t st) {
  if (a.cu == 32) return launch<CC, 32>(a, st);
  if (a.cu == 64) return launch<CC, 64>(a, st);
  return cudaErrorInvalidValue;
}

template <typename Args>
cudaError_t launch_cc(const Args& a, int cc, cudaStream_t st) {
  switch (cc) {
    case 32: return launch_cu<32>(a, st);
    case 64: return launch_cu<64>(a, st);
    case 96: return launch_cu<96>(a, st);
    case 128: return launch_cu<128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The tile width of K4's geometry at a level of width wd (K1's rule, as
// vup.vup_tile gives it): 16 or 32, the fewer wasted columns (32 on a
// tie).
int vd_tw(int wd) {
  return ((wd + 15) / 16) * 16 < ((wd + 31) / 32) * 32 ? 16 : 32;
}

}  // namespace

// The per-sample mode's partial rows a sample (ps_reduce.cuh): the
// tiles of its d planes, for dinv, dshift and for dinvc, dshiftc alike.
extern "C" int64_t e3_conv_vup_dgrad_tc_ps_parts(int d, int h, int wd) {
  const int tw = vd_tw(wd);
  const int th = C::M / tw;
  return (int64_t)d * ((h + th - 1) / th) * ((wd + tw - 1) / tw);
}

// Row 9's input gradients, bf16 body. ``dy`` (n, d, h, w, cdy) and the
// forward output ``y``; ``ds``, ``dq`` (cdy,) the statistics cotangents
// (zeros where there are none); ``wp`` pack_dgrad_weight's (1, cdy / 16,
// 9, ctp, 16) of the merge weight with its input columns padded with
// zeros to ctp, the next multiple of 64 of cu + cs; the carry's operands
// as e3_conv_vup_tc's; ``inv``/``shift`` (cu + cs,) the merge's
// prologue. Outputs: dcarry (the carry's shape), dskip (the skip's),
// dinvc, dshiftc (cc,), dwu (2, 2, cc, cu), dinv, dshift (cu + cs,), the
// float32 ones zeroed by the caller. ``tw``: the tile width (16 or 32,
// vup.vup_tile's at 256 voxels). Needs cdy % 16 == 0, cc in {32, 64, 96,
// 128}, cu in {32, 64}, cs % 32 == 0 and even h and wd. The per-sample
// mode (workspaces ``ws`` and ``wsc`` given): ds, dq (n, cdy), inv, shift
// (n, cu + cs) and invc, shiftc (n, cc) rows at the strides ``st_ns``,
// ``pro_ns`` and ``cc_ns``, which must be those row lengths; ``ws``
// (ps_workspace_floats of n samples, e3_conv_vup_dgrad_tc_ps_parts rows
// of 2 (cu + cs)) gives dinv, dshift per sample as (n, 2, cu + cs) in
// ``dinv``, ``wsc`` (the same parts, rows of 2 cc) dinvc, dshiftc as
// (n, 2, cc) in ``dinvc`` (``dshift``, ``dshiftc`` unused, neither
// zeroed); dwu stays global; ``tw`` must be the rule's (vd_tw).
extern "C" int e3_conv_vup_dgrad_tc(
    const void* dy, const void* y, const float* ds, const float* dq,
    int st_ns, int cdy, const void* wp, const void* carry, int cc,
    const float* invc, const float* shiftc, int cc_ns, const void* wup,
    const float* bu, int cu, int actc, const void* skip, int cs,
    const float* inv, const float* shift, int pro_ns, void* dcarry,
    float* dinvc, float* dshiftc, float* wsc, float* dwu, void* dskip,
    float* dinv, float* dshift, float* ws, int n, int d, int h, int wd,
    int act, int tw, void* stream) {
  const bool ps = ws != nullptr;
  if (cdy % 16 || cs % 32 || h % 2 || wd % 2 || (tw != 16 && tw != 32)
      || ds == nullptr || dq == nullptr || inv == nullptr
      || (ws != nullptr) != (wsc != nullptr)
      || (ps && (st_ns != cdy || pro_ns != cu + cs || cc_ns != cc
                 || tw != vd_tw(wd) || n > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  VdArgs a = {};
  a.g = static_cast<const __nv_bfloat16*>(dy);
  a.y = static_cast<const __nv_bfloat16*>(y);
  a.ds = ds;
  a.dq = dq;
  a.cdy = cdy;
  a.wp = static_cast<const __nv_bfloat16*>(wp);
  a.skip = static_cast<const __nv_bfloat16*>(skip);
  a.cu = cu;
  a.cs = cs;
  a.ctp = (cu + cs + COB - 1) / COB * COB;
  a.nz = a.ctp / COB;
  a.inv = inv;
  a.shift = shift;
  a.dskip = static_cast<__nv_bfloat16*>(dskip);
  a.dinv = dinv;
  a.dshift = dshift;
  a.carry = static_cast<const __nv_bfloat16*>(carry);
  a.invc = invc;
  a.shiftc = shiftc;
  a.wup = static_cast<const __nv_bfloat16*>(wup);
  a.bu = bu;
  a.dcarry = static_cast<__nv_bfloat16*>(dcarry);
  a.dinvc = dinvc;
  a.dshiftc = dshiftc;
  a.dwu = dwu;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.act = act;
  a.actc = actc;
  a.tw = tw;
  const int th = C::M / tw;
  a.items = (int64_t)n * d * ((h + th - 1) / th) * ((wd + tw - 1) / tw)
      * a.nz;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!ps) return static_cast<int>(launch_cc(a, cc, st));
  VdPsArgs p;
  static_cast<VdArgs&>(p) = a;
  p.st_ns = st_ns;
  p.pro_ns = pro_ns;
  p.cc_ns = cc_ns;
  p.part = ws;
  p.partc = wsc;
  cudaError_t rc = launch_cc(p, cc, st);
  if (rc == cudaSuccess) {
    const int64_t parts = e3_conv_vup_dgrad_tc_ps_parts(d, h, wd);
    rc = ps_reduce(ws, n, parts, 2 * (cu + cs), dinv, st);
    if (rc == cudaSuccess) rc = ps_reduce(wsc, n, parts, 2 * cc, dinvc, st);
  }
  return static_cast<int>(rc);
}
