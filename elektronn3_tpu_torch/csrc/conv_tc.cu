// K1 conv_bnact, bfloat16 body: the prologue act(x * inv + shift), then
// the (kd, 3, 3) 'same' convolution over one or two NDHWC inputs (the
// decoder's concat merge, which never exists in memory), plus the
// float32 bias, with optional batch statistics of the stored output, as
// an implicit GEMM on the tensor cores. The function, its rounding
// points and its plain version are those of conv_bnact.cu: the
// prologued input is rounded to bf16 before the multiply, halo voxels
// are 0 AFTER the prologue, the sums are float32, the output is rounded
// once and the statistics are the sums of the rounded output. It runs
// whenever every input's channel count is a multiple of 16 (the
// wrapper's conv_body); conv_bnact.cuh keeps the CUDA-core body for
// float32 and the network input (C_in = 1 or 3). K4's bf16 dgrad
// (dgrad_tc.cu) is this GEMM with dy_tot as A and its own epilogue; the
// two share conv_tc.cuh.
//
// Replaces, for bf16, the TPU kernels listed in conv_bnact.cu.
//
// What bounds it on the card: at kd = 3 and C >= 64 arithmetic (about
// 1 to 2 KFLOP per byte it must move, far above the H100's ridge of 295
// FLOP per byte in bf16); at kd = 1 and C = 32 the bytes. The design:
//   - a block takes a TH x TW tile of output voxels of one (n, depth)
//     plane (TW = 16 or 32 by the width, TH x TW = 256, or 128 at
//     C_out >= 128) and COB = 32, 64 or 128 output channels (grid.z
//     splits a larger C_out), so the halo tile is fetched and prologued
//     once per (input, dz, 16-channel step) for all of them;
//   - the K loop runs over (input, dz, 16-channel step, tap): each step
//     fetches its raw halo slab ((TH + 2) x (TW + 2) voxels x 16
//     channels, zero-filled outside the volume) and its weights with
//     cp.async into the other buffer of a 2-stage ring while the MMAs
//     of the step before run; one pass then applies the prologue in
//     place, rounds to bf16 and writes 0 at the halo;
//   - the weights arrive packed by the wrapper, once per call, in bf16
//     as (kd, C / 16, 9, C_out, 16): one step's 9 taps are one
//     contiguous run;
//   - 8 warps, each a 64 x 32 (or, at COB = 32, 32 x 32) tile of
//     mma.sync m16n8k16 products; a tap reads its A fragments with
//     ldmatrix at the shifted voxels of the staged slab, whose 48-byte
//     voxel pitch (APITCH) makes a tap a constant offset of every row
//     address; the weights sit in tc.cuh's swizzled rows;
//   - the epilogue reads the accumulator registers directly: bias,
//     round, store (two channels a lane) and the statistics of the
//     rounded values (shuffles over the lanes that share a channel,
//     shared-memory atomics, then one device atomic per channel and
//     block).
// grid.x walks the tiles of every (n, depth) plane, the plane index
// outermost, so N * D is not bounded by grid.y's 65535.
// The per-sample mode (group and instance norm): a block, one (n, depth)
// plane, stages row n of the (N, c0 + c1) prologue (a sample stride),
// and its statistics are a partial row of sample n (ps_reduce.cuh): its
// warp rows add into the block's sums in turn, the block writes them
// into slot blockIdx.x of ``part`` (the d * tiles slots of a sample are
// its planes' tiles), and ps_reduce sums each sample's slots in order.
//
// mma.sync rather than wgmma, as in upconv_tc.cu: the A operand of a
// tap is a shifted window of the staged slab, which ldmatrix reads row
// by row at any offset, while wgmma's shared-memory descriptors would
// need a re-staged copy per tap (or A from registers through the same
// ldmatrix loads); that is left for a later step.
//
// The vup instantiation (Args = ConvTcVupArgs; e3_conv_vup_tc, the bf16
// body of conv_vup, row 1's vup mode) replaces, for bf16,
// ops/flat_fused.py::conv_bnact_flat_vup (_fused_conv_kernel's vup mode,
// _vup_scratch). Input 0 of the merge conv is VIRTUAL: the (1, 2, 2)
// upconv u of the deeper level's carry, never stored. A block's tile has
// an even origin and even TH and TW (TH x TW = 256 or 128, TW = 16 or
// 32), so its halo slab lies over (TH / 2 + 2) x (TW / 2 + 2) whole carry
// voxels. Before the K loop the block stages them (cp.async, 0 outside
// the volume), prologues and rounds them in place, and recomputes u on
// the tensor cores (vup_mma, upconv_vup.cuh: K3's stored bits) in chunks
// of 32 of u's channels, each against its columns of K3's packed weight;
// the epilogue rounds (vup_round), applies the merge conv's prologue,
// rounds to bf16, writes 0 outside the volume and stores the slab of
// every k16 step of u at APITCH: the slab K1 would have staged from a
// stored u. The carry tile and the weight chunk use the ring's memory,
// which the K loop has not started on (or memory of their own where the
// ring is smaller). The K loop is K1's over [u, skip], (input, dz, k16
// step, tap) in that order: u's steps take A from the staged slab and
// only their weights through the ring, the skip's steps come through the
// ring as before. So y is bitwise K1's output over K3's stored u.
// What bounds it: the merge conv's bytes and FLOPs as K1's, plus the
// recompute, 2 x cc x 4 cu FLOP a carry voxel of the halo (about 1.3 x
// the upconv's own work at TH x TW = 8 x 32), on the tensor cores.
// Its per-sample mode (group and instance norm; ConvTcVupPsArgs, an
// instantiation of its own) stages the merge's prologue row of the
// block's sample, as K1's does, and the carry's (cc_ns), and gives the
// statistics per sample as K1's per-sample mode does.
#include <type_traits>

#include "conv_tc.cuh"
#include "ps_reduce.cuh"
#include "upconv_vup.cuh"

namespace {

using namespace e3;

struct ConvTcArgs {
  const __nv_bfloat16* x[2];
  const float* inv;          // (c0 + c1,) prologue, or null (identity);
  const float* shift;        // per sample (n, c0 + c1)
  int cin[2];
  int nin;
  const __nv_bfloat16* wp;   // (kd, (c0 + c1) / 16, 9, cout, 16)
  const float* bias;         // (cout,) float32
  __nv_bfloat16* y;          // (n, d, h, w, cout)
  float* s;                  // (cout,) statistics, or null
  float* q;
  int n, d, h, wd, cout, kd, act, tw;
  // The per-sample mode: the sample stride of the prologue (c0 + c1 for
  // (n, c0 + c1) rows, 0 for (c0 + c1,)), and the statistics' partial
  // rows (n * d * tiles, 2 cout) in place of s and q, or null.
  int pro_ns;
  float* part;
};

// The vup merge conv's arguments (conv_vup): input 0 is the (1, 2, 2)
// upconv of the carry, recomputed per tile on the tensor cores; x[0] is
// unused, kd == 1, nin == 2 and the prologue is always applied. A type of
// its own, so that K1's other instantiations keep the argument layout,
// and the code, they compile to without it.
struct ConvTcVupArgs : ConvTcArgs {
  const __nv_bfloat16* carry;   // (n, d, h / 2, w / 2, cc) raw carry
  const float* invc;            // (cc,) its prologue, or per sample
  const float* shiftc;          // (n, cc) rows at the stride cc_ns
  const __nv_bfloat16* wup;     // (cc / 16, 4 cu, 16) packed upconv weight
  const float* bu;              // (cu,) float32 bias
  int cc, actc;
  int cc_ns;
};

// The vup instantiation's per-sample mode: the same arguments, a type of
// its own, so that the batch form's code stays as it was.
struct ConvTcVupPsArgs : ConvTcVupArgs {};

// The recompute of the vup instantiation: the carry voxels under a tile's
// halo slab, (th / 2 + 2) x (tw / 2 + 2) of them in m16 tiles, at an odd
// number of 16-byte units a row, and one chunk of K3's packed weight:
// the 4 x 32 columns of 32 of u's channels for every k16 step of cc.
struct VupGeo {
  int vr, vw, rows, mt, cxp;
  __host__ __device__ VupGeo(int th, int tw, int cc)
      : vr(th / 2 + 2), vw(tw / 2 + 2), rows(vr * vw), mt((rows + 15) / 16),
        cxp(cc * 2 + 16) {}
  __host__ __device__ int carry_bytes() const { return mt * 16 * cxp; }
  __host__ __device__ static int wchunk_bytes(int cc) {
    return cc / 16 * 128 * 32;
  }
};

// Shared memory of a block: the ring, the slab's voxel offsets, the
// statistics' block sums and the prologue vectors of the ``ct`` concat
// channels.
template <int COB>
__host__ __device__ size_t conv_tc_smem(int tw, int ct) {
  const int npos = (Cfg<COB>::M / tw + 2) * (tw + 2);
  return (size_t)KST * (npos * APITCH + Cfg<COB>::BSTAGE) + (size_t)npos * 4
      + (size_t)2 * COB * 4 + (size_t)2 * ct * 4;
}

// The vup instantiation's shared memory beyond K1's (``base`` bytes, of
// which ``ring`` the ring): the staged slab of u (cu / 16 k16 steps at
// APITCH), the carry's prologue and u's bias, and the recompute's scratch
// (the carry tile and the weight chunk) in the ring where it fits, else
// after the rest. Byte offsets from the start of shared memory.
struct VupLayout {
  int u_off, vec_off, scratch_off, total;
  __host__ __device__ VupLayout(int base, int ring, int npos, int th, int tw,
                                int cu, int cc) {
    const VupGeo v(th, tw, cc);
    const int scratch = v.carry_bytes() + VupGeo::wchunk_bytes(cc);
    u_off = (base + 15) / 16 * 16;
    vec_off = u_off + cu / 16 * npos * APITCH;
    const int end = vec_off + (2 * cc + cu) * 4;
    scratch_off = scratch <= ring ? 0 : (end + 15) / 16 * 16;
    total = scratch_off ? scratch_off + scratch : end;
  }
};

template <int COB>
VupLayout vup_layout(const ConvTcVupArgs& a) {
  const int th = Cfg<COB>::M / a.tw;
  const int npos = (th + 2) * (a.tw + 2);
  const int ring = KST * (npos * APITCH + Cfg<COB>::BSTAGE);
  return VupLayout((int)conv_tc_smem<COB>(a.tw, a.cin[0] + a.cin[1]), ring,
                   npos, th, a.tw, a.cin[0], a.cc);
}

// A block's place: its tile, its plane and its K steps.
struct Geo {
  int npos, abytes;           // slab voxels, bytes of a ring slot
  int d, co0;
  int64_t nn, nd;             // batch index, n * d + depth index
  int kct, kc0, dz_lo, s0;    // k16 steps: concat, input 0; first dz;
                              // steps of input 0
};

// Step st: input i, depth tap dz, and the k16 step kc of that input and
// kg of the concat.
__device__ __forceinline__ void decode(const Geo& g, int st, int& i,
                                       int& dz, int& kc, int& kg) {
  i = st >= g.s0;
  const int r = i ? st - g.s0 : st;
  const int kci = i ? g.kct - g.kc0 : g.kc0;
  dz = g.dz_lo + r / kci;
  kc = r % kci;
  kg = (i ? g.kc0 : 0) + kc;
}

// Issue step st's copies into ring slot st % KST: the raw halo slab
// (zero-filled where s_off marks a voxel outside the volume) and the
// step's 9 taps of weights.
template <int COB, bool VUP = false>
__device__ __forceinline__ void load_step(const ConvTcArgs& a, const Geo& g,
                                          unsigned char* s_a,
                                          unsigned char* s_b,
                                          const int* s_off, int st) {
  int i, dz, kc, kg;
  decode(g, st, i, dz, kc, kg);
  const int ci = a.cin[i];
  const __nv_bfloat16* x = a.x[i];
  const __nv_bfloat16* xp = x
      + ((g.nn * a.d + g.d + dz - a.kd / 2) * a.h * a.wd) * ci + kc * 16;
  unsigned char* da = s_a + (st % KST) * g.abytes;
  // (The vup instantiation's input 0 is staged by the recompute.)
  if (!VUP || i != 0)
    for (int p = threadIdx.x; p < g.npos * 2; p += NT) {
      const int off = s_off[p >> 1];
      cp_async16(smem_u32(da + (p >> 1) * APITCH + (p & 1) * 16),
                 off >= 0 ? xp + (int64_t)off * ci + (p & 1) * 8 : x,
                 off >= 0);
    }
  unsigned char* db = s_b + (st % KST) * Cfg<COB>::BSTAGE;
  const __nv_bfloat16* wsrc =
      a.wp + ((int64_t)(dz * g.kct + kg) * 9 * a.cout + g.co0) * 16;
  for (int p = threadIdx.x; p < 9 * COB * 2; p += NT) {
    const int row = p >> 1;         // tap * COB + output channel
    cp_async16(smem_u32(db + swz(row, p & 1)),
               wsrc + ((int64_t)(row / COB) * a.cout + row % COB) * 16
                   + (p & 1) * 8,
               true);
  }
  cp_async_commit();
}

// The vup instantiation's input 0 (see the top): u at the carry voxels
// under the tile's halo slab, prologued and rounded, into the staged
// slab of each k16 step of u (``s_u``: [cu / 16][npos][APITCH]), before
// the K loop. ``scratch`` holds the carry tile and the weight chunk;
// ``s_vec`` the carry's prologue (VPS: the row of the block's sample) and
// u's bias.
template <bool VPS>
__device__ __forceinline__ void vup_stage_u(const ConvTcVupArgs& a,
                                            const Geo& g, int th, int tw,
                                            int h0, int w0,
                                            unsigned char* scratch,
                                            unsigned char* s_u,
                                            const float* s_inv,
                                            const float* s_shift,
                                            float* s_vec) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gq = lane / 4;
  const int t4 = lane % 4;
  const VupGeo v(th, tw, a.cc);
  const int hw = tw + 2;
  const int cu = a.cin[0];
  const int h2 = a.h / 2, w2 = a.wd / 2;
  const int cr0 = h0 / 2 - 1, cw0 = w0 / 2 - 1;   // the tile's carry origin
  unsigned char* s_c = scratch;                     // [mt * 16][cxp]
  unsigned char* s_wc = scratch + v.carry_bytes();  // [cc / 16][128][32]
  float* s_invc = s_vec;
  float* s_shiftc = s_invc + a.cc;
  float* s_bu = s_shiftc + a.cc;
  const int64_t pc = VPS ? g.nn * a.cc_ns : 0;
  for (int c = tid; c < a.cc; c += NT) {
    s_invc[c] = a.invc[pc + c];
    s_shiftc[c] = a.shiftc[pc + c];
  }
  for (int c = tid; c < cu; c += NT) s_bu[c] = a.bu[c];
  for (int p = tid; p < v.mt * 16 * (a.cc / 8); p += NT) {
    const int r = p / (a.cc / 8);
    const int ch = p % (a.cc / 8);
    const int cr = cr0 + r / v.vw;
    const int cw = cw0 + r % v.vw;
    const bool ok = r < v.rows && cr >= 0 && cr < h2 && cw >= 0 && cw < w2;
    cp_async16(smem_u32(s_c + r * v.cxp + ch * 16),
               ok ? a.carry + ((g.nd * h2 + cr) * w2 + cw) * a.cc + ch * 8
                  : a.carry,
               ok);
  }
  const uint32_t c_lane = smem_u32(s_c) + (lane & 15) * v.cxp
      + (lane >> 4) * 16;
  const uint32_t w_lane = smem_u32(s_wc)
      + swz((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  for (int j = 0; j < cu / 32; ++j) {
    // Chunk j's weight: row kc * 128 + sub * 32 + jj is packed column
    // sub * cu + 32 j + jj of k16 step kc.
    for (int p = tid; p < a.cc / 16 * 128 * 2; p += NT) {
      const int row = p >> 1;
      const int col = (row / 32 % 4) * cu + 32 * j + row % 32;
      cp_async16(smem_u32(s_wc + swz(row, p & 1)),
                 a.wup + ((int64_t)(row / 128) * 4 * cu + col) * 16
                     + (p & 1) * 8,
                 true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (j == 0) {   // the carry's prologue, in place: rounded a
      for (int p = tid; p < v.mt * 16 * (a.cc / 8); p += NT) {
        const int ch = p % (a.cc / 8);
        prologue_half(reinterpret_cast<uint4*>(s_c + (p / (a.cc / 8)) * v.cxp
                                               + ch * 16),
                      s_invc + ch * 8, s_shiftc + ch * 8, a.actc, true);
      }
      __syncthreads();
    }
    // Units of 16 carry voxels x one sub-position's 32 channels.
    for (int u = warp; u < v.mt * 4; u += NT / 32) {
      const int mi = u % v.mt;
      const int sub = u / v.mt;
      const int col[2] = {sub * 32, sub * 32 + 16};
      float uacc[1][4][4];
      vup_mma<1, 2>(c_lane + mi * 16 * v.cxp, v.cxp, w_lane, col, 128,
                    a.cc / 16, uacc);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = mi * 16 + gq + 8 * hr;
        if (r >= v.rows) continue;
        const int hh = 2 * (cr0 + r / v.vw) + (sub >> 1);
        const int ww = 2 * (cw0 + r % v.vw) + (sub & 1);
        const int sy = hh - h0 + 1;
        const int sx = ww - w0 + 1;
        if (sy < 0 || sy >= th + 2 || sx < 0 || sx >= hw) continue;
        const bool ok = hh >= 0 && hh < a.h && ww >= 0 && ww < a.wd;
        unsigned char* dst = s_u + (sy * hw + sx) * APITCH;
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int co = 32 * j + nj * 8 + 2 * t4;
          const float u0 = vup_round(uacc[0][nj][2 * hr], s_bu[co]);
          const float u1 = vup_round(uacc[0][nj][2 * hr + 1], s_bu[co + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dst + (co / 16) * g.abytes
                                             + (co % 16) * 2) = ok
              ? __floats2bfloat162_rn(
                    prologue(u0, s_inv[co], s_shift[co], a.act),
                    prologue(u1, s_inv[co + 1], s_shift[co + 1], a.act))
              : __floats2bfloat162_rn(0.0f, 0.0f);
        }
      }
    }
    __syncthreads();   // the chunk's weight is read; s_u is written
  }
}

template <int COB, bool PRO, bool ST, typename Args = ConvTcArgs>
__global__ void __launch_bounds__(NT, 2) conv_tc_kernel(const Args a) {
  constexpr bool VUP = std::is_base_of<ConvTcVupArgs, Args>::value;
  constexpr bool VPS = std::is_same<Args, ConvTcVupPsArgs>::value;
  using C = Cfg<COB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tw = a.tw;
  const int th = C::M / tw;
  const int hw = tw + 2;                      // slab width
  Geo g;
  g.npos = (th + 2) * hw;
  g.abytes = g.npos * APITCH;
  unsigned char* s_a = smem;                  // KST x [npos][APITCH]
  unsigned char* s_b = s_a + KST * g.abytes;  // KST x [9][COB], swizzled
  int* s_off = reinterpret_cast<int*>(s_b + KST * C::BSTAGE);   // [npos]
  float* s_red = reinterpret_cast<float*>(s_off + g.npos);      // [2][COB]
  float* s_inv = s_red + 2 * COB;             // [ct] prologue scale
  float* s_shift = s_inv + a.cin[0] + a.cin[1];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / C::WARPS_N;
  const int wn = warp % C::WARPS_N;
  const int tiles_w = (a.wd + tw - 1) / tw;
  const int tiles = ((a.h + th - 1) / th) * tiles_w;
  const int tile = (int)(blockIdx.x % tiles);
  g.nd = blockIdx.x / tiles;
  const int h0 = (tile / tiles_w) * th;
  const int w0 = (tile % tiles_w) * tw;
  g.nn = g.nd / a.d;
  g.d = (int)(g.nd % a.d);
  g.co0 = blockIdx.z * COB;
  g.kct = (a.cin[0] + a.cin[1]) / 16;
  g.kc0 = a.cin[0] / 16;
  g.dz_lo = max(0, a.kd / 2 - g.d);
  const int nvd = min(a.kd, a.d - g.d + a.kd / 2) - g.dz_lo;
  g.s0 = nvd * g.kc0;
  const int nsteps = g.s0 + nvd * (g.kct - g.kc0);
  // Each slab voxel's index in its plane, or -1 outside the volume.
  for (int pos = tid; pos < g.npos; pos += NT) {
    const int gh = h0 + pos / hw - 1;
    const int gw = w0 + pos % hw - 1;
    s_off[pos] = gh >= 0 && gh < a.h && gw >= 0 && gw < a.wd
        ? gh * a.wd + gw : -1;
  }
  if (ST)
    for (int c = tid; c < 2 * COB; c += NT) s_red[c] = 0.0f;
  if (PRO)
    for (int c = tid; c < g.kct * 16; c += NT) {
      s_inv[c] = a.inv[g.nn * a.pro_ns + c];
      s_shift[c] = a.shift[g.nn * a.pro_ns + c];
    }
  __syncthreads();
  uint32_t uoff = 0;   // the vup instantiation: s_u's offset from s_a
  if constexpr (VUP) {
    const VupLayout l((int)conv_tc_smem<COB>(tw, a.cin[0] + a.cin[1]),
                      KST * (g.abytes + C::BSTAGE), g.npos, th, tw,
                      a.cin[0], a.cc);
    uoff = l.u_off;
    vup_stage_u<VPS>(a, g, th, tw, h0, w0, smem + l.scratch_off,
                     smem + l.u_off, s_inv, s_shift,
                     reinterpret_cast<float*>(smem + l.vec_off));
  }

  // Each lane's ldmatrix row of m16 tile mi at tap (0, 0), and of its B
  // fragments at tap 0 (a tap adds a constant to either).
  uint32_t arow[C::MI];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi) {
    const int m = wm * C::WM + mi * 16 + (lane & 15);
    arow[mi] = smem_u32(s_a) + ((m / tw) * hw + m % tw) * APITCH
        + (lane >> 4) * 16;
  }
  const uint32_t brow = smem_u32(s_b)
      + swz(wn * 32 + (lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);

  float acc[C::MI][4][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < KST - 1; ++st) {
    if (st < nsteps)
      load_step<COB, VUP>(a, g, s_a, s_b, s_off, st);
    else
      cp_async_commit();
  }
  for (int st = 0; st < nsteps; ++st) {
    cp_async_wait<KST - 2>();  // step st has landed
    __syncthreads();           // for every thread; step st - 1's MMAs done
    if (st + KST - 1 < nsteps)
      load_step<COB, VUP>(a, g, s_a, s_b, s_off, st + KST - 1);
    else
      cp_async_commit();
    const int slot = st % KST;
    uint32_t aslot = slot * g.abytes;
    if (PRO) {
      int i, dz, kc, kg;
      decode(g, st, i, dz, kc, kg);
      if (VUP && i == 0) {
        aslot = uoff + kc * g.abytes;   // u's staged slab of step kc
      } else {
        unsigned char* sa = s_a + slot * g.abytes;
        for (int p = tid; p < g.npos * 2; p += NT) {
          const int c = kg * 16 + (p & 1) * 8;
          prologue_half(reinterpret_cast<uint4*>(sa + (p >> 1) * APITCH
                                                 + (p & 1) * 16),
                        s_inv + c, s_shift + c, a.act, s_off[p >> 1] >= 0);
        }
        __syncthreads();
      }
    }
    const uint32_t bslot = brow + slot * C::BSTAGE;
    tap_mma9<COB>(acc, arow, aslot, bslot, hw);
  }

  // Epilogue from the accumulators: lane (g, t4) holds rows g and g + 8
  // of each m16 tile, channels 2 t4 and 2 t4 + 1 of each n8 tile.
  const int gr = lane / 4;
  const int t4 = lane % 4;
  float sm[4][2], sq[4][2];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int co = g.co0 + wn * 32 + nj * 8 + 2 * t4;
    const float b0 = a.bias[co];
    const float b1 = a.bias[co + 1];
    sm[nj][0] = sm[nj][1] = sq[nj][0] = sq[nj][1] = 0.0f;
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = wm * C::WM + mi * 16 + gr + 8 * hr;
        const int hh = h0 + m / tw;
        const int ww = w0 + m % tw;
        if (hh >= a.h || ww >= a.wd) continue;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            acc[mi][nj][2 * hr] + b0, acc[mi][nj][2 * hr + 1] + b1);
        *reinterpret_cast<__nv_bfloat162*>(
            a.y + ((g.nd * a.h + hh) * a.wd + ww) * a.cout + co) = v;
        if (ST) {
          const float r0 = __low2float(v);
          const float r1 = __high2float(v);
          sm[nj][0] += r0;
          sm[nj][1] += r1;
          sq[nj][0] = fmaf(r0, r0, sq[nj][0]);
          sq[nj][1] = fmaf(r1, r1, sq[nj][1]);
        }
      }
  }
  if (!ST) return;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        sm[nj][e] += __shfl_xor_sync(0xffffffffu, sm[nj][e], off);
        sq[nj][e] += __shfl_xor_sync(0xffffffffu, sq[nj][e], off);
      }
  __syncthreads();  // s_red's initialization is visible
  if (a.part != nullptr) {
    // The per-sample mode: the warp rows in turn (the warps of a row
    // hold distinct channels), then the block's partial row.
    for (int w = 0; w < C::WARPS_M; ++w) {
      if (wm == w && gr == 0) {
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = wn * 32 + nj * 8 + 2 * t4 + e;
            s_red[c] += sm[nj][e];
            s_red[COB + c] += sq[nj][e];
          }
      }
      __syncthreads();
    }
    float* const row = a.part + (int64_t)blockIdx.x * 2 * a.cout + g.co0;
    for (int c = tid; c < COB; c += NT) {
      row[c] = s_red[c];
      row[a.cout + c] = s_red[COB + c];
    }
    return;
  }
  if (gr == 0) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wn * 32 + nj * 8 + 2 * t4 + e;
        atomicAdd(&s_red[c], sm[nj][e]);
        atomicAdd(&s_red[COB + c], sq[nj][e]);
      }
  }
  __syncthreads();
  for (int c = tid; c < COB; c += NT) {
    atomicAdd(a.s + g.co0 + c, s_red[c]);
    atomicAdd(a.q + g.co0 + c, s_red[COB + c]);
  }
}

template <int COB, bool PRO, bool ST, typename Args = ConvTcArgs>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  size_t smem = conv_tc_smem<COB>(a.tw, a.cin[0] + a.cin[1]);
  if constexpr (std::is_base_of<ConvTcVupArgs, Args>::value)
    smem = vup_layout<COB>(a).total;
  const cudaError_t rc = cudaFuncSetAttribute(
      conv_tc_kernel<COB, PRO, ST, Args>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  const int th = Cfg<COB>::M / a.tw;
  const int64_t tiles = (int64_t)((a.h + th - 1) / th)
      * ((a.wd + a.tw - 1) / a.tw);
  const int64_t blocks = tiles * a.n * a.d;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, 1, a.cout / COB);
  conv_tc_kernel<COB, PRO, ST, Args><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int COB>
cudaError_t launch_cob(const ConvTcArgs& a, cudaStream_t st) {
  if (a.inv != nullptr)
    return a.s != nullptr ? launch<COB, true, true>(a, st)
                          : launch<COB, true, false>(a, st);
  return a.s != nullptr ? launch<COB, false, true>(a, st)
                        : launch<COB, false, false>(a, st);
}

template <int COB>
cudaError_t launch_vup(const ConvTcVupArgs& a, cudaStream_t st) {
  if (Cfg<COB>::M % (2 * a.tw) || (Cfg<COB>::M / a.tw) % 2)
    return cudaErrorInvalidValue;   // the tile's origin must be even
  if (a.pro_ns != 0 || a.cc_ns != 0 || a.part != nullptr) {
    ConvTcVupPsArgs p;
    static_cast<ConvTcVupArgs&>(p) = a;
    return a.s != nullptr ? launch<COB, true, true, ConvTcVupPsArgs>(p, st)
                          : launch<COB, true, false, ConvTcVupPsArgs>(p, st);
  }
  return a.s != nullptr ? launch<COB, true, true, ConvTcVupArgs>(a, st)
                        : launch<COB, true, false, ConvTcVupArgs>(a, st);
}

// The tile width that wastes the fewest columns of a row (32 on a tie).
int conv_tc_tw(int wd) {
  return ((wd + 15) / 16) * 16 < ((wd + 31) / 32) * 32 ? 16 : 32;
}

// The rows of a block's tile: its output voxels (Cfg<COB>::M, COB by
// cout as the entry picks it) over the tile width.
int conv_tc_th(int wd, int cout) {
  const int m = cout % 128 == 0 ? Cfg<128>::M
      : cout % 64 == 0 ? Cfg<64>::M : Cfg<32>::M;
  return m / conv_tc_tw(wd);
}

}  // namespace

// The per-sample mode's partial rows a sample (ps_reduce.cuh): the
// blocks of its d planes, (h / th) x (wd / tw) tiles each, rounded up.
extern "C" int64_t e3_conv_bnact_tc_ps_parts(int d, int h, int wd,
                                              int cout) {
  const int th = conv_tc_th(wd, cout);
  const int tw = conv_tc_tw(wd);
  return (int64_t)d * ((h + th - 1) / th) * ((wd + tw - 1) / tw);
}

// K1, bf16 body. ``wp`` is the packed (kd, (c0 + c1) / 16, 9, cout, 16)
// bf16 weight; ``inv``/``shift`` ((c0 + c1,) over the concat) null means
// the identity prologue; ``s`` and ``q`` (zeroed by the caller) null
// means no statistics. The per-sample mode (group and instance norm):
// ``pro_ns`` is c0 + c1 for ``inv``/``shift`` of (n, c0 + c1) (0 for the
// batch form); a workspace ``ws`` (ps_workspace_floats of n samples,
// e3_conv_bnact_tc_ps_parts rows of 2 cout) gives the statistics of each
// sample in ``s`` as (n, 2, cout), the sums then the sums of squares,
// summed in a fixed order (``q`` unused); null, the batch form. Needs
// c0, c1 % 16 == 0 and cout % 32 == 0.
extern "C" int e3_conv_bnact_tc(int nin, const void* x0, int c0,
                                const void* x1, int c1, const float* inv,
                                const float* shift, int pro_ns,
                                const void* wp, const float* bias, void* y,
                                float* s, float* q, float* ws, int n, int d,
                                int h, int wd, int cout, int kd, int act,
                                void* stream) {
  if (c0 % 16 || (nin > 1 && c1 % 16) || cout % 32 || (kd != 1 && kd != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvTcArgs a = {};
  a.x[0] = static_cast<const __nv_bfloat16*>(x0);
  a.x[1] = static_cast<const __nv_bfloat16*>(x1);
  a.inv = inv;
  a.shift = shift;
  a.cin[0] = c0;
  a.cin[1] = nin > 1 ? c1 : 0;
  a.nin = nin;
  a.wp = static_cast<const __nv_bfloat16*>(wp);
  a.bias = bias;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.s = ws != nullptr ? ws : s;   // the statistics' instantiation
  a.q = q;
  a.pro_ns = pro_ns;
  a.part = ws;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cout = cout;
  a.kd = kd;
  a.act = act;
  a.tw = conv_tc_tw(wd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (cout % 128 == 0)
    rc = launch_cob<128>(a, st);
  else if (cout % 64 == 0)
    rc = launch_cob<64>(a, st);
  else
    rc = launch_cob<32>(a, st);
  if (rc == cudaSuccess && ws != nullptr)
    rc = ps_reduce(ws, n, e3_conv_bnact_tc_ps_parts(d, h, wd, cout),
                   2 * cout, s, st);
  return static_cast<int>(rc);
}

// K1 of the vup merge conv, bf16 body (conv_vup): input 0 is the (1, 2, 2)
// upconv of the carry (cu channels, recomputed per tile on the tensor
// cores from the raw carry, its prologue invc/shiftc/actc, K3's packed
// (cc / 16, 4 cu, 16) bf16 weight ``wup`` and the float32 bias ``bu``),
// input 1 the skip (cs channels); kd = 1. ``wp`` is pack_conv_weight's
// (1, (cu + cs) / 16, 9, cout, 16); ``inv`` and ``shift`` ((cu + cs,),
// over the concat) must be given; ``s`` and ``q`` as e3_conv_bnact_tc's.
// ``tw`` is the tile width (16 or 32: vup.vup_tile's). Needs cc % 32 ==
// 0 and cc <= 128, cu in {32, 64}, cs % 16 == 0, cout % 32 == 0 and even
// h and wd; (n, d, h, wd) are the skip's dims. The per-sample mode:
// ``pro_ns`` (cu + cs) and ``cc_ns`` (cc) for the (n, .) rows of the
// merge's prologue and the carry's, and a workspace ``ws``
// (ps_workspace_floats of n samples, e3_conv_bnact_tc_ps_parts rows of
// 2 cout) for the statistics per sample as (n, 2, cout) in ``s``, as
// e3_conv_bnact_tc's.
extern "C" int e3_conv_vup_tc(const void* carry, int cc, const float* invc,
                              const float* shiftc, int cc_ns,
                              const void* wup, const float* bu, int cu,
                              int actc, const void* skip, int cs,
                              const float* inv, const float* shift,
                              int pro_ns, const void* wp, const float* bias,
                              void* y, float* s, float* q, float* ws, int n,
                              int d, int h, int wd, int cout, int act,
                              int tw, void* stream) {
  if (cc % 32 || cc > 128 || (cu != 32 && cu != 64) || cs % 16 || cout % 32
      || h % 2 || wd % 2 || inv == nullptr || (tw != 16 && tw != 32)
      || (ws != nullptr && tw != conv_tc_tw(wd)))   // the partial rows' tiles
    return static_cast<int>(cudaErrorInvalidValue);
  ConvTcVupArgs a = {};
  a.x[1] = static_cast<const __nv_bfloat16*>(skip);
  a.inv = inv;
  a.shift = shift;
  a.cin[0] = cu;
  a.cin[1] = cs;
  a.nin = 2;
  a.wp = static_cast<const __nv_bfloat16*>(wp);
  a.bias = bias;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.s = ws != nullptr ? ws : s;   // the statistics' instantiation
  a.q = q;
  a.pro_ns = pro_ns;
  a.part = ws;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cout = cout;
  a.kd = 1;
  a.act = act;
  a.tw = tw;
  a.cc_ns = cc_ns;
  a.carry = static_cast<const __nv_bfloat16*>(carry);
  a.invc = invc;
  a.shiftc = shiftc;
  a.wup = static_cast<const __nv_bfloat16*>(wup);
  a.bu = bu;
  a.cc = cc;
  a.actc = actc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (cout % 128 == 0)
    rc = launch_vup<128>(a, st);
  else if (cout % 64 == 0)
    rc = launch_vup<64>(a, st);
  else
    rc = launch_vup<32>(a, st);
  if (rc == cudaSuccess && ws != nullptr)
    rc = ps_reduce(ws, n, e3_conv_bnact_tc_ps_parts(d, h, wd, cout),
                   2 * cout, s, st);
  return static_cast<int>(rc);
}
