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
// float32 and the network input (C_in = 1 or 3), and the WMMA body for
// the vup merge conv alone. K4's bf16 dgrad (dgrad_tc.cu) is this GEMM
// with dy_tot as A and its own epilogue; the two share conv_tc.cuh.
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
//
// mma.sync rather than wgmma, as in upconv_tc.cu: the A operand of a
// tap is a shifted window of the staged slab, which ldmatrix reads row
// by row at any offset, while wgmma's shared-memory descriptors would
// need a re-staged copy per tap (or A from registers through the same
// ldmatrix loads); that is left for a later step.
#include "conv_tc.cuh"

namespace {

using namespace e3;

struct ConvTcArgs {
  const __nv_bfloat16* x[2];
  const float* inv;          // (c0 + c1,) prologue, or null (identity)
  const float* shift;
  int cin[2];
  int nin;
  const __nv_bfloat16* wp;   // (kd, (c0 + c1) / 16, 9, cout, 16)
  const float* bias;         // (cout,) float32
  __nv_bfloat16* y;          // (n, d, h, w, cout)
  float* s;                  // (cout,) statistics, or null
  float* q;
  int n, d, h, wd, cout, kd, act, tw;
};

// Shared memory of a block: the ring, the slab's voxel offsets, the
// statistics' block sums and the prologue vectors of the ``ct`` concat
// channels.
template <int COB>
size_t conv_tc_smem(int tw, int ct) {
  const int npos = (Cfg<COB>::M / tw + 2) * (tw + 2);
  return (size_t)KST * (npos * APITCH + Cfg<COB>::BSTAGE) + (size_t)npos * 4
      + (size_t)2 * COB * 4 + (size_t)2 * ct * 4;
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
template <int COB>
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
  for (int p = threadIdx.x; p < g.npos * 2; p += NT) {
    const int off = s_off[p >> 1];
    cp_async16(smem_u32(da + (p >> 1) * APITCH + (p & 1) * 16),
               off >= 0 ? xp + (int64_t)off * ci + (p & 1) * 8 : x, off >= 0);
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

template <int COB, bool PRO, bool ST>
__global__ void __launch_bounds__(NT, 2) conv_tc_kernel(const ConvTcArgs a) {
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
      s_inv[c] = a.inv[c];
      s_shift[c] = a.shift[c];
    }
  __syncthreads();

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
      load_step<COB>(a, g, s_a, s_b, s_off, st);
    else
      cp_async_commit();
  }
  for (int st = 0; st < nsteps; ++st) {
    cp_async_wait<KST - 2>();  // step st has landed
    __syncthreads();           // for every thread; step st - 1's MMAs done
    if (st + KST - 1 < nsteps)
      load_step<COB>(a, g, s_a, s_b, s_off, st + KST - 1);
    else
      cp_async_commit();
    const int slot = st % KST;
    if (PRO) {
      int i, dz, kc, kg;
      decode(g, st, i, dz, kc, kg);
      unsigned char* sa = s_a + slot * g.abytes;
      for (int p = tid; p < g.npos * 2; p += NT) {
        const int c = kg * 16 + (p & 1) * 8;
        prologue_half(reinterpret_cast<uint4*>(sa + (p >> 1) * APITCH
                                               + (p & 1) * 16),
                      s_inv + c, s_shift + c, a.act, s_off[p >> 1] >= 0);
      }
      __syncthreads();
    }
    const uint32_t aslot = slot * g.abytes;
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

template <int COB, bool PRO, bool ST>
cudaError_t launch(const ConvTcArgs& a, cudaStream_t stream) {
  const size_t smem = conv_tc_smem<COB>(a.tw, a.cin[0] + a.cin[1]);
  const cudaError_t rc = cudaFuncSetAttribute(
      conv_tc_kernel<COB, PRO, ST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  const int th = Cfg<COB>::M / a.tw;
  const int64_t tiles = (int64_t)((a.h + th - 1) / th)
      * ((a.wd + a.tw - 1) / a.tw);
  const int64_t blocks = tiles * a.n * a.d;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, 1, a.cout / COB);
  conv_tc_kernel<COB, PRO, ST><<<grid, NT, smem, stream>>>(a);
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

}  // namespace

// K1, bf16 body. ``wp`` is the packed (kd, (c0 + c1) / 16, 9, cout, 16)
// bf16 weight; ``inv``/``shift`` ((c0 + c1,) over the concat) null means
// the identity prologue; ``s`` and ``q`` (zeroed by the caller) null
// means no statistics. Needs c0, c1 % 16 == 0 and cout % 32 == 0.
extern "C" int e3_conv_bnact_tc(int nin, const void* x0, int c0,
                                const void* x1, int c1, const float* inv,
                                const float* shift, const void* wp,
                                const float* bias, void* y, float* s,
                                float* q, int n, int d, int h, int wd,
                                int cout, int kd, int act, void* stream) {
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
  a.s = s;
  a.q = q;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cout = cout;
  a.kd = kd;
  a.act = act;
  // The tile width that wastes the fewest columns of a row (32 on a tie).
  a.tw = ((wd + 15) / 16) * 16 < ((wd + 31) / 32) * 32 ? 16 : 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (cout % 128 == 0)
    rc = launch_cob<128>(a, st);
  else if (cout % 64 == 0)
    rc = launch_cob<64>(a, st);
  else
    rc = launch_cob<32>(a, st);
  return static_cast<int>(rc);
}
