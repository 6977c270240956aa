// Row 13: the merged backward of K1 over a network input of 1 to 4
// channels (conv1 of the first level), in one streaming pass:
//     dW[tap, ci, co] = sum over voxels v of a[v + tap, ci] * g[v, co]
//     db[co]          = sum over voxels of the float32 dy_tot[v, co]
// and, on request,
//     dx[u, ci] = round(gm * inv[ci]),  gm = act'(x * inv + shift)
//                   * sum over (tap, co) of g[u - tap, co] W[tap, ci, co]
//     dinv[ci] = sum gm * x,  dshift[ci] = sum gm,
// where dy_tot = dy + ds + 2 y dq (float32), g = dy_tot rounded to the
// activation dtype, a = act(x * inv + shift) rounded to that dtype (0 at
// the halo, after the prologue) and W the weight rounded to it: the
// rounding points of conv_bnact_wgrad_plain and conv_bnact_dgrad_plain
// (ops/fused.py), composed by conv1_bwd_plain.
//
// Replaces ops/flat_fused.py::_conv1_bwd (_conv1_bwd_kernel, and its
// input_grad=True dx) of the JAX package, and the C_in = 1 (or 3) K5 of
// the C=64 executor's first conv (flat_fused64.py::_conv64_bwd with
// cin_real = 1, whose dgrad runs over the padded channels).
//
// What bounds it on the card: the bytes of dy and y (each read once:
// 354 MB at bench.py's step, 0.106 ms), not arithmetic (9 x C_in FMAs
// per output value for dW, as many for dx). It is a reduction, not a
// GEMM: at C_in = 1 the weight gradient has 9 x C_out entries, so a
// tiled implicit GEMM would split K across thousands of blocks that all
// add into the same few hundred sums. The design:
//   - persistent blocks of 256 threads walk tiles of 256 voxels (TH x TW
//     of one (n, depth) plane, TW of 8, 16 or 32 by the width); a thread
//     owns CPT consecutive output channels (8 at C_in = 1: 16 bytes of
//     dy and of y) of one voxel a pass, so a warp reads 512 contiguous
//     bytes of each;
//   - each thread copies its own dy and y of the next C1_ST - 1 passes
//     (a tile ahead, across tile boundaries) into its slots of a ring in
//     shared memory with cp.async, and reads them back itself, so the
//     loads stay in flight through the math and the tile changes and no
//     barrier guards the ring;
//   - the tile's input window (TH + 2) x (TW + 2) x C_in, for the kd
//     depth taps, is staged prologued and rounded in shared memory, its
//     raw values fetched into registers a tile ahead;
//   - each thread keeps its 9 kd C_in x CPT weight-gradient sums (at
//     most 108, 72 on every model path) and its CPT db sums in registers
//     over all its tiles; at the end, shuffles over the lanes that hold
//     the same channels, shared-memory atomics, and one device atomic
//     per weight and block;
//   - dx (the DX instantiations) gathers over the one-voxel ring around
//     the tile (and the depth neighbours at kd = 3): each g voxel's
//     products with the weight (staged in shared memory) are summed over
//     the lanes of its voxel by shuffles and added into the tile's dx
//     sums in shared memory; dy and y of the ring are read again (about
//     a third more at TH x TW = 8 x 32), so dx costs 1.3 reads of them,
//     not a second pass.
// The order of the atomics changes from run to run, hence the last bits
// of the sums (as in K4 and K5).
#include <type_traits>

#include "tc.cuh"

namespace {

using namespace e3;

constexpr int C1_NT = 256;     // threads per block
constexpr int C1_TV = 256;     // voxels per tile: TH x TW
constexpr int C1_ACC = 72;     // weight-gradient sums a thread may keep
constexpr int C1_NPOS = 340;   // the most window voxels, (TH + 2)(TW + 2)

// Output channels per thread: the most (8 down to 1) whose 9 kd C_in
// sums fit C1_ACC, or 1.
template <int CIN, int KD>
struct C1Cpt {
  static constexpr int value = 9 * KD * CIN * 8 <= C1_ACC ? 8
      : 9 * KD * CIN * 4 <= C1_ACC ? 4
      : 9 * KD * CIN * 2 <= C1_ACC ? 2 : 1;
};

struct C1Args {
  const void* x;         // (n, d, h, w, cin) network input
  const float* inv;      // (cin,) forward prologue vectors
  const float* shift;
  const void* dy;        // (n, d, h, w, cout)
  const void* y;         // the forward output, read with ds
  const float* ds;       // (cout,) statistics cotangents, or null
  const float* dq;
  const float* wt;       // (kd, 3, 3, cin, cout) rounded weight (DX)
  float* dw;             // (kd, 3, 3, cin, cout), zeroed
  float* db;             // (cout,), zeroed
  void* dx;              // (n, d, h, w, cin) (DX)
  float* dinv;           // (cin,), zeroed (DX)
  float* dshift;
  int n, d, h, wd, cout, act, tw, th;
  int64_t ntiles;
};

// CPT consecutive values of T as float32 (the address is aligned to
// CPT elements: cout and the channel offset are multiples of CPT).
template <typename T, int CPT>
__device__ __forceinline__ void load_cpt(const T* p, float* v) {
  if constexpr (CPT == 8) {
    load8(p, v);
  } else if constexpr (std::is_same<T, float>::value && CPT == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else if constexpr (std::is_same<T, float>::value && CPT == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x; v[1] = u.y;
  } else if constexpr (CPT == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else if constexpr (CPT == 2) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = to_f(p[0]);
  }
}

constexpr int C1_ST = 4;       // passes in flight: the cp.async ring

// Shared memory: the ring [C1_ST][dy, y][C1_NT][eb bytes] (eb: a
// thread's CPT values), then ds and dq [2][cout], the input window
// [KD][npos][CIN], the weight [KD * 9][CIN][cout] and the tile's dx sums
// [C1_TV][CIN] (DX); the block's final sums [KD * 9 * CIN * cout + cout +
// 2 CIN] reuse the space after the ring.
size_t c1_smem(int cin, int kd, int cout, int npos, bool dx, int eb) {
  const size_t stage = (size_t)2 * cout + (size_t)kd * npos * cin
      + (dx ? (size_t)kd * 9 * cin * cout + (size_t)C1_TV * cin : 0);
  const size_t red = (size_t)kd * 9 * cin * cout + cout + 2 * cin;
  return (size_t)C1_ST * 2 * C1_NT * eb + 4 * (stage > red ? stage : red);
}

// Copy EB bytes (a thread's CPT values) from device to shared memory:
// cp.async in 16-, 8- or 4-byte pieces, or a plain 2-byte copy.
template <int EB>
__device__ __forceinline__ void copy_cpt(unsigned char* dst,
                                         const void* src) {
  if constexpr (EB % 16 == 0) {
#pragma unroll
    for (int i = 0; i < EB / 16; ++i)
      cp_async16(smem_u32(dst + 16 * i),
                 static_cast<const unsigned char*>(src) + 16 * i, true);
  } else if constexpr (EB == 8 || EB == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(EB) : "memory");
  } else {
    *reinterpret_cast<uint16_t*>(dst) =
        *static_cast<const uint16_t*>(src);
  }
}

template <typename T, int CIN, int KD, bool DX>
__global__ void __launch_bounds__(C1_NT, 2) conv1_bwd_kernel(
    const C1Args a) {
  constexpr int CPT = C1Cpt<CIN, KD>::value;
  constexpr int TAPS = 9 * KD;
  constexpr int EB = CPT * (int)sizeof(T);   // a thread's bytes a pass
  extern __shared__ __align__(16) unsigned char c1_smem_raw[];
  unsigned char* s_ring = c1_smem_raw;       // [C1_ST][2][C1_NT][EB]
  float* smem = reinterpret_cast<float*>(s_ring + C1_ST * 2 * C1_NT * EB);
  const int tw = a.tw;
  const int th = a.th;
  const int sw = tw + 2;                     // window width
  const int npos = (th + 2) * sw;
  float* s_ds = smem;                        // [cout]
  float* s_dq = s_ds + a.cout;               // [cout]
  float* s_a = s_dq + a.cout;                // [KD][npos][CIN]
  float* s_w = s_a + KD * npos * CIN;        // DX: [TAPS][CIN][cout]
  float* s_dx = s_w + (DX ? TAPS * CIN * a.cout : 0);   // DX: [C1_TV][CIN]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  // Threads of a voxel: cout / CPT rounded up to a power of two, so that
  // a voxel's lanes are an aligned group that xor shuffles reduce and
  // vpp * tpv == C1_NT; the threads past cout / CPT hold no channels
  // (live false: they load nothing and add zeros).
  int tpv = 1;
  while (tpv * CPT < a.cout) tpv *= 2;
  const int vpp = C1_NT / tpv;               // voxels a pass
  const int grp = tpv < 32 ? tpv : 32;       // lanes of a voxel in a warp
  const int co = (tid % tpv) * CPT;          // this thread's channels
  const bool live = co < a.cout;
  const int cw = live ? co : 0;              // its weight columns (DX)
  const int slot = tid / tpv;
  const T* xp = static_cast<const T*>(a.x);
  const T* dyp = static_cast<const T*>(a.dy);
  const T* yp = static_cast<const T*>(a.y);
  const bool fold = a.ds != nullptr;
  if (fold)
    for (int i = tid; i < a.cout; i += C1_NT) {
      s_ds[i] = a.ds[i];
      s_dq[i] = a.dq[i];
    }
  float pinv[CIN], pshift[CIN];
#pragma unroll
  for (int ci = 0; ci < CIN; ++ci) {
    pinv[ci] = a.inv[ci];
    pshift[ci] = a.shift[ci];
  }
  if (DX) {
    for (int i = tid; i < TAPS * CIN * a.cout; i += C1_NT) s_w[i] = a.wt[i];
    for (int i = tid; i < C1_TV * CIN; i += C1_NT) s_dx[i] = 0.0f;
  }

  float acc[TAPS][CIN][CPT];
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[t][ci][j] = 0.0f;
  float dbl[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) dbl[j] = 0.0f;
  float dinvl[CIN], dshiftl[CIN];
#pragma unroll
  for (int ci = 0; ci < CIN; ++ci) dinvl[ci] = dshiftl[ci] = 0.0f;

  // The g voxels of a tile: its TH x TW voxels of the plane; with DX the
  // ring around them too and, at KD = 3, the neighbouring planes.
  const int gh = DX ? th + 2 : th;
  const int gwid = DX ? sw : tw;
  const int planes = DX ? KD : 1;
  const int nvox = planes * gh * gwid;
  const int passes = (nvox + vpp - 1) / vpp;
  const int tiles_w = (a.wd + tw - 1) / tw;
  const int tiles_h = (a.h + th - 1) / th;

  // A tile's place: its (n, depth) plane, its first row and column and
  // the index of its first voxel.
  struct Tile {
    int64_t nd, base;
    int zd, h0, w0;
  };
  auto tile_at = [&](int64_t t) {
    Tile g;
    g.w0 = (int)(t % tiles_w) * tw;
    const int64_t r0 = t / tiles_w;
    g.h0 = (int)(r0 % tiles_h) * th;
    g.nd = r0 / tiles_h;
    g.zd = (int)(g.nd % a.d);
    g.base = (g.nd * a.h + g.h0) * a.wd + g.w0;
    return g;
  };
  const int lg_tw = __ffs(tw) - 1;           // tw is 8, 16 or 32
  // Voxel k * vpp + slot of tile g's g voxels: its plane offset e, its
  // row and column relative to the tile, whether it is in the volume and
  // whether it is one of the tile's own voxels.
  auto locate = [&](const Tile& g, int k, int& e, int& rr, int& cc,
                    int64_t& vox, bool& ok, bool& inner) {
    const int vi = k * vpp + slot;
    if constexpr (!DX) {   // the tile's own voxels: passes * vpp = C1_TV
      e = 0;
      rr = vi >> lg_tw;
      cc = vi & (tw - 1);
      ok = inner = g.h0 + rr < a.h && g.w0 + cc < a.wd;
      vox = g.base + rr * a.wd + cc;
      return;
    }
    e = vi / (gh * gwid) - KD / 2;
    const int rem = vi % (gh * gwid);
    rr = rem / gwid - 1;
    cc = rem % gwid - 1;
    const int gz = g.zd + e;
    const int hh = g.h0 + rr;
    const int ww = g.w0 + cc;
    ok = vi < nvox && gz >= 0 && gz < a.d && hh >= 0 && hh < a.h
        && ww >= 0 && ww < a.wd;
    inner = ok && e == 0 && rr >= 0 && rr < th && cc >= 0 && cc < tw;
    vox = ((g.nd + e) * a.h + hh) * a.wd + ww;
  };
  // The block's tiles are blockIdx.x + i gridDim.x; step j is pass
  // j % passes of its tile j / passes. fetch_step(j) copies step j's dy
  // (and y) into ring slot j % C1_ST, walking the steps in order.
  const int64_t ntl = (a.ntiles - 1 - blockIdx.x) / gridDim.x + 1;
  const int64_t nsteps = ntl * passes;
  int64_t it = 0;
  int ik = 0;
  Tile ig = tile_at(blockIdx.x);
  auto ring = [&](int64_t j, int part) {
    return s_ring + (((int)(j % C1_ST) * 2 + part) * C1_NT + tid) * EB;
  };
  auto fetch_step = [&](int64_t j) {
    if (j < nsteps) {
      int e, rr, cc;
      int64_t vox;
      bool ok, inner;
      locate(ig, ik, e, rr, cc, vox, ok, inner);
      if (ok && live) {
        copy_cpt<EB>(ring(j, 0), dyp + vox * a.cout + co);
        if (fold) copy_cpt<EB>(ring(j, 1), yp + vox * a.cout + co);
      }
      if (++ik == passes) {
        ik = 0;
        if (++it < ntl) ig = tile_at(blockIdx.x + it * gridDim.x);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < C1_ST - 1; ++j) fetch_step(j);

  // The input window of a tile, value p = (dz * npos + pos) * CIN + ci,
  // fetched a tile ahead: this thread's values tid + i C1_NT in xpf, with
  // a bit of xok each for the values inside the volume (0 outside, after
  // the prologue).
  constexpr int XPF = (KD * C1_NPOS * CIN + C1_NT - 1) / C1_NT;
  T xpf[XPF];
  unsigned xok = 0;
  auto fetch_x = [&](const Tile& g) {
    xok = 0;
#pragma unroll
    for (int i = 0; i < XPF; ++i) {
      const int p = tid + i * C1_NT;
      const int ci = p % CIN;
      const int dz = p / CIN / npos;
      const int pos = p / CIN % npos;
      const int gz = g.zd + dz - KD / 2;
      const int hh = g.h0 + pos / sw - 1;
      const int ww = g.w0 + pos % sw - 1;
      if (p < KD * npos * CIN && gz >= 0 && gz < a.d && hh >= 0
          && hh < a.h && ww >= 0 && ww < a.wd) {
        xpf[i] = xp[(((g.nd + dz - KD / 2) * a.h + hh) * a.wd + ww) * CIN
                    + ci];
        xok |= 1u << i;
      }
    }
  };
  fetch_x(tile_at(blockIdx.x));

  int64_t step = 0;
  for (int64_t ti = 0; ti < ntl; ++ti) {
    const Tile tl = tile_at(blockIdx.x + ti * gridDim.x);
    const int64_t nd = tl.nd;
    const int h0 = tl.h0;
    const int w0 = tl.w0;
    __syncthreads();  // the previous tile's reads of s_a and s_dx are done
#pragma unroll
    for (int i = 0; i < XPF; ++i) {
      const int p = tid + i * C1_NT;
      const int ci = p % CIN;
      if (p < KD * npos * CIN)
        s_a[p] = (xok >> i) & 1u
            ? round_to<T>(prologue(to_f(xpf[i]), pinv[ci], pshift[ci],
                                   a.act))
            : 0.0f;
    }
    if (ti + 1 < ntl) fetch_x(tile_at(blockIdx.x + (ti + 1) * gridDim.x));
    __syncthreads();

    for (int k = 0; k < passes; ++k, ++step) {
      fetch_step(step + C1_ST - 1);
      cp_async_wait<C1_ST - 1>();   // this thread's copies of this step
      int e, rr, cc;
      int64_t vox;
      bool ok, inner;
      locate(tl, k, e, rr, cc, vox, ok, inner);
      inner = inner && live;
      float g[CPT];
      if (ok && live) {
        float dv[CPT];
        load_cpt<T, CPT>(reinterpret_cast<const T*>(ring(step, 0)), dv);
        if (fold) {
          float yv[CPT];
          load_cpt<T, CPT>(reinterpret_cast<const T*>(ring(step, 1)), yv);
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            dv[c] = dy_tot(dv[c], yv[c], s_ds[co + c], s_dq[co + c]);
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          if (inner) dbl[c] += dv[c];
          g[c] = round_to<T>(dv[c]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) g[c] = 0.0f;
      }
      if (inner) {
#pragma unroll
        for (int tap = 0; tap < TAPS; ++tap) {
          const int dz = tap / 9;
          const int ky = (tap / 3) % 3;
          const int kx = tap % 3;
          const float* av =
              s_a + ((dz * (th + 2) + rr + ky) * sw + cc + kx) * CIN;
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci) {
            const float x = av[ci];
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              acc[tap][ci][j] = fmaf(x, g[j], acc[tap][ci][j]);
          }
        }
      }
      if (DX) {
        // This voxel's share of dx at the tile's voxels u = v + (ky - 1,
        // kx - 1) of plane zd, through the depth tap kz = KD / 2 - e.
        const int kz = ok ? KD / 2 - e : 0;
        float pr[9][CIN];
#pragma unroll
        for (int t9 = 0; t9 < 9; ++t9)
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci) {
            // A lane without channels has g = 0 and reads real columns.
            const float* wr = s_w + ((kz * 9 + t9) * CIN + ci) * a.cout + cw;
            float s = 0.0f;
#pragma unroll
            for (int j = 0; j < CPT; ++j) s = fmaf(g[j], wr[j], s);
            pr[t9][ci] = s;
          }
        for (int off = 1; off < grp; off <<= 1)
#pragma unroll
          for (int t9 = 0; t9 < 9; ++t9)
#pragma unroll
            for (int ci = 0; ci < CIN; ++ci)
              pr[t9][ci] += __shfl_xor_sync(0xffffffffu, pr[t9][ci], off);
        if (ok) {   // the voxel's: a lane without channels holds the sum too
#pragma unroll
          for (int t9 = 0; t9 < 9; ++t9) {
            const int ur = rr + t9 / 3 - 1;
            const int uc = cc + t9 % 3 - 1;
            if (t9 % grp == lane % grp && ur >= 0 && ur < th && uc >= 0
                && uc < tw) {
#pragma unroll
              for (int ci = 0; ci < CIN; ++ci)
                atomicAdd(&s_dx[(ur * tw + uc) * CIN + ci], pr[t9][ci]);
            }
          }
        }
      }
    }
    if (DX) {
      __syncthreads();   // every share of the tile's dx is in s_dx
      // Thread tid finishes the tile's voxel tid (C1_TV == C1_NT).
      const int hh = h0 + tid / tw;
      const int ww = w0 + tid % tw;
      if (hh < a.h && ww < a.wd) {
        const int64_t vox = (nd * a.h + hh) * a.wd + ww;
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci) {
          const float xv = to_f(xp[vox * CIN + ci]);
          const float gm = s_dx[tid * CIN + ci]
              * act_grad(pre_act(xv, pinv[ci], pshift[ci]), a.act);
          static_cast<T*>(a.dx)[vox * CIN + ci] =
              from_f<T>(gm * pinv[ci]);
          dinvl[ci] = fmaf(gm, xv, dinvl[ci]);
          dshiftl[ci] += gm;
        }
      }
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) s_dx[tid * CIN + ci] = 0.0f;
    }
  }

  cp_async_wait<0>();

  // The block's sums: lanes of a warp that hold the same channels first
  // (shuffles), then shared memory, then one device atomic per sum.
  for (int off = tpv; off < 32; off <<= 1) {
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          acc[tap][ci][j] += __shfl_xor_sync(0xffffffffu, acc[tap][ci][j],
                                             off);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      dbl[j] += __shfl_xor_sync(0xffffffffu, dbl[j], off);
  }
  if (DX) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) {
        dinvl[ci] += __shfl_xor_sync(0xffffffffu, dinvl[ci], off);
        dshiftl[ci] += __shfl_xor_sync(0xffffffffu, dshiftl[ci], off);
      }
  }
  const int nw = TAPS * CIN * a.cout;
  float* s_red = smem;   // [nw] dW, [cout] db, [CIN] dinv, [CIN] dshift
  __syncthreads();       // the last tile's reads of smem are done
  for (int i = tid; i < nw + a.cout + 2 * CIN; i += C1_NT) s_red[i] = 0.0f;
  __syncthreads();
  if (lane < tpv && live) {   // one lane of each channel group of a warp
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          atomicAdd(&s_red[(tap * CIN + ci) * a.cout + co + j],
                    acc[tap][ci][j]);
#pragma unroll
    for (int j = 0; j < CPT; ++j) atomicAdd(&s_red[nw + co + j], dbl[j]);
  }
  if (DX && lane == 0) {
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) {
      atomicAdd(&s_red[nw + a.cout + ci], dinvl[ci]);
      atomicAdd(&s_red[nw + a.cout + CIN + ci], dshiftl[ci]);
    }
  }
  __syncthreads();
  for (int i = tid; i < nw; i += C1_NT) atomicAdd(a.dw + i, s_red[i]);
  for (int i = tid; i < a.cout; i += C1_NT) atomicAdd(a.db + i,
                                                      s_red[nw + i]);
  if (DX && tid < CIN) {
    atomicAdd(a.dinv + tid, s_red[nw + a.cout + tid]);
    atomicAdd(a.dshift + tid, s_red[nw + a.cout + CIN + tid]);
  }
}

int c1_sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

template <typename T, int CIN, int KD, bool DX>
cudaError_t c1_launch(const C1Args& a, cudaStream_t stream) {
  const int npos = (a.th + 2) * (a.tw + 2);
  const size_t smem = c1_smem(CIN, KD, a.cout, npos, DX,
                              C1Cpt<CIN, KD>::value * (int)sizeof(T));
  auto kern = conv1_bwd_kernel<T, CIN, KD, DX>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  int64_t blocks = 2 * (int64_t)c1_sm_count();
  if (blocks > a.ntiles) blocks = a.ntiles;
  if (blocks < 1) blocks = 1;
  kern<<<(unsigned)blocks, C1_NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool DX>
cudaError_t c1_dispatch(const C1Args& a, int cin, int kd, cudaStream_t s) {
  if (kd == 1) {
    switch (cin) {
      case 1: return c1_launch<T, 1, 1, DX>(a, s);
      case 2: return c1_launch<T, 2, 1, DX>(a, s);
      case 3: return c1_launch<T, 3, 1, DX>(a, s);
      default: return c1_launch<T, 4, 1, DX>(a, s);
    }
  }
  switch (cin) {
    case 1: return c1_launch<T, 1, 3, DX>(a, s);
    case 2: return c1_launch<T, 2, 3, DX>(a, s);
    case 3: return c1_launch<T, 3, 3, DX>(a, s);
    default: return c1_launch<T, 4, 3, DX>(a, s);
  }
}

}  // namespace

// Row 13's kernel. ``inv``/``shift`` are (cin,) (ones and zeros for the
// identity prologue); ``ds``/``dq`` null means no statistics cotangent
// (``y`` is then not read); ``dx`` null skips the input gradient (``wt``,
// ``dinv`` and ``dshift`` are then not used). dw (kd, 3, 3, cin, cout),
// db, dinv and dshift are float32, zeroed by the caller; ``wt`` is the
// (kd, 3, 3, cin, cout) weight rounded to the dtype, as float32. Needs
// 1 <= cin <= 4, cout % 32 == 0, cout <= 256 and kd in {1, 3} (a cout /
// CPT that is no power of two leaves the last lanes of a voxel idle).
extern "C" int e3_conv1_bwd(int dtype, const void* x, int cin,
                            const float* inv, const float* shift,
                            const void* dy, const void* y, const float* ds,
                            const float* dq, int cout, const float* wt,
                            float* dw, float* db, void* dx, float* dinv,
                            float* dshift, int n, int d, int h, int wd,
                            int kd, int act, void* stream) {
  if (cin < 1 || cin > 4 || cout % 32 || cout > 256 || (kd != 1 && kd != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  C1Args a = {};
  a.x = x;
  a.inv = inv;
  a.shift = shift;
  a.dy = dy;
  a.y = y;
  a.ds = ds;
  a.dq = dq;
  a.wt = wt;
  a.dw = dw;
  a.db = db;
  a.dx = dx;
  a.dinv = dinv;
  a.dshift = dshift;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cout = cout;
  a.act = act;
  // The tile (TW x TH = 256) that pads the plane least (the wider on a
  // tie).
  int64_t best = -1;
  for (int tw = 32; tw >= 8; tw /= 2) {
    const int th = C1_TV / tw;
    const int64_t area = (int64_t)((h + th - 1) / th) * th
        * ((wd + tw - 1) / tw) * tw;
    if (best < 0 || area < best) {
      best = area;
      a.tw = tw;
      a.th = th;
    }
  }
  a.ntiles = (int64_t)n * d * ((h + a.th - 1) / a.th)
      * ((wd + a.tw - 1) / a.tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (dtype == DT_BF16)
    rc = dx != nullptr ? c1_dispatch<__nv_bfloat16, true>(a, cin, kd, s)
                       : c1_dispatch<__nv_bfloat16, false>(a, cin, kd, s);
  else
    rc = dx != nullptr ? c1_dispatch<float, true>(a, cin, kd, s)
                       : c1_dispatch<float, false>(a, cin, kd, s);
  return static_cast<int>(rc);
}
