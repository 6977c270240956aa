// Row 3: K1's forward over the network input (conv1 of the first level),
// one input of 1 to 4 channels, in one streaming pass:
//     y[v, co] = round(bias[co] + sum over (tap, ci) of
//                      a[v + tap, ci] * W[tap, ci, co])
// and, when asked, the per-channel float32 (sum, sumsq) of the stored,
// rounded y, where a = act(x * inv + shift) rounded to the activation
// dtype (0 at the halo, after the prologue; x itself for the identity
// prologue), W the weight rounded to that dtype and the sum float32: the
// rounding points of conv_bnact_fwd_plain (ops/fused.py).
//
// Replaces ops/flat_fused.py::conv1_bnstats_flat (_conv1_fwd_kernel) of
// the JAX package, and the one-channel first conv of the C=64 executor
// (flat_fused64.py::conv3_bnact_flat64 with cin_real = 1).
//
// What bounds it on the card: the bytes it writes (C_out values a voxel,
// 64 bytes at C_out = 32 in bf16, against 2 bytes read: 174 MB at
// bench.py's step, 0.052 ms). Arithmetic is 9 kd C_in multiply-adds an
// output value, 1.57 GFLOP at the bench: 23 us on the CUDA cores, but
// with a bias add, a rounding and two statistics sums an output the
// CUDA-core form issues about 17 instructions a value and is bound by
// issue, not bytes. The design (the layout of row 13's backward,
// csrc/conv1_bwd.cu):
//   - persistent blocks of 256 threads (as many as fit the SMs) walk
//     tiles of 256 voxels (TH x TW of one (n, depth) plane, TW of 8, 16
//     or 32 by the width);
//   - the tile's input window (TH + 2) x (TW + 2) x C_in, for the kd
//     depth taps, is staged prologued and rounded in shared memory (two
//     buffers: the next tile is staged while this one is computed, one
//     barrier a tile); its raw values are fetched into registers two
//     tiles ahead, 32-bit tile arithmetic, the window's layout decoded
//     once per thread;
//   - bf16 with K = 9 kd C_in <= 48 and C_out of 32, 64, 128 or 256 (every
//     model path) runs the tensor-core form: the products as mma.m16n8k16
//     (voxels x K by K x 32 channels, K zero-padded to 16), the A
//     fragments read straight from the window, the weights' B fragments
//     in registers, columns permuted so that a lane's accumulators of a
//     voxel are 8 consecutive channels; about 6 instructions a value;
//   - else (float32, and the other bf16 shapes) the CUDA-core form: a
//     thread owns CPT consecutive output channels of one voxel a pass (8
//     where 9 kd C_in x 8 weights fit 72 registers) and keeps their
//     weights in registers, so a pass is 9 kd C_in broadcast
//     shared-memory reads and 9 kd C_in CPT FMAs, no lane multiplying a
//     channel the input does not have;
//   - in both, a lane stores 8 consecutive channels of a voxel as one
//     16-byte vector (bf16), a warp 512 contiguous bytes at C_out = 32;
//   - the statistics stay in registers over all of a thread's tiles,
//     read from the stored bf16 bits; at the end, shuffles over the lanes
//     that hold the same channels, shared memory, and one device atomic
//     per channel and block.
// The order of the atomics changes from run to run, hence the last bits
// of the statistics (as in K1's other bodies); the two forms sum the
// products in different orders (both float32).
#include <type_traits>

#include "tc.cuh"

namespace {

using namespace e3;

struct CfArgs {
  const void* x;         // (n, d, h, w, cin) network input
  const float* inv;      // (cin,) prologue vectors, or null: identity
  const float* shift;
  const float* wt;       // (cout, cin, kd, 3, 3) float32 weight
  const float* bias;     // (cout,)
  void* y;               // (n, d, h, w, cout)
  float* s;              // (cout,) statistics, zeroed, or null
  float* q;
  int n, d, h, wd, cout, act, tw, th;
  int64_t ntiles;
};

constexpr int CF_NT = 256;     // threads per block
constexpr int CF_TV = 256;     // voxels per tile: TH x TW
constexpr int CF_ACC = 72;     // weights a thread may keep
constexpr int CF_NPOS = 340;   // the most window voxels, (TH + 2)(TW + 2)
constexpr int CF_MAXC = 256;   // output channels

// Output channels per thread: the most (8 down to 1) whose 9 kd C_in
// weights fit CF_ACC, or 1.
template <int CIN, int KD>
struct CfCpt {
  static constexpr int value = 9 * KD * CIN * 8 <= CF_ACC ? 8
      : 9 * KD * CIN * 4 <= CF_ACC ? 4
      : 9 * KD * CIN * 2 <= CF_ACC ? 2 : 1;
};

// Store CPT consecutive float32 values as T (the address is aligned to
// CPT elements: cout and the channel offset are multiples of CPT): float32
// as vectors, a single bf16 value as it is (bf16 pairs: store_out).
template <typename T, int CPT>
__device__ __forceinline__ void store_cpt(T* p, const float* v) {
  if constexpr (std::is_same<T, float>::value && CPT == 8) {
    store8(p, v);
  } else if constexpr (std::is_same<T, float>::value && CPT == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (std::is_same<T, float>::value && CPT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) p[j] = from_f<T>(v[j]);
  }
}

// Store CPT output values and, with ST, add the stored values and their
// squares into sj and qj. In bf16 the statistics read the packed bits that
// are stored (one shift or mask a value), not a second rounding.
template <typename T, int CPT, bool ST>
__device__ __forceinline__ void store_out(T* p, const float* v, float* sj,
                                          float* qj) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && CPT % 2 == 0) {
    uint32_t u[CPT / 2];
#pragma unroll
    for (int i = 0; i < CPT / 2; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    if constexpr (CPT == 8)
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    else if constexpr (CPT == 4)
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    else
      *reinterpret_cast<uint32_t*>(p) = u[0];
    if constexpr (ST) {
#pragma unroll
      for (int i = 0; i < CPT / 2; ++i) {
        const float lo = __uint_as_float(u[i] << 16);
        const float hi = __uint_as_float(u[i] & 0xffff0000u);
        sj[2 * i] += lo;
        qj[2 * i] = fmaf(lo, lo, qj[2 * i]);
        sj[2 * i + 1] += hi;
        qj[2 * i + 1] = fmaf(hi, hi, qj[2 * i + 1]);
      }
    }
  } else {
    store_cpt<T, CPT>(p, v);
    if constexpr (ST) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float r = round_to<T>(v[j]);
        sj[j] += r;
        qj[j] = fmaf(r, r, qj[j]);
      }
    }
  }
}

// The tensor-core form (TC): bf16, cout / 32 dividing 8 and K = 9 kd C_in
// <= 48. Its A operand, voxels x K, is read from the staged window as
// mma.m16n8k16 fragments (k = tap * C_in + ci, zero past K); its B
// operand, K x 32 output channels, stays in registers, its columns
// permuted so that lane l's accumulators of a row are the 8 consecutive
// channels 8 (l % 4) .. + 7 of its chunk: one 16-byte store a row and
// fixed channels for the statistics.
template <int CIN, int KD>
struct CfTc {
  static constexpr int K = 9 * KD * CIN;
  static constexpr int KS = (K + 15) / 16;     // k16 steps
};

template <typename T, int CIN, int KD>
constexpr bool cf_tc() {
  return std::is_same<T, __nv_bfloat16>::value && 9 * KD * CIN <= 48;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

template <typename T, int CIN, int KD, bool ST, bool TC>
__global__ void __launch_bounds__(
    CF_NT, TC || 9 * KD * CIN * CfCpt<CIN, KD>::value <= CF_ACC ? 2 : 1)
    conv1_fwd_kernel(const CfArgs a) {
  constexpr int CPT = TC ? 8 : CfCpt<CIN, KD>::value;
  constexpr int TAPS = 9 * KD;
  constexpr int KS = CfTc<CIN, KD>::KS;
  __shared__ float s_a[2][KD * CF_NPOS * CIN];   // [KD][npos][CIN] twice
  __shared__ float s_pro[2][CIN];             // inv, shift
  __shared__ float s_red[2][ST ? CF_MAXC : 1];
  const int tw = a.tw;
  const int th = a.th;
  const int sw = tw + 2;                      // window width
  const int npos = (th + 2) * sw;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // FMA form: threads of a voxel, cout / CPT rounded up to a power of
  // two, so that a voxel's lanes are an aligned group and vpp * tpv ==
  // CF_NT; the threads past cout / CPT hold no channels (live false).
  // TC form: warp w takes the 32-channel chunk w % nch and m16 tiles
  // w / nch + i (8 / nch) of each tile; lanes with one lane % 4 hold the
  // same channels.
  int tpv = 1;
  while (tpv * CPT < a.cout) tpv *= 2;
  const int nch = a.cout / 32;
  const int co = TC ? (warp % nch) * 32 + (lane % 4) * 8
                    : (tid % tpv) * CPT;      // this thread's channels
  const bool live = co < a.cout;
  const int same = TC ? 4 : tpv;              // lanes apart, same channels
  const bool pro = a.inv != nullptr;
  const T* xp = static_cast<const T*>(a.x);
  T* yp = static_cast<T*>(a.y);
  if (tid < CIN) {
    s_pro[0][tid] = pro ? a.inv[tid] : 1.0f;
    s_pro[1][tid] = pro ? a.shift[tid] : 0.0f;
  }
  if (ST)
    for (int i = tid; i < 2 * a.cout; i += CF_NT)
      s_red[i / a.cout][i % a.cout] = 0.0f;

  float bj[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) bj[j] = live ? a.bias[co + j] : 0.0f;
  // FMA form: this thread's weights, [tap][ci][j].
  float wr[TC ? 1 : TAPS][CIN][CPT];
  // TC form: B fragments of the chunk, [k step][n8 tile][2], column c of
  // tile j being channel 8 (c / 2) + 2 j + c % 2 of the chunk; and this
  // lane's A offsets in the window, [k step][4] for k = 16 ks + 2 (l % 4)
  // + {0, 1, 8, 9} (a bit each of kin: k < K).
  uint32_t bfr[TC ? KS : 1][4][2];
  int kof[TC ? KS : 1][4];
  unsigned kin = 0;
  if constexpr (TC) {
    const int cb = (warp % nch) * 32 + 8 * ((lane / 4) / 2) + (lane / 4) % 2;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 16 * ks + 2 * (lane % 4) + (e & 1) + 8 * (e >> 1);
        const int tap = k / CIN;
        const int ci = k % CIN;
        const bool in = k < CfTc<CIN, KD>::K;
        kof[ks][e] = in ? (((tap / 9) * (th + 2) + (tap / 3) % 3) * sw
                           + tap % 3) * CIN + ci : 0;
        if (in) kin |= 1u << (4 * ks + e);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float w4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // rounded to bf16 by the packing
          const int k = 16 * ks + 2 * (lane % 4) + (e & 1) + 8 * (e >> 1);
          w4[e] = k < CfTc<CIN, KD>::K
              ? a.wt[((cb + 2 * j) * CIN + k % CIN) * TAPS + k / CIN] : 0.0f;
        }
        bfr[ks][j][0] = pack_bf16x2(w4[0], w4[1]);
        bfr[ks][j][1] = pack_bf16x2(w4[2], w4[3]);
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < TAPS; ++t)
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          wr[t][ci][j] = live
              ? round_to<T>(a.wt[((co + j) * CIN + ci) * TAPS + t]) : 0.0f;
  }
  float sj[CPT], qj[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) sj[j] = qj[j] = 0.0f;

  // Tiles, 32-bit (the entry refuses 2^31 tiles or more): tile t is
  // column t % tiles_w, row (t / tiles_w) % tiles_h of plane nd.
  const int tiles_w = (a.wd + tw - 1) / tw;
  const int tiles_h = (a.h + th - 1) / th;
  struct Tile {
    int nd, zd, h0, w0;
  };
  auto tile_at = [&](int t) {
    Tile g;
    const int r0 = t / tiles_w;
    g.w0 = (t - r0 * tiles_w) * tw;
    g.nd = r0 / tiles_h;
    g.h0 = (r0 - g.nd * tiles_h) * th;
    g.zd = g.nd % a.d;
    return g;
  };
  const int lg_tw = __ffs(tw) - 1;            // tw is 8, 16 or 32
  // The input window of a tile, value p = (dz * npos + pos) * CIN + ci,
  // fetched two tiles ahead: this thread's values tid + i CF_NT in xpf, with
  // a bit of xok each for the values inside the volume (0 outside, after
  // the prologue). Where each value sits in the window does not change
  // from tile to tile: win[i] holds its (in window, dz, row, column, ci)
  // in bits 20, 16-19, 10-15, 4-9 and 0-3, once per thread.
  constexpr int XPF = (KD * CF_NPOS * CIN + CF_NT - 1) / CF_NT;
  T xpf[XPF];
  unsigned win[XPF];
  unsigned xok = 0;
#pragma unroll
  for (int i = 0; i < XPF; ++i) {
    const int p = tid + i * CF_NT;
    const int pos = p / CIN % npos;
    win[i] = (p < KD * npos * CIN ? 1u << 20 : 0u)
        | (unsigned)(p / CIN / npos) << 16 | (unsigned)(pos / sw) << 10
        | (unsigned)(pos % sw) << 4 | (unsigned)(p % CIN);
  }
  auto fetch_x = [&](const Tile& g) {
    xok = 0;
#pragma unroll
    for (int i = 0; i < XPF; ++i) {
      const int dz = (win[i] >> 16) & 15;
      const int gz = g.zd + dz - KD / 2;
      const int hh = g.h0 + (int)((win[i] >> 10) & 63) - 1;
      const int ww = g.w0 + (int)((win[i] >> 4) & 63) - 1;
      if ((win[i] >> 20) && gz >= 0 && gz < a.d && hh >= 0 && hh < a.h
          && ww >= 0 && ww < a.wd) {
        xpf[i] = xp[(((int64_t)(g.nd + dz - KD / 2) * a.h + hh) * a.wd
                     + ww) * CIN + (win[i] & 15)];
        xok |= 1u << i;
      }
    }
  };
  // Stage the fetched window prologued and rounded into buffer buf.
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < XPF; ++i) {
      if (win[i] >> 20) {
        const int ci = win[i] & 15;
        float v = 0.0f;
        if ((xok >> i) & 1u) {
          v = to_f(xpf[i]);
          if (pro) v = round_to<T>(prologue(v, s_pro[0][ci], s_pro[1][ci],
                                             a.act));
        }
        s_a[buf][tid + i * CF_NT] = v;
      }
    }
  };
  // Tile ti is computed from buffer ti % 2 while tile ti + 1 is staged
  // into the other and tile ti + 2 fetched: one barrier a tile.
  const int ntl = blockIdx.x < a.ntiles
      ? ((int)a.ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  __syncthreads();   // s_pro is visible
  if (ntl > 0) {
    fetch_x(tile_at(blockIdx.x));
    stage(0);
    if (ntl > 1) fetch_x(tile_at(blockIdx.x + gridDim.x));
  }
  __syncthreads();

  for (int ti = 0; ti < ntl; ++ti) {
    const Tile tl = tile_at(blockIdx.x + ti * gridDim.x);
    if (ti + 1 < ntl) {
      stage((ti + 1) & 1);
      if (ti + 2 < ntl) fetch_x(tile_at(blockIdx.x + (ti + 2) * gridDim.x));
    }
    const float* s_cur = s_a[ti & 1];
    const int64_t row0 = (int64_t)tl.nd * a.h + tl.h0;
    // Store a voxel's CPT values (bias added), v its index in the tile.
    auto emit = [&](int v, float* acc) {
      const int rr = v >> lg_tw;
      const int cc = v & (tw - 1);
      if (!live || tl.h0 + rr >= a.h || tl.w0 + cc >= a.wd) return;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[j] += bj[j];
      const int64_t vox = (row0 + rr) * a.wd + tl.w0 + cc;
      store_out<T, CPT, ST>(yp + vox * a.cout + co, acc, sj, qj);
    };
    if constexpr (TC) {
      for (int mt = warp / nch; mt < CF_TV / 16; mt += 8 / nch) {
        // This lane's rows: voxels v0 and v0 + 8 of the m16 tile.
        const int v0 = 16 * mt + lane / 4;
        const float* w0 =
            s_cur + ((v0 >> lg_tw) * sw + (v0 & (tw - 1))) * CIN;
        const float* w1 =
            s_cur + (((v0 + 8) >> lg_tw) * sw + ((v0 + 8) & (tw - 1))) * CIN;
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          float av[2][4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = (kin >> (4 * ks + e)) & 1u;
            av[0][e] = in ? w0[kof[ks][e]] : 0.0f;
            av[1][e] = in ? w1[kof[ks][e]] : 0.0f;
          }
          const uint32_t af[4] = {pack_bf16x2(av[0][0], av[0][1]),
                                  pack_bf16x2(av[1][0], av[1][1]),
                                  pack_bf16x2(av[0][2], av[0][3]),
                                  pack_bf16x2(av[1][2], av[1][3])};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16_16816(acc[j], af, bfr[ks][j][0], bfr[ks][j][1]);
        }
        float r0v[8], r1v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          r0v[2 * j] = acc[j][0];
          r0v[2 * j + 1] = acc[j][1];
          r1v[2 * j] = acc[j][2];
          r1v[2 * j + 1] = acc[j][3];
        }
        emit(v0, r0v);
        emit(v0 + 8, r1v);
      }
    } else {
      const int vpp = CF_NT / tpv;            // voxels a pass
      for (int vi = tid / tpv; vi < CF_TV; vi += vpp) {
        const int rr = vi >> lg_tw;
        const int cc = vi & (tw - 1);
        if (!live || tl.h0 + rr >= a.h || tl.w0 + cc >= a.wd) continue;
        float acc[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[j] = 0.0f;
#pragma unroll
        for (int tap = 0; tap < TAPS; ++tap) {
          const int dz = tap / 9;
          const int ky = (tap / 3) % 3;
          const int kx = tap % 3;
          const float* av =
              s_cur + ((dz * (th + 2) + rr + ky) * sw + cc + kx) * CIN;
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci) {
            const float xv = av[ci];
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              acc[j] = fmaf(xv, wr[tap][ci][j], acc[j]);
          }
        }
        emit(vi, acc);
      }
    }
    __syncthreads();   // tile ti + 1 is staged; buffer ti % 2 is free
  }
  if (!ST) return;

  // The block's sums: lanes of a warp that hold the same channels first
  // (shuffles), then shared memory, then one device atomic per channel.
  for (int off = same; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      sj[j] += __shfl_xor_sync(0xffffffffu, sj[j], off);
      qj[j] += __shfl_xor_sync(0xffffffffu, qj[j], off);
    }
  }
  __syncthreads();   // s_red's initialization is visible
  if (lane < same && live) {   // one lane of each channel group of a warp
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      atomicAdd(&s_red[0][co + j], sj[j]);
      atomicAdd(&s_red[1][co + j], qj[j]);
    }
  }
  __syncthreads();
  for (int i = tid; i < a.cout; i += CF_NT) {
    atomicAdd(a.s + i, s_red[0][i]);
    atomicAdd(a.q + i, s_red[1][i]);
  }
}

int cf_sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

template <typename T, int CIN, int KD, bool ST, bool TC>
cudaError_t cf_launch(const CfArgs& a, cudaStream_t stream) {
  auto kern = conv1_fwd_kernel<T, CIN, KD, ST, TC>;
  static int per_sm = 0;   // resident blocks an SM, per instantiation
  if (per_sm == 0) {
    cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, CF_NT, 0);
    if (rc != cudaSuccess) return rc;
    if (per_sm < 1) per_sm = 1;
  }
  int64_t blocks = (int64_t)per_sm * cf_sm_count();
  if (blocks > a.ntiles) blocks = a.ntiles;
  if (blocks < 1) blocks = 1;
  kern<<<(unsigned)blocks, CF_NT, 0, stream>>>(a);
  return cudaGetLastError();
}

// The TC form where it applies (cf_tc, and cout / 32 dividing the 8
// warps), else the FMA form: chosen by shape alone.
template <typename T, int CIN, int KD, bool ST>
cudaError_t cf_pick(const CfArgs& a, cudaStream_t s) {
  if constexpr (cf_tc<T, CIN, KD>()) {
    if (8 % (a.cout / 32) == 0) return cf_launch<T, CIN, KD, ST, true>(a, s);
  }
  return cf_launch<T, CIN, KD, ST, false>(a, s);
}

template <typename T, bool ST>
cudaError_t cf_dispatch(const CfArgs& a, int cin, int kd, cudaStream_t s) {
  if (kd == 1) {
    switch (cin) {
      case 1: return cf_pick<T, 1, 1, ST>(a, s);
      case 2: return cf_pick<T, 2, 1, ST>(a, s);
      case 3: return cf_pick<T, 3, 1, ST>(a, s);
      default: return cf_pick<T, 4, 1, ST>(a, s);
    }
  }
  switch (cin) {
    case 1: return cf_pick<T, 1, 3, ST>(a, s);
    case 2: return cf_pick<T, 2, 3, ST>(a, s);
    case 3: return cf_pick<T, 3, 3, ST>(a, s);
    default: return cf_pick<T, 4, 3, ST>(a, s);
  }
}

}  // namespace

// Row 3's kernel. ``inv``/``shift`` are (cin,), or null for the identity
// prologue (the staged value is x itself); ``s``/``q`` null skips the
// statistics, else both are (cout,) float32, zeroed by the caller.
// ``wt`` is the (cout, cin, kd, 3, 3) float32 weight, which the kernel
// rounds to the dtype; ``bias`` (cout,) float32. Needs 1 <= cin <= 4,
// cout % 32 == 0, cout <= 256 and kd in {1, 3} (a cout / CPT that is no
// power of two leaves the last lanes of a voxel idle).
extern "C" int e3_conv1_fwd(int dtype, const void* x, int cin,
                            const float* inv, const float* shift,
                            const float* wt, const float* bias, void* y,
                            float* s, float* q, int n, int d, int h, int wd,
                            int cout, int kd, int act, void* stream) {
  if (cin < 1 || cin > 4 || cout % 32 || cout > CF_MAXC
      || (kd != 1 && kd != 3) || (s == nullptr) != (q == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CfArgs a = {};
  a.x = x;
  a.inv = inv;
  a.shift = shift;
  a.wt = wt;
  a.bias = bias;
  a.y = y;
  a.s = s;
  a.q = q;
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
    const int th = CF_TV / tw;
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
  if (a.ntiles == 0) return static_cast<int>(cudaSuccess);
  if (a.ntiles >= ((int64_t)1 << 31))   // the kernel indexes tiles in 32 bits
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (dtype == DT_BF16)
    rc = s != nullptr ? cf_dispatch<__nv_bfloat16, true>(a, cin, kd, st)
                      : cf_dispatch<__nv_bfloat16, false>(a, cin, kd, st);
  else
    rc = s != nullptr ? cf_dispatch<float, true>(a, cin, kd, st)
                      : cf_dispatch<float, false>(a, cin, kd, st);
  return static_cast<int>(rc);
}
