// The merged backward of K1 conv_bnact, as two kernels, on the CUDA
// cores (the float32 bodies; bf16 runs the tensor-core bodies named
// below, and the network input the row-13 kernel):
//
// K4 conv_bnact_dgrad: dy_tot = dy + ds + 2 y dq on load (the batch
//   statistics' cotangent folded in), rounded to the activation dtype,
//   then K1's 'same' conv with the flipped, transposed weights over
//   kd in {1, 3}; its epilogue gives dx for each input of a merge conv
//   and the prologue gradients dinv and dshift. It is K1's CUDA-core
//   implicit GEMM (conv_bnact.cuh, DG = true) with another load step and
//   epilogue. bf16 runs e3_conv_bnact_dgrad_tc (dgrad_tc.cu, the tensor
//   cores) where the wrapper's dgrad_body says 'tc'.
// K5 conv_bnact_wgrad: dW[tap, ci, co] = sum over voxels of
//   a[pos + tap, ci] * dy_tot[pos, co], with a the RECOMPUTED prologued
//   input rounded to the dtype (the forward does not store it) and
//   dy_tot rounded to the dtype; db = sum of the float32 dy_tot. bf16
//   with every C_in % 16 == 0 runs e3_conv_bnact_wgrad_tc (wgrad_tc.cu).
//
// Replace these TPU kernels of the JAX package (in float32):
//   ops/flat_fused.py::_conv_bnact_bwd   (_fused_conv_bwd_kernel)
//   ops/flat_fused64.py::_conv64_bwd     (_conv64_bwd_kernel)
// ops/flat_fused.py::_conv1_bwd (the network input, C_in of 1 to 4) is
// e3_conv1_bwd (conv1_bwd.cu) in both dtypes: dW, db and, on request,
// dx in one pass. JAX's packed and combined-corner weight forms
// (_unpack_wgrad) are TPU lane artefacts; here dW comes out as
// (kd, 3, 3, C_in, C_out) and the wrapper views it in torch's layout.
//
// K5's contraction runs over every voxel (2.7 M at the headline L0 of a
// training batch), so it is split over voxel tiles: each block walks a
// strided share of the tiles for one depth tap, one group of 32 input
// channels and one of 32 output channels, keeps its 9 x 8 partial sums
// per thread in registers, and adds them into the float32 dW with
// atomics at the end (a few atomics per weight and block; the order,
// hence the last bits of the sum, changes from run to run). db is
// summed the same way by the blocks of the centre depth tap and the
// first channel group. What bounds K5: arithmetic on the CUDA cores
// (each staged value serves 9 taps x 8 output channels per thread).
//
// The per-sample mode (group and instance norm): ds, dq and the prologue
// are (n, C) rows at sample strides (0 for the batch form). A K4 block
// and a K5 tile lie in one (n, depth) plane, hence in one sample, and
// read its rows; K4's dinv and dshift then go, in a fixed order, into its
// block's partial row (conv_bnact.cuh), which ps_reduce sums in a fixed
// order. K5's dW and db stay global.
//
// e3_conv_vup_wgrad is K5 for the vup merge conv (VUP = true): its
// input 0 is the recomputed (1, 2, 2) upconv of the carry
// (upconv_vup.cuh), prologued and rounded as K1's vup staging does. It
// replaces the wgrad half of ops/flat_fused.py::_conv_vup_bwd in
// float32; bf16 runs e3_conv_vup_wgrad_tc (wgrad_tc.cu) at the shapes
// vup.vup_body takes.
#include <type_traits>

#include "conv_bnact.cuh"
#include "ps_reduce.cuh"

namespace {

constexpr int WTH = 8;               // voxel tile rows
constexpr int WTW = 8;               // voxel tile columns
constexpr int WV = WTH * WTW;        // voxels per tile
constexpr int WCI = 32;              // input channels per block
constexpr int WCO = 32;              // output channels per block
constexpr int WNT = 256;             // threads per block

struct WgradArgs {
  const void* x[2];
  int cin[2];
  int nin;
  int groups0;         // 32-channel groups of input 0
  const float* inv;    // (cin[0] + cin[1],) forward prologue vectors
  const float* shift;
  int pro_ns;          // per sample: their (n, .) rows' stride, or 0
  const void* dy;      // (n, d, h, w, cout)
  const void* y;       // forward output, for dy_tot
  const float* ds;     // (cout,) statistics cotangents, or null
  const float* dq;
  int st_ns;           // per sample: their (n, cout) rows' stride, or 0
  float* dw;           // (kd, 3, 3, cin[0] + cin[1], cout), zeroed
  float* db;           // (cout,), zeroed
  int n, d, h, wd, cout, kd, act;
};

// K5's arguments for the vup merge conv: input 0's carry (kd == 1). A
// type of its own, so that K5's other instantiations keep the argument
// layout, and the code, they compile to without it.
struct WgradVupArgs : WgradArgs {
  VupArgs vup;
  int vup_ns;          // per sample: the carry's (n, cc) rows' stride
};

// VPS: the vup instantiation's per-sample mode, which reads the carry's
// prologue row of the tile's sample (vup_ns); the batch form's code does
// not change.
template <typename T, typename Args = WgradArgs, bool VPS = false>
__global__ void __launch_bounds__(WNT) conv_wgrad_kernel(const Args a) {
  constexpr bool VUP = std::is_same<Args, WgradVupArgs>::value;
  __shared__ float s_a[WCI][WTH + 2][WTW + 2];
  __shared__ __align__(16) float s_g[WV][WCO];
  __shared__ float s_db[WCO];

  const int ncog = a.cout / WCO;
  const int co0 = (blockIdx.y % ncog) * WCO;
  const int cig = blockIdx.y / ncog;
  const int i = cig >= a.groups0;
  const int cb = (cig - (i ? a.groups0 : 0)) * WCI;
  const int ci = a.cin[i];
  const int coff = i ? a.cin[0] : 0;
  const int ct = a.cin[0] + a.cin[1];
  const int nci = min(WCI, ci - cb);        // real channels of the group
  int cip = 1;                              // padded to a power of two
  while (cip < nci) cip <<= 1;
  const int combos = cip * (WCO / 8);       // (channel, 8 outputs) pairs
  const int vsplit = WNT / combos;          // threads sharing a pair
  const int co8 = threadIdx.x % (WCO / 8);
  const int cil = (threadIdx.x / (WCO / 8)) % cip;
  const int vs = threadIdx.x / combos;
  const int dz = (int)blockIdx.z - a.kd / 2;
  const bool do_db = cig == 0 && dz == 0;
  const int ng8 = (nci + 7) / 8;            // 8-channel loads per voxel
  const T* x = static_cast<const T*>(a.x[i]);
  const T* dyp = static_cast<const T*>(a.dy);
  const T* yp = static_cast<const T*>(a.y);
  if (threadIdx.x < WCO) s_db[threadIdx.x] = 0.0f;

  float acc[9][8];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[t][j] = 0.0f;
  float dbl[8];  // db partials of this thread's staged channels
#pragma unroll
  for (int j = 0; j < 8; ++j) dbl[j] = 0.0f;

  const int tiles_h = (a.h + WTH - 1) / WTH;
  const int tiles_w = (a.wd + WTW - 1) / WTW;
  const int64_t ntiles = (int64_t)a.n * a.d * tiles_h * tiles_w;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int w0 = (int)(t % tiles_w) * WTW;
    const int64_t r = t / tiles_w;
    const int h0 = (int)(r % tiles_h) * WTH;
    const int64_t nd = r / tiles_h;
    const int dd = (int)(nd % a.d);
    const int zd = dd + dz;
    if (zd < 0 || zd >= a.d) continue;  // the tap reads zero padding
    const int64_t zplane = (nd + dz) * a.h;
    // The tile's sample's prologue and ds, dq rows.
    const int64_t po = nd / a.d * a.pro_ns + coff;
    const int64_t so = nd / a.d * a.st_ns + co0;
    __syncthreads();  // the previous tile's reads are done
    for (int p = threadIdx.x; p < (WTH + 2) * (WTW + 2) * ng8; p += WNT) {
      const int g = p % ng8;
      const int pos = p / ng8;
      const int hy = pos / (WTW + 2);
      const int hx = pos % (WTW + 2);
      const int gh = h0 + hy - 1;
      const int gw = w0 + hx - 1;
      float v[8];
      if (gh >= 0 && gh < a.h && gw >= 0 && gw < a.wd) {
        const int c0 = cb + 8 * g;
        if constexpr (VUP) {
          if (i == 0 && VPS)
            upconv_value8_row<T>(a.vup,
                                 vup_parent(nd + dz, gh, gw, a.h, a.wd),
                                 vup_sub(gh, gw), c0, v, nd / a.d * a.vup_ns);
          else if (i == 0)
            upconv_value8<T>(a.vup, vup_parent(nd + dz, gh, gw, a.h, a.wd),
                             vup_sub(gh, gw), c0, v);
          else
            load8_tail(x + ((zplane + gh) * a.wd + gw) * ci + c0, ci, c0,
                       v);
        } else {
          load8_tail(x + ((zplane + gh) * a.wd + gw) * ci + c0, ci, c0, v);
        }
#pragma unroll
        for (int c = 0; c < 8; ++c)
          v[c] = (c0 + c < ci)
              ? round_to<T>(prologue(v[c], a.inv[po + c0 + c],
                                     a.shift[po + c0 + c], a.act))
              : 0.0f;
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (8 * g + c < WCI) s_a[8 * g + c][hy][hx] = v[c];
    }
    {
      // One (voxel, 8 output channels) item of dy_tot per thread.
      const int v = threadIdx.x / (WCO / 8);
      const int c8 = threadIdx.x % (WCO / 8);
      const int gh = h0 + v / WTW;
      const int gw = w0 + v % WTW;
      float g[8];
      if (gh < a.h && gw < a.wd) {
        const int64_t off = ((nd * a.h + gh) * a.wd + gw) * a.cout + co0
            + 8 * c8;
        load8(dyp + off, g);
        if (a.ds != nullptr) {
          float yv[8];
          load8(yp + off, yv);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            g[j] = dy_tot(g[j], yv[j], a.ds[so + 8 * c8 + j],
                          a.dq[so + 8 * c8 + j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (do_db) dbl[j] += g[j];
          g[j] = round_to<T>(g[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) g[j] = 0.0f;
      }
      float4* dst = reinterpret_cast<float4*>(&s_g[v][8 * c8]);
      dst[0] = make_float4(g[0], g[1], g[2], g[3]);
      dst[1] = make_float4(g[4], g[5], g[6], g[7]);
    }
    __syncthreads();
    for (int v = vs; v < WV; v += vsplit) {
      const int ry = v / WTW;
      const int rx = v % WTW;
      const float4* gr = reinterpret_cast<const float4*>(&s_g[v][8 * co8]);
      const float4 g0 = gr[0];
      const float4 g1 = gr[1];
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float av = s_a[cil][ry + t / 3][rx + t % 3];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[t][j] = fmaf(av, g[j], acc[t][j]);
      }
    }
  }

  if (cil < nci) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      float* dst = a.dw
          + ((int64_t)(blockIdx.z * 9 + t) * ct + coff + cb + cil) * a.cout
          + co0 + 8 * co8;
#pragma unroll
      for (int j = 0; j < 8; ++j) atomicAdd(dst + j, acc[t][j]);
    }
  }
  if (do_db) {
    __syncthreads();  // s_db's initialization is visible
    const int c8 = threadIdx.x % (WCO / 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) atomicAdd(&s_db[8 * c8 + j], dbl[j]);
    __syncthreads();
    if (threadIdx.x < WCO) atomicAdd(a.db + co0 + threadIdx.x,
                                     s_db[threadIdx.x]);
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

}  // namespace

// K4, float32 body (bf16 is e3_conv_bnact_dgrad_tc). The per-sample
// mode: ``st_ns`` (cdy) for ds, dq rows of (n, cdy); ``pro_ns`` (c0 + c1)
// for prologue rows of (n, c0 + c1), with a workspace ``ws``
// (ps_workspace_floats of n samples, e3_conv_bnact_ps_parts rows of
// 2 (c0 + c1)): dinv and dshift then come per sample, in a fixed order,
// as (n, 2, c0 + c1) in ``dinv`` (``dshift`` unused, nothing zeroed).
extern "C" int e3_conv_bnact_dgrad(int dtype, int nin, const void* dy,
                                   const void* y, const float* ds,
                                   const float* dq, int st_ns, int cdy,
                                   const float* wt, const void* x0, int c0,
                                   const void* x1, int c1, const float* inv,
                                   const float* shift, int pro_ns, void* dx0,
                                   void* dx1, float* dinv, float* dshift,
                                   float* ws, int n, int d, int h, int wd,
                                   int kd, int act, void* stream) {
  if (ws != nullptr && n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a = {};
  a.x[0] = dy;
  a.cin[0] = cdy;
  a.cin[1] = 0;
  a.nin = 1;
  a.yv = y;
  a.ds = ds;
  a.dq = dq;
  a.st_ns = ds != nullptr ? st_ns : 0;
  a.pro_ns = pro_ns;
  a.part = ws;
  a.wt = wt;
  a.xe[0] = x0;
  a.xe[1] = x1;
  a.ce[0] = c0;
  a.ce[1] = nin > 1 ? c1 : 0;
  a.einv = inv;
  a.eshift = shift;
  a.dx[0] = dx0;
  a.dx[1] = dx1;
  a.dinv = dinv;
  a.dshift = dshift;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cout = a.ce[0] + a.ce[1];
  a.kd = kd;
  a.act = act;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = launch_conv_body<true>(a, dtype, st);
  if (rc == 0 && ws != nullptr)
    rc = static_cast<int>(ps_reduce(ws, n, (int64_t)d * ((h + TH - 1) / TH)
                                               * ((wd + TW - 1) / TW),
                                    2 * a.cout, dinv, st));
  return rc;
}

namespace {

// K5's grid: enough voxel splits for 4 blocks an SM over the (channel
// group, depth tap) blocks, at most one a tile.
template <typename Args, bool VPS = false>
int launch_wgrad(const Args& a, int dtype, void* stream) {
  const int groups = a.groups0 + (a.cin[1] + WCI - 1) / WCI;
  const int per_split = groups * (a.cout / WCO) * a.kd;
  const int64_t ntiles = (int64_t)a.n * a.d * ((a.h + WTH - 1) / WTH)
      * ((a.wd + WTW - 1) / WTW);
  int64_t splits = (4 * (int64_t)sm_count() + per_split - 1) / per_split;
  if (splits > ntiles) splits = ntiles;
  if (splits < 1) splits = 1;
  const dim3 grid((unsigned)splits, groups * (a.cout / WCO), a.kd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == e3::DT_BF16)
    conv_wgrad_kernel<__nv_bfloat16, Args, VPS><<<grid, WNT, 0, s>>>(a);
  else
    conv_wgrad_kernel<float, Args, VPS><<<grid, WNT, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5, float32 body (bf16 is e3_conv_bnact_wgrad_tc): ``pro_ns`` and
// ``st_ns`` the per-sample mode's row strides of the prologue and of ds,
// dq (0 for the batch form).
extern "C" int e3_conv_bnact_wgrad(int dtype, int nin, const void* x0,
                                   int c0, const void* x1, int c1,
                                   const float* inv, const float* shift,
                                   int pro_ns, const void* dy, const void* y,
                                   const float* ds, const float* dq,
                                   int st_ns, int cout, float* dw, float* db,
                                   int n, int d, int h, int wd, int kd,
                                   int act, void* stream) {
  WgradArgs a = {};
  a.x[0] = x0;
  a.x[1] = x1;
  a.cin[0] = c0;
  a.cin[1] = nin > 1 ? c1 : 0;
  a.nin = nin;
  a.groups0 = (c0 + WCI - 1) / WCI;
  a.inv = inv;
  a.shift = shift;
  a.pro_ns = pro_ns;
  a.dy = dy;
  a.y = y;
  a.ds = ds;
  a.dq = dq;
  a.st_ns = ds != nullptr ? st_ns : 0;
  a.dw = dw;
  a.db = db;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cout = cout;
  a.kd = kd;
  a.act = act;
  return launch_wgrad(a, dtype, stream);
}

// K5 of the vup merge conv: input 0 is the recomputed upconv output of
// the carry (cu channels), input 1 the skip (cs); kd = 1. The per-sample
// mode: ``pro_ns`` (cu + cs), ``cc_ns`` (cc) and ``st_ns`` (cout) for the
// (n, .) rows of the merge's prologue, the carry's and ds, dq, on the
// per-sample instantiations; dW and db stay global.
extern "C" int e3_conv_vup_wgrad(int dtype, const void* carry, int cc,
                                 const float* invc, const float* shiftc,
                                 int cc_ns, const float* wu, const float* bu,
                                 int cu, int actc, const void* skip, int cs,
                                 const float* inv, const float* shift,
                                 int pro_ns, const void* dy, const void* y,
                                 const float* ds, const float* dq,
                                 int st_ns, int cout, float* dw, float* db,
                                 int n, int d, int h, int wd, int act,
                                 void* stream) {
  WgradVupArgs a = {};
  a.x[1] = skip;
  a.cin[0] = cu;
  a.cin[1] = cs;
  a.nin = 2;
  a.groups0 = (cu + WCI - 1) / WCI;
  a.inv = inv;
  a.shift = shift;
  a.dy = dy;
  a.y = y;
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
  a.vup = vup_args(carry, cc, invc, shiftc, wu, bu, cu, actc);
  a.pro_ns = pro_ns;
  a.st_ns = ds != nullptr ? st_ns : 0;
  a.vup_ns = cc_ns;
  if (pro_ns == 0 && a.st_ns == 0 && cc_ns == 0)
    return launch_wgrad(a, dtype, stream);
  return launch_wgrad<WgradVupArgs, true>(a, dtype, stream);
}
