// The vup merge conv: the decoder merge conv of a C=32 planar level
// whose input 0, the (1, 2, 2) upconv of the deeper level's C=64 carry,
// is never stored. K1's and K4's CUDA-core bodies (conv_bnact.cuh) with
// VUP = true recompute it per staged voxel from the carry (upconv_value8,
// upconv_vup.cuh). They run float32, and bf16 where vup.vup_body names
// the CUDA-core bodies; bf16 at the shapes of the tensor-core bodies runs
// conv_tc.cu's e3_conv_vup_tc (the forward) and conv_vup_tc.cu's
// e3_conv_vup_dgrad_tc (the input gradients and the chain, E kept on the
// chip) instead:
//
// e3_conv_vup (forward): input 0's staged value is
//   act(u * inv0 + shift0) of the recomputed upconv output u, input 1
//   (the skip) loads as in K1; bias, store, optional statistics.
// e3_conv_vup_dgrad (the first half of the backward): K4 on dy_tot with
//   the flipped, transposed weights; for the skip the epilogue is K4's
//   (dskip, dinv1, dshift1); for input 0 it recomputes u for act' and
//   dinv0 = sum(gm * u), dshift0 = sum(gm), and stores
//   E = round(gm * inv0), the upconv output's cotangent rounded to the
//   activation dtype, into a scratch of the upconv output's shape. The
//   chain from E into the carry runs in e3_conv_vup_chain
//   (upconv_bnact.cu); the upconv bias gradient sum(gm * inv0) is
//   inv0 * dshift0, formed by the wrapper. The merge conv's dW and db
//   are e3_conv_vup_wgrad (conv_bnact_bwd.cu).
//
// Replaces this TPU kernel of the JAX package:
//   ops/flat_fused.py::conv_bnact_flat_vup (_fused_conv_kernel's vup
//     mode, _vup_scratch) and the dgrad half of _conv_vup_bwd
//     (_fused_conv_bwd_kernel's vup mode).
// JAX chains E into the carry inside its one backward kernel; here the
// chain is a second kernel, so E passes through device memory once
// (written here, read there).
//
// What bounds these bodies on the card: arithmetic on the CUDA cores, as
// for K1 and K4, plus the recompute: 2 * 64 * 32 FLOP per staged voxel
// (the upconv's own work, about 1.3 times over for the halo), with the
// carry and the upconv weights read through L1.
//
// The per-sample mode (group and instance norm; JAX's per-sample vup
// kernels, flat_fused.py:968): every prologue vector and statistics
// cotangent is an (n, C) row read at its sample stride (``pro_ns`` for
// the merge's (n, cu + cs), ``cc_ns`` for the carry's (n, cc), ``st_ns``
// for ds, dq), on instantiations of their own (VPS), and the statistics
// (forward) or dinv and dshift (dgrad) come per sample from the blocks'
// partial rows in a workspace ``ws``, summed by ps_reduce in a fixed
// order (a block is one (n, depth) plane's tile). The chain's dinvc and
// dshiftc are K7's per-sample ones (e3_conv_vup_chain).
#include "conv_bnact.cuh"
#include "ps_reduce.cuh"

namespace {

// The blocks of a sample: its d planes' tiles (e3_conv_bnact_ps_parts).
int64_t vup_ps_parts(int d, int h, int wd) {
  return (int64_t)d * ((h + TH - 1) / TH) * ((wd + TW - 1) / TW);
}

}  // namespace

// The forward. Per sample (``pro_ns``, ``cc_ns`` or ``ws`` given): the
// (n, .) rows as above, ``inv1``/``shift1`` pointing cu floats into the
// merge's rows, and with ``ws`` the statistics (n, 2, cout) in ``s``
// (``q`` unused), as e3_conv_bnact's.
extern "C" int e3_conv_vup(int dtype, const void* carry, int cc,
                           const float* invc, const float* shiftc,
                           int cc_ns, const float* wu, const float* bu,
                           int cu, int actc, const void* skip, int cs,
                           const float* inv0, const float* shift0,
                           const float* inv1, const float* shift1,
                           int pro_ns, const float* wt, const float* bias,
                           void* y, float* s, float* q, float* ws, int n,
                           int d, int h, int wd, int cout, int act,
                           void* stream) {
  ConvArgs a = {};
  a.x[1] = skip;
  a.inv[0] = inv0;
  a.inv[1] = inv1;
  a.shift[0] = shift0;
  a.shift[1] = shift1;
  a.cin[0] = cu;
  a.cin[1] = cs;
  a.nin = 2;
  a.wt = wt;
  a.bias = bias;
  a.y = y;
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
  a.vup = vup_args(carry, cc, invc, shiftc, wu, bu, cu, actc);
  a.vup_ns = cc_ns;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pro_ns == 0 && cc_ns == 0 && ws == nullptr)
    return launch_conv_body<false, true>(a, dtype, st);
  int rc = launch_conv_body<false, true, true>(a, dtype, st);
  if (rc == 0 && ws != nullptr)
    rc = static_cast<int>(ps_reduce(ws, n, vup_ps_parts(d, h, wd),
                                    2 * cout, s, st));
  return rc;
}

// The dgrad. Per sample: ds, dq rows at ``st_ns``, the merge's prologue
// at ``pro_ns``, the carry's at ``cc_ns``, and with ``ws`` dinv and
// dshift per sample as (n, 2, cu + cs) in ``dinv`` (``dshift`` unused).
extern "C" int e3_conv_vup_dgrad(int dtype, const void* dy, const void* y,
                                 const float* ds, const float* dq,
                                 int st_ns, int cdy, const float* wt,
                                 const void* carry, int cc,
                                 const float* invc, const float* shiftc,
                                 int cc_ns, const float* wu, const float* bu,
                                 int cu, int actc, const void* skip, int cs,
                                 const float* inv, const float* shift,
                                 int pro_ns, void* e, void* dskip,
                                 float* dinv, float* dshift, float* ws,
                                 int n, int d, int h, int wd, int act,
                                 void* stream) {
  ConvArgs a = {};
  a.x[0] = dy;
  a.cin[0] = cdy;
  a.nin = 1;
  a.yv = y;
  a.ds = ds;
  a.dq = dq;
  a.st_ns = ds != nullptr ? st_ns : 0;
  a.pro_ns = pro_ns;
  a.part = ws;
  a.wt = wt;
  a.xe[1] = skip;
  a.ce[0] = cu;
  a.ce[1] = cs;
  a.einv = inv;
  a.eshift = shift;
  a.dx[0] = e;
  a.dx[1] = dskip;
  a.dinv = dinv;
  a.dshift = dshift;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cout = cu + cs;
  a.kd = 1;
  a.act = act;
  a.vup = vup_args(carry, cc, invc, shiftc, wu, bu, cu, actc);
  a.vup_ns = cc_ns;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.st_ns == 0 && pro_ns == 0 && cc_ns == 0 && ws == nullptr)
    return launch_conv_body<true, true>(a, dtype, st);
  int rc = launch_conv_body<true, true, true>(a, dtype, st);
  if (rc == 0 && ws != nullptr)
    rc = static_cast<int>(ps_reduce(ws, n, vup_ps_parts(d, h, wd),
                                    2 * (cu + cs), dinv, st));
  return rc;
}
