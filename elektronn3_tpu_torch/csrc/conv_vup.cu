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
#include "conv_bnact.cuh"

extern "C" int e3_conv_vup(int dtype, const void* carry, int cc,
                           const float* invc, const float* shiftc,
                           const float* wu, const float* bu, int cu,
                           int actc, const void* skip, int cs,
                           const float* inv0, const float* shift0,
                           const float* inv1, const float* shift1,
                           const float* wt, const float* bias, void* y,
                           float* s, float* q, int n, int d, int h, int wd,
                           int cout, int act, void* stream) {
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
  a.s = s;
  a.q = q;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cout = cout;
  a.kd = 1;
  a.act = act;
  a.vup = vup_args(carry, cc, invc, shiftc, wu, bu, cu, actc);
  return launch_conv_body<false, true>(a, dtype,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" int e3_conv_vup_dgrad(int dtype, const void* dy, const void* y,
                                 const float* ds, const float* dq, int cdy,
                                 const float* wt, const void* carry, int cc,
                                 const float* invc, const float* shiftc,
                                 const float* wu, const float* bu, int cu,
                                 int actc, const void* skip, int cs,
                                 const float* inv, const float* shift,
                                 void* e, void* dskip, float* dinv,
                                 float* dshift, int n, int d, int h, int wd,
                                 int act, void* stream) {
  ConvArgs a = {};
  a.x[0] = dy;
  a.cin[0] = cdy;
  a.nin = 1;
  a.yv = y;
  a.ds = ds;
  a.dq = dq;
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
  return launch_conv_body<true, true>(a, dtype,
                                      static_cast<cudaStream_t>(stream));
}
