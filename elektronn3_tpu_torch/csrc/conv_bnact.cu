// K1 conv_bnact: prologue (BN-apply + activation) on load, then a
// (kd, 3, 3) 'same' convolution over a list of one or two NDHWC inputs,
// plus bias, with optional batch statistics of the stored output
// (per-channel sum and sum of squares of the dtype-rounded value).
// float32 accumulation; output stored in the activation dtype. The
// bodies are in conv_bnact.cuh (shared with K4's input gradient).
//
// Replaces these TPU kernels of the JAX package:
//   ops/flat_fused.py::conv_bnact_flat      (_fused_conv_kernel)
//   ops/flat_fused.py::conv1_bnstats_flat   (_conv1_fwd_kernel)
//   ops/flat_fused64.py::conv3_bnact_flat64 (_conv64_fwd_kernel)
// The three differ on the TPU only in lane packing (32 or 64 channels
// per 128-lane row, a one-channel input in lanes); on NDHWC they are one
// kernel. The statistics are reduced from the values the epilogue
// stores, not from the WMMA fragments (whose layout is opaque).
//
// What bounds it on the card: arithmetic. The headline convs do 0.3 to
// 2 KFLOP per byte moved, far above the H100's ridge, hence the
// tensor-core body for bf16; the statistics add two FMAs per stored
// value and one atomic per channel and block.
#include "conv_bnact.cuh"

extern "C" int e3_conv_bnact(int dtype, int nin,
                             const void* x0, int c0, const float* inv0,
                             const float* shift0,
                             const void* x1, int c1, const float* inv1,
                             const float* shift1,
                             const float* wt, const float* bias, void* y,
                             float* s, float* q,
                             int n, int d, int h, int wd, int cout, int kd,
                             int act, void* stream) {
  ConvArgs a = {};
  a.x[0] = x0;
  a.x[1] = x1;
  a.inv[0] = inv0;
  a.inv[1] = inv1;
  a.shift[0] = shift0;
  a.shift[1] = shift1;
  a.cin[0] = c0;
  a.cin[1] = nin > 1 ? c1 : 0;
  a.nin = nin;
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
  a.kd = kd;
  a.act = act;
  return launch_conv_body<false>(a, dtype, static_cast<cudaStream_t>(stream));
}
