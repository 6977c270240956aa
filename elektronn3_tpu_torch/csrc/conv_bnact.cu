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
// kernel.
//
// This entry runs the CUDA-core body (float32, and the network input's
// C_in of 1 or 3); bfloat16 with every C_in a multiple of 16 runs
// e3_conv_bnact_tc (conv_tc.cu, the tensor cores), as the wrapper's
// conv_body picks. What bounds the CUDA-core body on the card: its
// float32 FMAs (67 TFLOP/s on the H100); the statistics add two FMAs
// per stored value and one atomic per channel and block.
#include "conv_bnact.cuh"
#include "ps_reduce.cuh"

// The per-sample mode's partial rows a sample (ps_reduce.cuh): its d
// planes' tiles of TH x TW.
extern "C" int64_t e3_conv_bnact_ps_parts(int d, int h, int wd) {
  return (int64_t)d * ((h + TH - 1) / TH) * ((wd + TW - 1) / TW);
}

// The per-sample mode (group and instance norm): ``pro_ns`` is c0 + c1
// for prologue rows of (n, c0 + c1) (``inv1``/``shift1`` pointing c0
// floats into them; 0 for the batch form); a workspace ``ws``
// (ps_workspace_floats of n samples, e3_conv_bnact_ps_parts rows of 2
// cout) gives each sample's statistics in ``s`` as (n, 2, cout), summed
// in a fixed order (``q`` unused).
extern "C" int e3_conv_bnact(int dtype, int nin,
                             const void* x0, int c0, const float* inv0,
                             const float* shift0,
                             const void* x1, int c1, const float* inv1,
                             const float* shift1, int pro_ns,
                             const float* wt, const float* bias, void* y,
                             float* s, float* q, float* ws,
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = launch_conv_body<false>(a, dtype, st);
  if (rc == 0 && ws != nullptr)
    rc = static_cast<int>(ps_reduce(ws, n, e3_conv_bnact_ps_parts(d, h, wd),
                                    2 * cout, s, st));
  return rc;
}
