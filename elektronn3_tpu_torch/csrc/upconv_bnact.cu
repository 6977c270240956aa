// K3 upconv_bnact: transposed convolution whose kernel equals its
// stride, (1, 2, 2) or (2, 2, 2), with an optional prologue (BN-apply +
// activation of the deeper level's raw output) on load. Each output
// voxel (kd*d + a, 2h + b, 2w + c) is
//     bias + sum_ci act(x[d, h, w, ci] * inv + shift) * W[a, b, c, ci, co],
// float32 accumulation, stored in the activation dtype. W is in the
// port's (a, b, c, ci, co) order, i.e. torch ConvTranspose taps.
//
// Replaces these TPU kernels of the JAX package:
//   ops/flat_fused64.py::upconv222_bn_flat64   (_upconv64_fwd_kernel)
//   ops/flat_fused64.py::upconv122_from_flat64 (_upconv122_f64_fwd_kernel)
//
// What bounds it on the card: device-memory bandwidth for the output
// (kd*4 output voxels per input voxel, cout <= cin) at 32 to 128 FLOP
// per byte; the arithmetic is small. One warp owns one sub-position
// (a, b, c), so the shared-memory weight reads are broadcasts, and each
// staged (prologued) input value serves every sub-position and 32
// output channels.
#include "common.cuh"

namespace {

using namespace e3;

constexpr int UCK = 16;  // input channels staged per step
constexpr int COG = 32;  // output channels per block
constexpr int NT = 256;  // threads per block: 8 warps
constexpr int VMAX = 64; // most input voxels per block (kd == 1)

struct UpArgs {
  const void* x;      // (n, d, h, w, cin)
  const float* inv;   // (cin,)
  const float* shift; // (cin,)
  const float* wt;    // (kd, 2, 2, cin, cout), float32
  const float* bias;  // (cout,), float32
  void* y;            // (n, kd * d, 2 h, 2 w, cout)
  int n, d, h, wd, cin, cout, kd, act;
};

template <typename T>
__global__ void __launch_bounds__(NT) upconv_bnact_kernel(const UpArgs a) {
  __shared__ float s_in[UCK][VMAX];
  __shared__ __align__(16) float s_w[8][UCK][COG];

  const int nsub = a.kd * 4;          // 8 or 4 sub-positions
  const int vpb = 32 * (8 / nsub);    // 32 or 64 input voxels per block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = warp % nsub;
  const int vl = (warp / nsub) * 32 + lane;
  const int64_t total = (int64_t)a.n * a.d * a.h * a.wd;
  const int64_t v0 = (int64_t)blockIdx.x * vpb;
  const int co0 = blockIdx.y * COG;
  const T* x = static_cast<const T*>(a.x);

  float acc[COG];
#pragma unroll
  for (int o = 0; o < COG; ++o) acc[o] = 0.0f;

  for (int cb = 0; cb < a.cin; cb += UCK) {
    __syncthreads();
    for (int p = threadIdx.x; p < vpb * (UCK / 8); p += NT) {
      const int pv = p / (UCK / 8);
      const int g = p % (UCK / 8);
      const int64_t v = v0 + pv;
      float vals[8];
      if (v < total) {
        load8(x + v * a.cin + cb + g * 8, vals);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = cb + g * 8 + j;
          vals[j] = round_to<T>(prologue(vals[j], a.inv[c], a.shift[c],
                                         a.act));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) vals[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s_in[g * 8 + j][pv] = vals[j];
    }
    for (int q = threadIdx.x; q < nsub * UCK * COG; q += NT) {
      const int o = q % COG;
      const int c = (q / COG) % UCK;
      const int s = q / (COG * UCK);
      s_w[s][c][o] = a.wt[((int64_t)s * a.cin + cb + c) * a.cout + co0 + o];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < UCK; ++c) {
      const float av = s_in[c][vl];
      const float4* wr = reinterpret_cast<const float4*>(&s_w[sub][c][0]);
#pragma unroll
      for (int q = 0; q < COG / 4; ++q) {
        const float4 wv = wr[q];
        acc[4 * q + 0] = fmaf(av, wv.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(av, wv.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(av, wv.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(av, wv.w, acc[4 * q + 3]);
      }
    }
  }

  const int64_t v = v0 + vl;
  if (v >= total) return;
  const int ww = (int)(v % a.wd);
  int64_t t = v / a.wd;
  const int hh = (int)(t % a.h);
  const int64_t nd = t / a.h;
  const int64_t nn = nd / a.d;
  const int dd = (int)(nd % a.d);
  const int pa = sub / 4;        // depth phase (0 when kd == 1)
  const int pb = (sub / 2) % 2;  // row phase
  const int pc = sub % 2;        // column phase
  const int64_t opos =
      ((nn * (a.d * a.kd) + dd * a.kd + pa) * (2 * a.h) + 2 * hh + pb)
          * (2 * a.wd) + 2 * ww + pc;
  T* dst = static_cast<T*>(a.y) + opos * a.cout + co0;
#pragma unroll
  for (int q = 0; q < COG / 8; ++q) {
    float r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = acc[8 * q + j] + a.bias[co0 + 8 * q + j];
    store8(dst + 8 * q, r);
  }
}

}  // namespace

extern "C" int e3_upconv_bnact(int dtype, const void* x, const float* inv,
                               const float* shift, const float* wt,
                               const float* bias, void* y, int n, int d,
                               int h, int wd, int cin, int cout, int kd,
                               int act, void* stream) {
  UpArgs a;
  a.x = x;
  a.inv = inv;
  a.shift = shift;
  a.wt = wt;
  a.bias = bias;
  a.y = y;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  a.kd = kd;
  a.act = act;
  const int vpb = 32 * (8 / (kd * 4));
  const int64_t total = (int64_t)n * d * h * wd;
  const dim3 grid((unsigned)((total + vpb - 1) / vpb), cout / COG);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == e3::DT_BF16)
    upconv_bnact_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(a);
  else
    upconv_bnact_kernel<float><<<grid, NT, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
