// K1 conv_bnact: prologue (BN-apply + activation) on load, then a
// (kd, 3, 3) 'same' convolution over a list of one or two NDHWC inputs
// (the decoder's concat merge is the list; the concat never exists in
// memory), plus bias. float32 accumulation; output stored in the
// activation dtype.
//
// Replaces these TPU kernels of the JAX package:
//   ops/flat_fused.py::conv_bnact_flat      (_fused_conv_kernel)
//   ops/flat_fused.py::conv1_bnstats_flat   (_conv1_fwd_kernel)
//   ops/flat_fused64.py::conv3_bnact_flat64 (_conv64_fwd_kernel)
// The three differ on the TPU only in lane packing (32 or 64 channels
// per 128-lane row, a one-channel input in lanes); on NDHWC they are one
// kernel. Statistics side outputs (training) are not part of this
// kernel yet.
//
// What bounds it on the card: arithmetic. The headline convs do 0.3 to
// 2 KFLOP per byte moved, far above the H100's ridge. Two bodies:
//   - bfloat16 with every C_in a multiple of 16 (all but the first conv
//     of the headline model) runs on the tensor cores: an implicit GEMM
//     over taps x 16-channel steps with WMMA 16x16x16 bf16 fragments and
//     float32 accumulators. The prologued operand is staged in shared
//     memory as bf16, which is exactly the rounding the JAX kernels
//     apply before their matmuls.
//   - float32, and C_in = 1, run on the CUDA cores: each shared-memory
//     weight read (a warp-wide broadcast of 4 output channels) serves 2
//     output rows, and each staged input value 9 taps and 32 output
//     channels.
// In both the prologue runs once per staged value, not per tap.
//
// Semantics that hold here as in the JAX kernels:
//   - zero padding is applied AFTER the prologue (a halo voxel is 0,
//     not act(0 * inv + shift));
//   - the prologued operand is rounded to the activation dtype before
//     the multiply; the weights arrive already rounded to that dtype;
//   - the bias is added in float32 before the single rounding of the
//     stored output.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace e3;

constexpr int TW = 32;          // output columns per block (one warp row)
constexpr int TYR = 8;          // thread rows per block
constexpr int RPT = 2;          // output rows per thread
constexpr int TH = TYR * RPT;   // output rows per block
constexpr int CK = 8;           // input channels staged per step
constexpr int COG = 32;         // output channels per block
constexpr int HH = TH + 2;      // staged rows (with halo)
constexpr int HW = TW + 2;      // staged columns (with halo)
constexpr int NT = TW * TYR;    // threads per block

struct ConvArgs {
  const void* x[2];
  const float* inv[2];
  const float* shift[2];
  int cin[2];
  int nin;
  const float* wt;    // (kd, 3, 3, cin[0] + cin[1], cout), float32
  const float* bias;  // (cout,), float32
  void* y;            // (n, d, h, w, cout)
  int n, d, h, wd, cout, kd, act;
};

template <typename T>
__global__ void __launch_bounds__(NT) conv_bnact_kernel(const ConvArgs a) {
  __shared__ float s_in[CK][HH][HW];
  __shared__ __align__(16) float s_w[9][CK][COG];

  const int tx = threadIdx.x % TW;
  const int ty = threadIdx.x / TW;
  const int tiles_w = (a.wd + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int nd = blockIdx.y;  // n * d + depth index
  const int n = nd / a.d;
  const int d = nd % a.d;
  const int co0 = blockIdx.z * COG;
  const int ct = a.cin[0] + a.cin[1];

  float acc[RPT][COG];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int o = 0; o < COG; ++o) acc[r][o] = 0.0f;

  int coff = 0;  // first weight input channel of input i
  for (int i = 0; i < a.nin; ++i) {
    const T* x = static_cast<const T*>(a.x[i]);
    const float* inv = a.inv[i];
    const float* shift = a.shift[i];
    const int ci = a.cin[i];
    for (int dz = 0; dz < a.kd; ++dz) {
      const int zd = d + dz - a.kd / 2;
      if (zd < 0 || zd >= a.d) continue;  // zero padding in depth
      const int64_t plane = (int64_t)(n * a.d + zd) * a.h;
      for (int cb = 0; cb < ci; cb += CK) {
        __syncthreads();  // the previous step's reads are done
        for (int p = threadIdx.x; p < HH * HW; p += NT) {
          const int hy = p / HW;
          const int hx = p % HW;
          const int gh = h0 + hy - 1;
          const int gw = w0 + hx - 1;
          float v[CK];
          if (gh >= 0 && gh < a.h && gw >= 0 && gw < a.wd) {
            const T* src = x + ((plane + gh) * a.wd + gw) * ci + cb;
            if (ci % CK == 0) {
              load8(src, v);
            } else {
#pragma unroll
              for (int c = 0; c < CK; ++c)
                v[c] = (cb + c < ci) ? to_f(src[c]) : 0.0f;
            }
#pragma unroll
            for (int c = 0; c < CK; ++c)
              v[c] = (cb + c < ci)
                  ? round_to<T>(prologue(v[c], inv[cb + c],
                                         shift[cb + c], a.act))
                  : 0.0f;
          } else {
#pragma unroll
            for (int c = 0; c < CK; ++c) v[c] = 0.0f;
          }
#pragma unroll
          for (int c = 0; c < CK; ++c) s_in[c][hy][hx] = v[c];
        }
        for (int q = threadIdx.x; q < 9 * CK * COG; q += NT) {
          const int o = q % COG;
          const int c = (q / COG) % CK;
          const int t = q / (COG * CK);
          s_w[t][c][o] = (cb + c < ci)
              ? a.wt[((int64_t)(dz * 9 + t) * ct + coff + cb + c) * a.cout
                    + co0 + o]
              : 0.0f;
        }
        __syncthreads();
#pragma unroll 1
        for (int t = 0; t < 9; ++t) {
          const int ky = t / 3;
          const int kx = t % 3;
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            float av[RPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r)
              av[r] = s_in[c][ty * RPT + r + ky][tx + kx];
            const float4* wr = reinterpret_cast<const float4*>(&s_w[t][c][0]);
#pragma unroll
            for (int q = 0; q < COG / 4; ++q) {
              const float4 wv = wr[q];
#pragma unroll
              for (int r = 0; r < RPT; ++r) {
                acc[r][4 * q + 0] = fmaf(av[r], wv.x, acc[r][4 * q + 0]);
                acc[r][4 * q + 1] = fmaf(av[r], wv.y, acc[r][4 * q + 1]);
                acc[r][4 * q + 2] = fmaf(av[r], wv.z, acc[r][4 * q + 2]);
                acc[r][4 * q + 3] = fmaf(av[r], wv.w, acc[r][4 * q + 3]);
              }
            }
          }
        }
      }
    }
    coff += ci;
  }

  const int w = w0 + tx;
  if (w >= a.wd) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int h = h0 + ty * RPT + r;
    if (h >= a.h) continue;
    T* dst = static_cast<T*>(a.y)
        + (((int64_t)nd * a.h + h) * a.wd + w) * a.cout + co0;
#pragma unroll
    for (int q = 0; q < COG / 8; ++q) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = acc[r][8 * q + j] + a.bias[co0 + 8 * q + j];
      store8(dst + 8 * q, v);
    }
  }
}

// Tensor-core body (bfloat16, C_in % 16 == 0). Block: 8 warps, one
// output row each, MW columns; a warp holds SEG x 2 accumulator
// fragments (16 voxels x 16 output channels each).
constexpr int MW = 64;              // output columns per block
constexpr int MH = 8;               // output rows per block (warps)
constexpr int MCK = 16;             // input channels per step (MMA depth)
constexpr int MHH = MH + 2;         // staged rows (with halo)
constexpr int MHW = MW + 2;         // staged columns (with halo)
constexpr int SEG = MW / 16;        // 16-voxel segments per warp

__global__ void __launch_bounds__(256) conv_bnact_mma_kernel(
    const ConvArgs a) {
  using namespace nvcuda;
  // Staged prologued input: position (row, col) holds MCK channels.
  __shared__ __align__(128) __nv_bfloat16 s_in[MHH * MHW * MCK];
  __shared__ __align__(128) __nv_bfloat16 s_w[9 * MCK * COG];
  __shared__ __align__(128) float s_out[MH][16 * 16];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles_w = (a.wd + MW - 1) / MW;
  const int h0 = (blockIdx.x / tiles_w) * MH;
  const int w0 = (blockIdx.x % tiles_w) * MW;
  const int nd = blockIdx.y;
  const int n = nd / a.d;
  const int d = nd % a.d;
  const int co0 = blockIdx.z * COG;
  const int ct = a.cin[0] + a.cin[1];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[SEG][2];
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    wmma::fill_fragment(acc[s][0], 0.0f);
    wmma::fill_fragment(acc[s][1], 0.0f);
  }

  int coff = 0;
  for (int i = 0; i < a.nin; ++i) {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x[i]);
    const float* inv = a.inv[i];
    const float* shift = a.shift[i];
    const int ci = a.cin[i];
    for (int dz = 0; dz < a.kd; ++dz) {
      const int zd = d + dz - a.kd / 2;
      if (zd < 0 || zd >= a.d) continue;  // zero padding in depth
      const int64_t plane = (int64_t)(n * a.d + zd) * a.h;
      for (int cb = 0; cb < ci; cb += MCK) {
        __syncthreads();  // the previous step's fragment loads are done
        for (int p = threadIdx.x; p < MHH * MHW; p += 256) {
          const int gh = h0 + p / MHW - 1;
          const int gw = w0 + p % MHW - 1;
          float v[MCK];
          if (gh >= 0 && gh < a.h && gw >= 0 && gw < a.wd) {
            const __nv_bfloat16* src =
                x + ((plane + gh) * a.wd + gw) * ci + cb;
            load8(src, v);
            load8(src + 8, v + 8);
#pragma unroll
            for (int c = 0; c < MCK; ++c)
              v[c] = prologue(v[c], inv[cb + c], shift[cb + c], a.act);
          } else {
#pragma unroll
            for (int c = 0; c < MCK; ++c) v[c] = 0.0f;
          }
          store8(&s_in[p * MCK], v);
          store8(&s_in[p * MCK + 8], v + 8);
        }
        // s_w[t][c][o], rounded exactly (the weights are bf16 values).
        for (int q = threadIdx.x; q < 9 * MCK * COG; q += 256) {
          const int o = q % COG;
          const int c = (q / COG) % MCK;
          const int t = q / (COG * MCK);
          s_w[q] = __float2bfloat16_rn(
              a.wt[((int64_t)(dz * 9 + t) * ct + coff + cb + c) * a.cout
                   + co0 + o]);
        }
        __syncthreads();
#pragma unroll 1
        for (int t = 0; t < 9; ++t) {
          const int ky = t / 3;
          const int kx = t % 3;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b0, b1;
          wmma::load_matrix_sync(b0, &s_w[t * MCK * COG], COG);
          wmma::load_matrix_sync(b1, &s_w[t * MCK * COG + 16], COG);
#pragma unroll
          for (int s = 0; s < SEG; ++s) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> af;
            wmma::load_matrix_sync(
                af, &s_in[((warp + ky) * MHW + s * 16 + kx) * MCK], MCK);
            wmma::mma_sync(acc[s][0], af, b0, acc[s][0]);
            wmma::mma_sync(acc[s][1], af, b1, acc[s][1]);
          }
        }
      }
    }
    coff += ci;
  }

  // Epilogue: each fragment goes through the warp's shared scratch;
  // lane l writes voxel l / 2, output channels (l % 2) * 8 .. + 8.
  const int h = h0 + warp;
  if (h >= a.h) return;
  const int vox = lane / 2;
  const int half = lane % 2;
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      wmma::store_matrix_sync(s_out[warp], acc[s][f], 16,
                              wmma::mem_row_major);
      __syncwarp();
      const int w = w0 + s * 16 + vox;
      if (w < a.wd) {
        const int o = co0 + f * 16 + half * 8;
        float r[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          r[j] = s_out[warp][vox * 16 + half * 8 + j] + a.bias[o + j];
        store8(static_cast<__nv_bfloat16*>(a.y)
                   + (((int64_t)nd * a.h + h) * a.wd + w) * a.cout + o, r);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int e3_conv_bnact(int dtype, int nin,
                             const void* x0, int c0, const float* inv0,
                             const float* shift0,
                             const void* x1, int c1, const float* inv1,
                             const float* shift1,
                             const float* wt, const float* bias, void* y,
                             int n, int d, int h, int wd, int cout, int kd,
                             int act, void* stream) {
  ConvArgs a;
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
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cout = cout;
  a.kd = kd;
  a.act = act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mma = dtype == e3::DT_BF16 && c0 % MCK == 0
      && (nin < 2 || c1 % MCK == 0);
  if (mma) {
    const int tiles = ((h + MH - 1) / MH) * ((wd + MW - 1) / MW);
    conv_bnact_mma_kernel<<<dim3(tiles, n * d, cout / COG), 256, 0, s>>>(a);
  } else {
    const int tiles = ((h + TH - 1) / TH) * ((wd + TW - 1) / TW);
    const dim3 grid(tiles, n * d, cout / COG);
    if (dtype == e3::DT_BF16)
      conv_bnact_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(a);
    else
      conv_bnact_kernel<float><<<grid, NT, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
