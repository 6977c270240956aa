// K8-K11: the standalone batch norm of the 'batchp' normalization, on a
// channels-last activation seen as rows: x is (R, C), channels minor,
// R = N * D * H * W, in float32 or bfloat16, C % 8 == 0.
//
//   K8  bn_stats       per-channel float32 (sum x, sum x^2) over the rows
//   K9  bn_normalize   y = x * scale + shift in float32, rounded once to
//                      x's dtype
//   K10 bn_bwd_reduce  per-channel float32 (sum g, sum g * xhat) with
//                      xhat = (x - mean) * inv
//   K11 bn_bwd_dx      dx = a * g + b * x + c in float32, rounded once to
//                      g's dtype
//
// Replaces these TPU kernels of the JAX package (ops/pallas_bn.py):
//   K8  _bn_stats      (_stats_kernel)
//   K9  _bn_normalize  (_normalize_kernel; also batch_norm_inference)
//   K10 _bn_bwd        (_bwd_reduce_kernel)
//   K11 _bn_bwd        (_bwd_dx_kernel)
// The per-channel glue between them (mean, the clamped variance, inv,
// the folded scale and shift, the backward's a, b, c) stays in PyTorch on
// C-vectors, as JAX keeps it in XLA between its pallas_calls.
//
// What bounds them on the card: device-memory bandwidth. Each reads its
// (R, C) operands once (K8 one, K10 two) and K9/K11 write one; the
// arithmetic is a few float32 operations per element. Every thread moves
// 8 channels as one 16-byte vector (two for float32), and a warp's lanes
// walk neighbouring vectors of consecutive rows: at C = 32 a bfloat16 row
// is 64 bytes, 4 threads, so a warp reads 8 rows at once.
//
// The reductions (K8, K10) use no float atomics: each block sums a fixed
// range of rows into float32 partials (nblocks, 2, C), in a fixed order
// (each thread over its rows, then the block's threads in shared memory),
// and a second kernel sums the partials over the blocks in block order.
// The block plan is a function of (R, C) alone (the wrapper computes it),
// so the sums are the same bits on every run and every card. There is no
// padding of R to a tile (the TPU kernels' 1024-row tiles): each thread
// stops at the last row.
//
// Rounding: K9 and K11 multiply and add with separate roundings, in the
// plain PyTorch version's order, so the two give the same float32 value
// before the one rounding to the output dtype. xhat in K10 likewise.
#include "common.cuh"

namespace {

using namespace e3;

constexpr int kThreads = 256;   // threads of a reduction block, at most

// Per-row (v1, v2) pairs that a reduction sums: K8 (x, x^2), K10
// (g, g * xhat).
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads) bn_reduce_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ inv,
    float* __restrict__ partial, int64_t rows, int c, int rows_per_block) {
  extern __shared__ float s_red[];             // [2][rpp][c], <= 16 KB
  const int cg = c / 8;
  const int rpp = blockDim.x / cg;             // rows a block reads at once
  const int grp = threadIdx.x % cg;
  const int sub = threadIdx.x / cg;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  int64_t r1 = r0 + rows_per_block;
  if (r1 > rows) r1 = rows;
  float m[8], iv[8], a1[8], a2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a1[j] = 0.0f;
    a2[j] = 0.0f;
    if constexpr (kBwd) {
      m[j] = mean[grp * 8 + j];
      iv[j] = inv[grp * 8 + j];
    }
  }
#pragma unroll 4
  for (int64_t r = r0 + sub; r < r1; r += rpp) {
    float v[8];
    load8(x + r * c + grp * 8, v);
    if constexpr (kBwd) {
      float gv[8];
      load8(g + r * c + grp * 8, gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xhat = __fmul_rn(__fsub_rn(v[j], m[j]), iv[j]);
        a1[j] += gv[j];
        a2[j] = fmaf(gv[j], xhat, a2[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a1[j] += v[j];
        a2[j] = fmaf(v[j], v[j], a2[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s_red[(0 * rpp + sub) * c + grp * 8 + j] = a1[j];
    s_red[(1 * rpp + sub) * c + grp * 8 + j] = a2[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * c; i += blockDim.x) {
    const int k = i / c;
    const int ch = i % c;
    float t = 0.0f;
    for (int s = 0; s < rpp; ++s) t += s_red[(k * rpp + s) * c + ch];
    partial[((int64_t)blockIdx.x * 2 + k) * c + ch] = t;
  }
}

// out[k][ch] = sum over blocks b, in order, of partial[b][k][ch].
__global__ void __launch_bounds__(kThreads) bn_reduce_final_kernel(
    const float* __restrict__ partial, float* __restrict__ out,
    int nblocks, int c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * c) return;
  float t = 0.0f;
  for (int b = 0; b < nblocks; ++b) t += partial[(int64_t)b * 2 * c + i];
  out[i] = t;
}

// K9 (kDx false): out = x * p1 + p2. K11 (kDx true): out = p1 * g +
// p2 * x + p3. One 8-channel vector per thread and step, grid-stride.
template <typename T, bool kDx>
__global__ void __launch_bounds__(kThreads) bn_affine_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ p1, const float* __restrict__ p2,
    const float* __restrict__ p3, T* __restrict__ out, int64_t rows, int c) {
  const int cg = c / 8;
  const int64_t total = rows * cg;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int c0 = (int)(idx % cg) * 8;
    float v[8], r[8];
    load8(x + idx * 8, v);
    if constexpr (kDx) {
      float gv[8];
      load8(g + idx * 8, gv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r[j] = __fadd_rn(__fadd_rn(__fmul_rn(p1[c0 + j], gv[j]),
                                   __fmul_rn(p2[c0 + j], v[j])),
                         p3[c0 + j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r[j] = __fadd_rn(__fmul_rn(v[j], p1[c0 + j]), p2[c0 + j]);
    }
    store8(out + idx * 8, r);
  }
}

int affine_blocks(int64_t total) {
  const int64_t want = (total + kThreads - 1) / kThreads;
  return (int)(want < (1 << 20) ? (want > 0 ? want : 1) : (1 << 20));
}

// Threads of a reduction block: c / 8 channel groups times the rows it
// reads at once, kThreads or a few fewer (c <= 8 * kThreads).
int reduce_threads(int c) {
  const int cg = c / 8;
  return cg * (kThreads / cg);
}

template <bool kBwd>
int reduce(int dtype, const void* x, const void* g, const float* mean,
           const float* inv, float* partial, float* out, int64_t rows,
           int c, int nblocks, int rows_per_block, void* stream) {
  if (c < 8 || c % 8 != 0 || c > 8 * kThreads || nblocks < 1 ||
      rows_per_block < 1 || (int64_t)nblocks * rows_per_block < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = reduce_threads(c);
  const size_t smem = sizeof(float) * 2 * (threads / (c / 8)) * c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    bn_reduce_partial_kernel<__nv_bfloat16, kBwd>
        <<<nblocks, threads, smem, s>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(g), mean, inv, partial, rows,
            c, rows_per_block);
  else
    bn_reduce_partial_kernel<float, kBwd><<<nblocks, threads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), mean,
        inv, partial, rows, c, rows_per_block);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bn_reduce_final_kernel<<<(2 * c + kThreads - 1) / kThreads, kThreads, 0,
                           s>>>(partial, out, nblocks, c);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDx>
int affine(int dtype, const void* x, const void* g, const float* p1,
           const float* p2, const float* p3, void* out, int64_t rows, int c,
           void* stream) {
  if (c < 8 || c % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = affine_blocks(rows * (c / 8));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    bn_affine_kernel<__nv_bfloat16, kDx><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), p1, p2, p3,
        static_cast<__nv_bfloat16*>(out), rows, c);
  else
    bn_affine_kernel<float, kDx><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), p1, p2,
        p3, static_cast<float*>(out), rows, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8: sums[0][ch] = sum x, sums[1][ch] = sum x^2 over the rows. partial
// is (nblocks, 2, c) float32 scratch; block b sums rows
// [b * rows_per_block, (b + 1) * rows_per_block).
extern "C" int e3_bn_stats(int dtype, const void* x, float* partial,
                           float* sums, int64_t rows, int c, int nblocks,
                           int rows_per_block, void* stream) {
  return reduce<false>(dtype, x, nullptr, nullptr, nullptr, partial, sums,
                       rows, c, nblocks, rows_per_block, stream);
}

// K9: y = x * scale + shift.
extern "C" int e3_bn_normalize(int dtype, const void* x, const float* scale,
                               const float* shift, void* y, int64_t rows,
                               int c, void* stream) {
  return affine<false>(dtype, x, nullptr, scale, shift, nullptr, y, rows, c,
                       stream);
}

// K10: sums[0][ch] = sum g, sums[1][ch] = sum g * (x - mean) * inv.
extern "C" int e3_bn_bwd_reduce(int dtype, const void* g, const void* x,
                                const float* mean, const float* inv,
                                float* partial, float* sums, int64_t rows,
                                int c, int nblocks, int rows_per_block,
                                void* stream) {
  return reduce<true>(dtype, x, g, mean, inv, partial, sums, rows, c,
                      nblocks, rows_per_block, stream);
}

// K11: dx = a * g + b * x + c (per channel a, b, c).
extern "C" int e3_bn_bwd_dx(int dtype, const void* g, const void* x,
                            const float* a, const float* b, const float* cc,
                            void* dx, int64_t rows, int c, void* stream) {
  return affine<true>(dtype, x, g, a, b, cc, dx, rows, c, stream);
}
