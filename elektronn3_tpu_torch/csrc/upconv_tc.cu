// K3 upconv_bnact, bfloat16 body: the transposed convolution whose
// kernel equals its stride, (1, 2, 2) or (2, 2, 2), as one GEMM on the
// tensor cores,
//     Y[v, (a, b, c, co)] = act(X[v, :] * inv + shift) . W[:, (a, b, c, co)]
//                           + bias[co],
// M = the input voxels v, K = C_in, N = kd * 4 * C_out, the columns in
// (a, b, c, co) order. The function, its rounding points and its plain
// version are those of upconv_bnact.cu (which keeps the float32 body and
// K7): the prologued input is rounded to bf16 before the multiply, the
// sums are float32, the bias is added in float32 and the output rounded
// once; the statistics are the sums of the rounded output.
//
// Replaces, for bf16, the TPU kernels listed in upconv_bnact.cu.
//
// What bounds it on the card: at the headline shapes it does 64 to 256
// FLOP per byte it must move (the output, kd * 4 values per input
// value, dominates the bytes), near the H100's ridge (295 FLOP per byte
// in bf16), so both the tensor-core rate and the store rate matter. The
// design:
//   - a block takes BM = 64 consecutive input voxels and ALL N columns,
//     in slices of BN = 128; its input tile (64 x C_in bf16, at most
//     32 KB) is fetched once with cp.async and prologued in place once
//     per element (a template flag skips the pass for a dense input),
//     then stays in shared memory for every slice;
//   - the weights arrive packed by the wrapper, once per call, in bf16
//     as (C_in / 16, N, 16): each k16 step of a slice is one contiguous
//     4 KB run, streamed through a 3-stage cp.async ring (64 input
//     channels a stage), so the next stage's loads overlap this
//     stage's MMAs;
//   - 8 warps as 2 (M) x 4 (N), each a 32 x 32 tile of mma.sync
//     m16n8k16 products from ldmatrix fragments of swizzled tiles
//     (tc.cuh);
//   - the epilogue adds the bias, rounds, takes the statistics of the
//     rounded values from the accumulator registers (shuffles over the
//     lanes that share a column, then shared-memory atomics, then one
//     device atomic per channel and block), and stages the slice in
//     shared memory, from where the block stores each voxel's span of
//     output channels as 16-byte vectors: for a fixed (a, b), the
//     outputs of sub-positions c = 0, 1 of a voxel are one contiguous
//     run of 2 * C_out values in NDHWC.
// Voxels past the end of the input (a ragged last block) are masked in
// the stores and the statistics.
//
// The per-sample mode (group and instance norm): inv/shift are rows of
// (n, cin), one a sample. A block of 64 flattened voxels would straddle
// two samples wherever d * h * w is not a multiple of 64, so the grid is
// (blocks of a sample, sample) there: block (x, y) takes voxels x * 64 ..
// of sample y and stages that sample's prologue row once; a sample's last
// block is ragged. Its statistics are a partial row of sample y
// (ps_reduce.cuh): each warp adds its lanes' sums of every slice into a
// shared row of its own (the lanes of a warp hold distinct channels), and
// the block sums the 8 rows in order into slot x of sample y. The batch
// form keeps the one-dimensional grid and its atomics.
//
// mma.sync, not wgmma: it is a step that moves the kernel off the
// float32 CUDA cores with fragments whose layout this file controls
// (no shared-memory descriptors, no warpgroup-wide asynchrony to
// order), at the cost of the share of the tensor-core rate that only
// wgmma reaches. At these shapes the output bytes, not that rate, set
// the bound.
#include "ps_reduce.cuh"
#include "tc.cuh"

namespace {

using namespace e3;

constexpr int BM = 64;              // input voxels per block
constexpr int BN = 128;             // GEMM columns per slice
constexpr int BKC = 4;              // k16 steps per weight stage
constexpr int NSTAGE = 3;           // weight stages in flight
constexpr int NT = 256;             // 8 warps
constexpr int WARPS_M = BM / 32;    // warps over the rows, 32 rows each
constexpr int WNT = BN / (8 / WARPS_M) / 8;  // n8 tiles of a warp
constexpr int OPITCH = BN + 8;      // bf16 row pitch of the output tile
constexpr int BSTAGE = BKC * BN * 32;   // bytes of one weight stage

struct UpTcArgs {
  const __nv_bfloat16* x;    // (n, d, h, w, cin)
  const float* inv;          // (cin,), or null (dense input)
  const float* shift;
  const __nv_bfloat16* wp;   // (cin / 16, N, 16) packed weights
  const float* bias;         // (cout,) float32
  __nv_bfloat16* y;          // (n, kd * d, 2 h, 2 w, cout)
  float* s;                  // (cout,) statistics, or null
  float* q;
  int n, d, h, wd, cin, cout, kd, act;
  // The per-sample mode: the sample stride of inv/shift (cin), the
  // statistics' partial rows (n, blocks of a sample, 2 cout) in place of
  // s and q (or null), and the voxels of a sample (d * h * w), which
  // selects the (block of a sample, sample) grid; 0 and null for the
  // batch form.
  int pro_ns;
  float* part;
  int64_t spv;
};

// Shared-memory bytes of a block: the input tile, the weight ring, the
// output tile, the output voxel of each row, the statistics' block sums,
// the prologue vectors and, per sample, the warps' rows of sums.
size_t up_tc_smem(int cin, int cout, bool ps) {
  return (size_t)BM * cin * 2 + (size_t)NSTAGE * BSTAGE
      + (size_t)BM * OPITCH * 2 + (size_t)BM * 8 + (size_t)2 * cout * 4
      + (size_t)2 * cin * 4 + (ps ? (size_t)(NT / 32) * 2 * cout * 4 : 0);
}

template <bool PRO, bool ST>
__global__ void __launch_bounds__(NT) upconv_tc_kernel(const UpTcArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kc_n = a.cin / 16;                 // k16 steps
  const int ncol = a.kd * 4 * a.cout;          // N
  unsigned char* s_a = smem;                   // [kc][BM rows], swizzled
  unsigned char* s_b = s_a + BM * a.cin * 2;   // NSTAGE x [BKC][BN rows]
  __nv_bfloat16* s_o = reinterpret_cast<__nv_bfloat16*>(
      s_b + NSTAGE * BSTAGE);                  // [BM][OPITCH]
  int64_t* s_obase = reinterpret_cast<int64_t*>(s_o + BM * OPITCH);
  float* s_red = reinterpret_cast<float*>(s_obase + BM);   // [2][cout]
  float* s_inv = s_red + 2 * a.cout;                       // [cin]
  float* s_shift = s_inv + a.cin;
  float* s_wred = s_shift + a.cin;             // per sample: [8][2][cout]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % WARPS_M;               // warp's 32-row band
  const int wn = warp / WARPS_M;               // warp's column band
  // The end of the block's voxels (of its sample in the per-sample
  // grid) and its first voxel.
  const int64_t vbase = blockIdx.y * a.spv;
  const int64_t total = a.spv ? vbase + a.spv
                              : (int64_t)a.n * a.d * a.h * a.wd;
  const int64_t v0 = vbase + (int64_t)blockIdx.x * BM;
  const int groups = (kc_n + BKC - 1) / BKC;   // weight stages a slice
  const int nstages = (ncol / BN) * groups;
  const int64_t ostride_b = 2 * (int64_t)a.wd;           // one output row
  const int64_t ostride_a = 2 * (int64_t)a.h * ostride_b;  // one plane

  // Output voxel of sub-position (0, 0, 0) of each input voxel.
  if (tid < BM) {
    const int64_t v = v0 + tid;
    int64_t base = -1;
    if (v < total) {
      const int ww = (int)(v % a.wd);
      const int64_t t = v / a.wd;
      const int hh = (int)(t % a.h);
      const int64_t nd = t / a.h;
      base = ((nd / a.d) * (a.d * a.kd) + (nd % a.d) * a.kd) * ostride_a
          + 2 * (int64_t)hh * ostride_b + 2 * ww;
    }
    s_obase[tid] = base;
  }
  if (ST)
    for (int c = tid; c < 2 * a.cout; c += NT) s_red[c] = 0.0f;
  if (ST && a.part != nullptr)
    for (int c = tid; c < (NT / 32) * 2 * a.cout; c += NT) s_wred[c] = 0.0f;
  if (PRO)
    for (int c = tid; c < a.cin; c += NT) {
      s_inv[c] = a.inv[blockIdx.y * a.pro_ns + c];
      s_shift[c] = a.shift[blockIdx.y * a.pro_ns + c];
    }

  // The input tile, every k16 step: row r, half hf of step kc.
  for (int i = tid; i < BM * kc_n * 2; i += NT) {
    const int r = i / (kc_n * 2);
    const int kc = (i / 2) % kc_n;
    const int hf = i % 2;
    const int64_t v = v0 + r;
    const bool ok = v < total;
    cp_async16(smem_u32(s_a + kc * (BM * 32) + swz(r, hf)),
               ok ? a.x + v * a.cin + kc * 16 + hf * 8 : a.x, ok);
  }
  cp_async_commit();

  // Weight stage st: slice st / groups, k16 steps of group st % groups.
  auto load_b = [&](int st) {
    if (st < nstages) {
      const int j = st / groups;
      const int kc0 = (st % groups) * BKC;
      const int nkc = min(BKC, kc_n - kc0);
      unsigned char* dst = s_b + (st % NSTAGE) * BSTAGE;
      for (int i = tid; i < nkc * BN * 2; i += NT) {
        const int kk = i / (BN * 2);
        const int row = (i / 2) % BN;
        const int hf = i % 2;
        cp_async16(smem_u32(dst + kk * (BN * 32) + swz(row, hf)),
                   a.wp + ((int64_t)(kc0 + kk) * ncol + j * BN + row) * 16
                       + hf * 8,
                   true);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) load_b(st);

  cp_async_wait<NSTAGE - 1>();  // the input tile has landed
  __syncthreads();
  if (PRO) {
    for (int i = tid; i < BM * kc_n * 2; i += NT) {
      const int r = i / (kc_n * 2);
      const int kc = (i / 2) % kc_n;
      const int hf = i % 2;
      const int c = kc * 16 + hf * 8;
      prologue_half(reinterpret_cast<uint4*>(s_a + kc * (BM * 32)
                                             + swz(r, hf)),
                    s_inv + c, s_shift + c, a.act, true);
    }
  }

  float acc[2][WNT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < WNT; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;

  const int g = lane / 4;
  const int t4 = lane % 4;
  // The lane's ldmatrix rows: of the input tile (m16 tile 0) and of the
  // weight stage (n8 tiles 0 and 1).
  const uint32_t arow = smem_u32(s_a) + swz(wm * 32 + (lane & 15), lane >> 4);
  const uint32_t brow = smem_u32(s_b)
      + swz(wn * WNT * 8 + (lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  for (int st = 0; st < nstages; ++st) {
    cp_async_wait<NSTAGE - 2>();  // stage st has landed
    __syncthreads();              // for every thread; stage st - 1 done
    load_b(st + NSTAGE - 1);
    const int j = st / groups;
    const int kc0 = (st % groups) * BKC;
    const int nkc = min(BKC, kc_n - kc0);
    const uint32_t sb = brow + (st % NSTAGE) * BSTAGE;
    for (int kk = 0; kk < nkc; ++kk) {
      uint32_t af[2][4], bf[WNT][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(arow + (kc0 + kk) * (BM * 32) + mi * 16 * 32, af[mi]);
#pragma unroll
      for (int p = 0; p < WNT / 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4(sb + kk * (BN * 32) + p * 16 * 32, r);
        bf[2 * p][0] = r[0];
        bf[2 * p][1] = r[1];
        bf[2 * p + 1][0] = r[2];
        bf[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < WNT; ++nj)
          mma_bf16_16816(acc[mi][nj], af[mi], bf[nj][0], bf[nj][1]);
    }
    if (st % groups != groups - 1) continue;

    // Epilogue of slice j: bias, round, statistics, then the tile into
    // s_o and out to device memory.
    float sm[WNT][2], sq[WNT][2];
#pragma unroll
    for (int nj = 0; nj < WNT; ++nj) {
      const int col = (wn * WNT + nj) * 8 + 2 * t4;
      const int co = (j * BN + col) % a.cout;
      const float b0 = a.bias[co];
      const float b1 = a.bias[co + 1];
      sm[nj][0] = sm[nj][1] = sq[nj][0] = sq[nj][1] = 0.0f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = wm * 32 + mi * 16 + g + 8 * hr;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[mi][nj][2 * hr] + b0, acc[mi][nj][2 * hr + 1] + b1);
          *reinterpret_cast<__nv_bfloat162*>(&s_o[row * OPITCH + col]) = v;
          acc[mi][nj][2 * hr] = acc[mi][nj][2 * hr + 1] = 0.0f;
          if (ST && v0 + row < total) {
            const float r0 = __low2float(v);
            const float r1 = __high2float(v);
            sm[nj][0] += r0;
            sm[nj][1] += r1;
            sq[nj][0] = fmaf(r0, r0, sq[nj][0]);
            sq[nj][1] = fmaf(r1, r1, sq[nj][1]);
          }
        }
    }
    if (ST) {
#pragma unroll
      for (int nj = 0; nj < WNT; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            sm[nj][e] += __shfl_xor_sync(0xffffffffu, sm[nj][e], off);
            sq[nj][e] += __shfl_xor_sync(0xffffffffu, sq[nj][e], off);
          }
      if (g == 0) {
        // the per-sample mode: this warp's own row, in slice order
        float* const wred = s_wred + warp * 2 * a.cout;
#pragma unroll
        for (int nj = 0; nj < WNT; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = (j * BN + (wn * WNT + nj) * 8 + 2 * t4 + e)
                % a.cout;
            if (a.part != nullptr) {
              wred[co] += sm[nj][e];
              wred[a.cout + co] += sq[nj][e];
            } else {
              atomicAdd(&s_red[co], sm[nj][e]);
              atomicAdd(&s_red[a.cout + co], sq[nj][e]);
            }
          }
      }
    }
    __syncthreads();
    // Thread tid stores vector u = tid % 16 (8 columns, which share one
    // sub-position since C_out % 32 == 0) of rows tid / 16 + 16 k.
    const int u = tid % (BN / 8);
    const int n = j * BN + u * 8;
    const int sub = n / a.cout;
    const int64_t soff = (sub >> 2) * ostride_a + ((sub >> 1) & 1) * ostride_b
        + (sub & 1);
    __nv_bfloat16* yc = a.y + n % a.cout;
#pragma unroll
    for (int row = tid / (BN / 8); row < BM; row += NT / (BN / 8)) {
      const int64_t ob = s_obase[row];
      if (ob >= 0)
        *reinterpret_cast<uint4*>(yc + (ob + soff) * a.cout) =
            *reinterpret_cast<const uint4*>(&s_o[row * OPITCH + u * 8]);
    }
  }
  if (!ST) return;
  __syncthreads();
  if (a.part != nullptr) {   // the warps' rows in order: the partial row
    float* const row = a.part
        + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * a.cout;
    for (int c = tid; c < 2 * a.cout; c += NT) {
      float acc = 0.0f;
      for (int w = 0; w < NT / 32; ++w) acc += s_wred[w * 2 * a.cout + c];
      row[c] = acc;
    }
    return;
  }
  for (int c = tid; c < a.cout; c += NT) {
    atomicAdd(a.s + c, s_red[c]);
    atomicAdd(a.q + c, s_red[a.cout + c]);
  }
}

template <bool PRO, bool ST>
cudaError_t launch(const UpTcArgs& a, cudaStream_t stream) {
  const size_t smem = up_tc_smem(a.cin, a.cout, a.part != nullptr);
  const cudaError_t rc = cudaFuncSetAttribute(
      upconv_tc_kernel<PRO, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return rc;
  const int64_t total = a.spv ? a.spv : (int64_t)a.n * a.d * a.h * a.wd;
  const int64_t blocks = (total + BM - 1) / BM;
  if (blocks > 0x7fffffff || (a.spv && a.n > 65535))
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, a.spv ? a.n : 1);
  upconv_tc_kernel<PRO, ST><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The per-sample mode's partial rows a sample (ps_reduce.cuh): its
// blocks of BM voxels.
extern "C" int64_t e3_upconv_bnact_tc_ps_parts(int d, int h, int wd) {
  return ((int64_t)d * h * wd + BM - 1) / BM;
}

// K3, bf16 body. ``wp`` is the packed (cin / 16, kd * 4 * cout, 16) bf16
// weight; ``inv`` null means a dense input (no prologue); ``s`` and
// ``q`` (zeroed by the caller) null means no statistics. The per-sample
// mode (group and instance norm): ``pro_ns`` is cin for inv/shift of (n,
// cin) (0 for the batch form); a workspace ``ws`` (ps_workspace_floats
// of n samples, e3_upconv_bnact_tc_ps_parts rows of 2 cout) gives each
// sample's statistics in ``s`` as (n, 2, cout), summed in a fixed order
// (``q`` unused). Needs cin % 16 == 0 and cout % 32 == 0.
extern "C" int e3_upconv_bnact_tc(const void* x, const float* inv,
                                  const float* shift, int pro_ns,
                                  const void* wp, const float* bias, void* y,
                                  float* s, float* q, float* ws, int n,
                                  int d, int h, int wd, int cin, int cout,
                                  int kd, int act, void* stream) {
  if (cin % 16 || cout % 32 || (kd != 1 && kd != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  UpTcArgs a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.inv = inv;
  a.shift = shift;
  a.wp = static_cast<const __nv_bfloat16*>(wp);
  a.bias = bias;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.s = s;
  a.q = q;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  a.kd = kd;
  a.act = act;
  a.pro_ns = pro_ns;
  a.part = ws;
  a.spv = pro_ns || ws != nullptr ? (int64_t)d * h * wd : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (inv != nullptr)
    rc = s != nullptr ? launch<true, true>(a, st) : launch<true, false>(a, st);
  else
    rc = s != nullptr ? launch<false, true>(a, st)
                      : launch<false, false>(a, st);
  if (rc == cudaSuccess && ws != nullptr)
    rc = ps_reduce(ws, n, e3_upconv_bnact_tc_ps_parts(d, h, wd), 2 * cout, s,
                   st);
  return static_cast<int>(rc);
}
