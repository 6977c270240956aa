// K4 conv_bnact_dgrad, bfloat16 body: the input gradient of K1's
// (kd, 3, 3) 'same' conv over one or two NDHWC inputs,
//     g   = round(dy_tot),  dy_tot = dy + ds + 2 y dq (float32)
//     gin = the 'same' conv of g with the flipped, transposed weights
//     gm  = gin * act'(x * inv + shift),  dx = round(gm * inv)
//     dinv = sum gm * x,  dshift = sum gm,
// as an implicit GEMM on the tensor cores: K1's bf16 forward
// (conv_tc.cu, conv_tc.cuh) with dy_tot as its A operand and its own
// epilogue. The function, its rounding points and its plain version are
// those of conv_bnact_bwd.cu's K4 (ops/fused.py conv_bnact_dgrad_plain),
// which float32 keeps on the CUDA cores. It runs for bf16 whenever every
// input's channel count is a multiple of 32 (the wrapper's dgrad_body):
// rows 8, 14 and 26's dgrad.
//
// Replaces, for bf16, the dgrad halves of these TPU kernels of the JAX
// package:
//   ops/flat_fused.py::_conv_bnact_bwd   (_fused_conv_bwd_kernel)
//   ops/flat_fused64.py::_conv64_bwd     (_conv64_bwd_kernel)
//   ops/flat_conv.py::_flat_conv3_bwd    (row 26's dgrad: no prologue)
//
// What bounds it on the card: at kd = 3 and C >= 64 arithmetic (the
// forward's FLOPs); at kd = 1 and C = 32 the bytes of dy, y, x and dx.
// The design, K1's with these changes:
//   - A is dy_tot: dy itself without a statistics cotangent; with one,
//     the raw dy and y slabs come through the 2-stage cp.async ring side
//     by side and one pass forms dy_tot in place, rounds it and writes 0
//     at the halo (dytot_half), where each slab is read by at most two
//     blocks (kd = 1: the blocks over C_in <= 256); at kd = 3, where
//     three planes' blocks would read it, the pre-pass (launch_dytot,
//     upconv_bwd_tc.cu) first writes the rounded dy_tot into a scratch
//     of dy's shape, which the blocks stage raw, reading no y;
//   - B is the flipped, transposed weight, packed once per call in bf16
//     as (kd, C_dy / 16, 9, C_in, 16) by the wrapper (pack_dgrad_weight:
//     pack_conv_weight's layout of the transposed, flipped weight);
//   - COB = 128 (64, 32) dx channels a block, so one staged dy slab
//     serves a whole 64 + 64 merge (128 + 128 in two blocks);
//   - the epilogue works from the accumulators: it reads x at the lane's
//     (voxel, channel pair), forms gm, stores dx into input 0 or 1 by
//     column, and sums dinv and dshift by shuffles over the lanes of a
//     channel, shared-memory atomics and one device atomic per channel
//     and block (K1's statistics epilogue), skipped, with x, for the
//     identity prologue (row 26).
// mma.sync rather than wgmma for K1's reason (conv_tc.cu).
#include "conv_tc.cuh"

namespace {

using namespace e3;

struct DgTcArgs {
  const __nv_bfloat16* g;    // (n, d, h, w, cdy): dy, or the rounded dy_tot
  const __nv_bfloat16* y;    // the forward output when folding, else null
  const float* ds;           // (cdy,) statistics cotangents (with y)
  const float* dq;
  int cdy;
  const __nv_bfloat16* wp;   // (kd, cdy / 16, 9, c0 + c1, 16)
  const __nv_bfloat16* x[2]; // the forward inputs
  int cin[2];
  const float* inv;          // (c0 + c1,) prologue, or null (identity)
  const float* shift;
  __nv_bfloat16* dx[2];
  float* dinv;               // (c0 + c1,), zeroed (with inv)
  float* dshift;
  int n, d, h, wd, ct, kd, act, tw;
};

// Shared memory: the dy ring (and y's when folding), the weight ring,
// the slab's voxel offsets, the block sums of dinv and dshift, and ds,
// dq when folding.
template <int COB>
size_t dgrad_tc_smem(int tw, int cdy, bool fold) {
  const int npos = (Cfg<COB>::M / tw + 2) * (tw + 2);
  return (size_t)KST * (npos * APITCH * (fold ? 2 : 1) + Cfg<COB>::BSTAGE)
      + (size_t)npos * 4 + (size_t)2 * COB * 4 + (fold ? 8 * cdy : 0);
}

template <int COB, bool FOLD, bool PRO>
__global__ void __launch_bounds__(NT, 2) dgrad_tc_kernel(const DgTcArgs a) {
  using C = Cfg<COB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tw = a.tw;
  const int th = C::M / tw;
  const int hw = tw + 2;                      // slab width
  const int npos = (th + 2) * hw;
  const int abytes = npos * APITCH;
  unsigned char* s_a = smem;                  // KST x [npos][APITCH]
  unsigned char* s_y = s_a + KST * abytes;    // FOLD: KST x [npos][APITCH]
  unsigned char* s_b = s_y + (FOLD ? KST * abytes : 0);
  int* s_off = reinterpret_cast<int*>(s_b + KST * C::BSTAGE);   // [npos]
  float* s_red = reinterpret_cast<float*>(s_off + npos);        // [2][COB]
  float* s_ds = s_red + 2 * COB;              // FOLD: [cdy] ds, [cdy] dq
  float* s_dq = s_ds + a.cdy;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / C::WARPS_N;
  const int wn = warp % C::WARPS_N;
  const int tiles_w = (a.wd + tw - 1) / tw;
  const int tiles = ((a.h + th - 1) / th) * tiles_w;
  const int tile = (int)(blockIdx.x % tiles);
  const int64_t nd = blockIdx.x / tiles;
  const int h0 = (tile / tiles_w) * th;
  const int w0 = (tile % tiles_w) * tw;
  const int64_t nn = nd / a.d;
  const int d = (int)(nd % a.d);
  const int co0 = blockIdx.z * COB;
  const int kct = a.cdy / 16;
  const int dz_lo = max(0, a.kd / 2 - d);
  const int nvd = min(a.kd, a.d - d + a.kd / 2) - dz_lo;
  const int nsteps = nvd * kct;
  for (int pos = tid; pos < npos; pos += NT) {
    const int gh = h0 + pos / hw - 1;
    const int gw = w0 + pos % hw - 1;
    s_off[pos] = gh >= 0 && gh < a.h && gw >= 0 && gw < a.wd
        ? gh * a.wd + gw : -1;
  }
  if (PRO)
    for (int c = tid; c < 2 * COB; c += NT) s_red[c] = 0.0f;
  if (FOLD)
    for (int c = tid; c < a.cdy; c += NT) {
      s_ds[c] = a.ds[c];
      s_dq[c] = a.dq[c];
    }
  __syncthreads();

  // Step st: depth tap dz_lo + st / kct, k16 step st % kct of dy_tot's
  // channels; its dy (and y) slab and its 9 taps of weights into ring
  // slot st % KST.
  auto load = [&](int st) {
    const int dz = dz_lo + st / kct;
    const int kc = st % kct;
    const int64_t base =
        (nn * a.d + d + dz - a.kd / 2) * a.h * a.wd * a.cdy + kc * 16;
    const int so = (st % KST) * abytes;
    for (int p = tid; p < npos * 2; p += NT) {
      const int off = s_off[p >> 1];
      const int64_t src =
          off >= 0 ? base + (int64_t)off * a.cdy + (p & 1) * 8 : 0;
      const int dst = so + (p >> 1) * APITCH + (p & 1) * 16;
      cp_async16(smem_u32(s_a + dst), a.g + src, off >= 0);
      if (FOLD) cp_async16(smem_u32(s_y + dst), a.y + src, off >= 0);
    }
    unsigned char* db = s_b + (st % KST) * C::BSTAGE;
    const __nv_bfloat16* wsrc =
        a.wp + ((int64_t)(dz * kct + kc) * 9 * a.ct + co0) * 16;
    for (int p = tid; p < 9 * COB * 2; p += NT) {
      const int row = p >> 1;         // tap * COB + dx channel
      cp_async16(smem_u32(db + swz(row, p & 1)),
                 wsrc + ((int64_t)(row / COB) * a.ct + row % COB) * 16
                     + (p & 1) * 8,
                 true);
    }
    cp_async_commit();
  };

  uint32_t arow[C::MI];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi) {
    const int m = wm * C::WM + mi * 16 + (lane & 15);
    arow[mi] = smem_u32(s_a) + ((m / tw) * hw + m % tw) * APITCH
        + (lane >> 4) * 16;
  }
  const uint32_t brow = smem_u32(s_b)
      + swz(wn * 32 + (lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);

  float acc[C::MI][4][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < KST - 1; ++st) {
    if (st < nsteps)
      load(st);
    else
      cp_async_commit();
  }
  for (int st = 0; st < nsteps; ++st) {
    cp_async_wait<KST - 2>();  // step st has landed
    __syncthreads();           // for every thread; step st - 1's MMAs done
    if (st + KST - 1 < nsteps)
      load(st + KST - 1);
    else
      cp_async_commit();
    const int slot = st % KST;
    if (FOLD) {
      const int kc = st % kct;
      for (int p = tid; p < npos * 2; p += NT) {
        const int c = kc * 16 + (p & 1) * 8;
        const int o = slot * abytes + (p >> 1) * APITCH + (p & 1) * 16;
        dytot_half(reinterpret_cast<uint4*>(s_a + o),
                   reinterpret_cast<const uint4*>(s_y + o), s_ds + c,
                   s_dq + c, s_off[p >> 1] >= 0, nullptr);
      }
      __syncthreads();
    }
    tap_mma9<COB>(acc, arow, slot * abytes, brow + slot * C::BSTAGE, hw);
  }

  // Epilogue from the accumulators: lane (gr, t4) holds rows gr and
  // gr + 8 of each m16 tile, dx channels 2 t4 and 2 t4 + 1 of each n8
  // tile (a pair never straddles the two inputs: each has C % 32 == 0).
  const int gr = lane / 4;
  const int t4 = lane % 4;
  float sx[4][2], sg[4][2];   // dinv and dshift partials (PRO)
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int co = co0 + wn * 32 + nj * 8 + 2 * t4;
    const int i = co >= a.cin[0];
    const int cl = co - (i ? a.cin[0] : 0);
    const int ci = a.cin[i];
    float inv0 = 1.0f, inv1 = 1.0f, sh0 = 0.0f, sh1 = 0.0f;
    if (PRO) {
      inv0 = a.inv[co];
      inv1 = a.inv[co + 1];
      sh0 = a.shift[co];
      sh1 = a.shift[co + 1];
    }
    sx[nj][0] = sx[nj][1] = sg[nj][0] = sg[nj][1] = 0.0f;
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = wm * C::WM + mi * 16 + gr + 8 * hr;
        const int hh = h0 + m / tw;
        const int ww = w0 + m % tw;
        if (hh >= a.h || ww >= a.wd) continue;
        const int64_t off = ((nd * a.h + hh) * a.wd + ww) * ci + cl;
        float g0 = acc[mi][nj][2 * hr];
        float g1 = acc[mi][nj][2 * hr + 1];
        if (PRO) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(a.x[i] + off));
          g0 *= act_grad(pre_act(xv.x, inv0, sh0), a.act);
          g1 *= act_grad(pre_act(xv.y, inv1, sh1), a.act);
          sx[nj][0] = fmaf(g0, xv.x, sx[nj][0]);
          sx[nj][1] = fmaf(g1, xv.y, sx[nj][1]);
          sg[nj][0] += g0;
          sg[nj][1] += g1;
          g0 *= inv0;
          g1 *= inv1;
        }
        *reinterpret_cast<__nv_bfloat162*>(a.dx[i] + off) =
            __floats2bfloat162_rn(g0, g1);
      }
  }
  if (!PRO) return;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        sx[nj][e] += __shfl_xor_sync(0xffffffffu, sx[nj][e], off);
        sg[nj][e] += __shfl_xor_sync(0xffffffffu, sg[nj][e], off);
      }
  if (gr == 0) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wn * 32 + nj * 8 + 2 * t4 + e;
        atomicAdd(&s_red[c], sx[nj][e]);
        atomicAdd(&s_red[COB + c], sg[nj][e]);
      }
  }
  __syncthreads();
  for (int c = tid; c < COB; c += NT) {
    atomicAdd(a.dinv + co0 + c, s_red[c]);
    atomicAdd(a.dshift + co0 + c, s_red[COB + c]);
  }
}

template <int COB, bool FOLD, bool PRO>
cudaError_t dg_launch(const DgTcArgs& a, cudaStream_t stream) {
  const size_t smem = dgrad_tc_smem<COB>(a.tw, a.cdy, FOLD);
  const cudaError_t rc = cudaFuncSetAttribute(
      dgrad_tc_kernel<COB, FOLD, PRO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  const int th = Cfg<COB>::M / a.tw;
  const int64_t tiles = (int64_t)((a.h + th - 1) / th)
      * ((a.wd + a.tw - 1) / a.tw);
  const int64_t blocks = tiles * a.n * a.d;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, 1, a.ct / COB);
  dgrad_tc_kernel<COB, FOLD, PRO><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int COB>
cudaError_t dg_launch_cob(const DgTcArgs& a, cudaStream_t st) {
  if (a.y != nullptr)
    return a.inv != nullptr ? dg_launch<COB, true, true>(a, st)
                            : dg_launch<COB, true, false>(a, st);
  return a.inv != nullptr ? dg_launch<COB, false, true>(a, st)
                          : dg_launch<COB, false, false>(a, st);
}

}  // namespace

// K4, bf16 body. ``wp`` is the packed (kd, cdy / 16, 9, c0 + c1, 16)
// bf16 flipped, transposed weight; ``inv``/``shift`` ((c0 + c1,)) null
// means the identity prologue and a linear activation (dinv, dshift
// untouched); ``ds``/``dq`` null means no statistics cotangent (``y``,
// ``e`` and ``edb`` are then not used). With one and a scratch ``e`` of
// dy's shape (the wrapper passes it at kd = 3)
// the pre-pass writes the rounded dy_tot into e, and its db sums into
// ``edb`` ((cdy,) float32, zeroed; not K4's result); with ``e`` null the
// blocks fold dy_tot on load. dinv and dshift are zeroed by the caller.
// Needs cdy % 16 == 0, c0, c1 % 32 == 0 and kd in {1, 3}.
extern "C" int e3_conv_bnact_dgrad_tc(int nin, const void* dy, const void* y,
                                      const float* ds, const float* dq,
                                      void* e, float* edb, int cdy,
                                      const void* wp, const void* x0, int c0,
                                      const void* x1, int c1,
                                      const float* inv, const float* shift,
                                      void* dx0, void* dx1, float* dinv,
                                      float* dshift, int n, int d, int h,
                                      int wd, int kd, int act, void* stream) {
  if (cdy % 16 || c0 % 32 || (nin > 1 && c1 % 32) || (kd != 1 && kd != 3)
      || (ds != nullptr && e != nullptr && edb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DgTcArgs a = {};
  a.g = static_cast<const __nv_bfloat16*>(dy);
  a.cdy = cdy;
  a.wp = static_cast<const __nv_bfloat16*>(wp);
  a.x[0] = static_cast<const __nv_bfloat16*>(x0);
  a.x[1] = static_cast<const __nv_bfloat16*>(x1);
  a.cin[0] = c0;
  a.cin[1] = nin > 1 ? c1 : 0;
  a.inv = inv;
  a.shift = shift;
  a.dx[0] = static_cast<__nv_bfloat16*>(dx0);
  a.dx[1] = static_cast<__nv_bfloat16*>(dx1);
  a.dinv = dinv;
  a.dshift = dshift;
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.ct = a.cin[0] + a.cin[1];
  a.kd = kd;
  a.act = act;
  // The tile width that wastes the fewest columns of a row (32 on a tie).
  a.tw = ((wd + 15) / 16) * 16 < ((wd + 31) / 32) * 32 ? 16 : 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ds != nullptr && e != nullptr) {
    const cudaError_t rc = e3::launch_dytot(
        a.g, static_cast<const __nv_bfloat16*>(y), ds, dq,
        static_cast<__nv_bfloat16*>(e), edb, (int64_t)n * d * h * wd, cdy,
        st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    a.g = static_cast<const __nv_bfloat16*>(e);
  } else if (ds != nullptr) {
    a.y = static_cast<const __nv_bfloat16*>(y);
    a.ds = ds;
    a.dq = dq;
  }
  cudaError_t rc;
  if (a.ct % 128 == 0)
    rc = dg_launch_cob<128>(a, st);
  else if (a.ct % 64 == 0)
    rc = dg_launch_cob<64>(a, st);
  else
    rc = dg_launch_cob<32>(a, st);
  return static_cast<int>(rc);
}
