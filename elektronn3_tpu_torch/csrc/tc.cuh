// Tensor-core building blocks of the bf16 bodies of K1 (conv_tc.cu), K3
// (upconv_tc.cu), K5 (wgrad_tc.cu) and K7 (upconv_bwd_tc.cu), written as
// inline PTX: cp.async copies from device to shared memory, ldmatrix
// fragment loads (plain and transposed) and mma.sync m16n8k16 with bf16
// operands and float32 accumulators.
//
// Shared-memory operand tiles hold rows of 16 bf16 (32 bytes: one k16
// step of the MMA). A row's two 16-byte halves are XOR-swizzled with
// bit 2 of the row index, so that the 8 row addresses of one ldmatrix
// phase (8 consecutive rows, one half) fall into 8 distinct 16-byte bank
// groups, whatever row they start from: a conflict-free load.
#pragma once

#include "common.cuh"

namespace e3 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of half ``hf`` (0: k 0-7, 1: k 8-15) of row ``row`` in a
// swizzled tile of 32-byte rows.
__device__ __forceinline__ uint32_t swz(int row, int hf) {
  return static_cast<uint32_t>((2 * row + (hf ^ ((row >> 2) & 1))) * 16);
}

// 16 bytes from ``src`` to shared address ``dst``; zero-filled (nothing
// read) when ``!pred``, in which case ``src`` need only be a valid
// pointer.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// The same four matrices, each transposed on the way: lane l receives
// elements (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of its matrix
// (row, column as stored). An operand stored K-major (voxel rows of
// contiguous channels) so becomes an mma fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// d += a * b: a 16x16 (row-major) by 16x8 (column-major) bf16 product
// into 16x8 float32 sums. Fragments as PTX's mma.m16n8k16 defines them:
// lane l holds rows l / 4 and l / 4 + 8, columns 2 (l % 4) and + 1.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values rounded to bf16 and packed (low half first).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Apply the prologue act(x * inv + shift) to the 8 bf16 values of one
// 16-byte shared-memory half-row in place, rounding back to bf16 (the
// rounding point of the JAX kernels), or write zeros when ``!valid``
// (zero padding after the prologue). ``inv`` and ``shift`` point at the
// half's 8 channels (16-byte aligned).
__device__ __forceinline__ void prologue_half(uint4* p, const float* inv,
                                              const float* shift, int act,
                                              bool valid) {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (valid) {
    u = *p;
    float sc[8], sh[8];
    *reinterpret_cast<float4*>(sc) = *reinterpret_cast<const float4*>(inv);
    *reinterpret_cast<float4*>(sc + 4) =
        *reinterpret_cast<const float4*>(inv + 4);
    *reinterpret_cast<float4*>(sh) = *reinterpret_cast<const float4*>(shift);
    *reinterpret_cast<float4*>(sh + 4) =
        *reinterpret_cast<const float4*>(shift + 4);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(
          prologue(v.x, sc[2 * j], sh[2 * j], act),
          prologue(v.y, sc[2 * j + 1], sh[2 * j + 1], act));
    }
  }
  *p = u;
}

// Form dy_tot = dy + ds + 2 y dq in float32 for the 8 bf16 values of
// one 16-byte shared-memory half-row of dy (in place) and of y (``yp``,
// or null: no statistics cotangent, dy_tot = dy), add the float32 values
// to ``db`` (or skip when null), and round back to bf16; write zeros
// (and add nothing) when ``!valid``. ``ds`` and ``dq`` point at the
// half's 8 channels.
__device__ __forceinline__ void dytot_half(uint4* p, const uint4* yp,
                                           const float* ds, const float* dq,
                                           bool valid, float* db) {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (valid) {
    u = *p;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    if (yp != nullptr) {
      const uint4 yv = *yp;
      const __nv_bfloat162* hy = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 g = __bfloat1622float2(h[j]);
        const float2 t = __bfloat1622float2(hy[j]);
        const float a = dy_tot(g.x, t.x, ds[2 * j], dq[2 * j]);
        const float b = dy_tot(g.y, t.y, ds[2 * j + 1], dq[2 * j + 1]);
        if (db != nullptr) {
          db[2 * j] += a;
          db[2 * j + 1] += b;
        }
        h[j] = __floats2bfloat162_rn(a, b);
      }
    } else if (db != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 g = __bfloat1622float2(h[j]);
        db[2 * j] += g.x;
        db[2 * j + 1] += g.y;
      }
    }
  }
  *p = u;
}

// The pre-pass of K5's and K7's bf16 bodies (defined in
// upconv_bwd_tc.cu): dy_tot = dy + ds + 2 y dq of ``voxels`` rows of
// ``c`` bf16 channels, rounded into ``e``, its float32 sums added into
// ``db`` (zeroed by the caller). One read of dy and y, one write of e.
// Needs c % 8 == 0 and c <= kDytotMaxC.
constexpr int kDytotMaxC = 1024;
cudaError_t launch_dytot(const __nv_bfloat16* dy, const __nv_bfloat16* y,
                         const float* ds, const float* dq, __nv_bfloat16* e,
                         float* db, int64_t voxels, int c,
                         cudaStream_t stream);

}  // namespace e3
