// Shared device helpers for the fused U-Net kernels (sm_90a).
//
// Activations are NDHWC tensors in float32 or bfloat16. Every kernel
// computes in float32; the "prologue" is the consumer-side batch-norm
// apply plus activation, a = act(x * inv[c] + shift[c]), evaluated in
// float32 on the stored value (ops/flat_fused.py::_act_fwd in the JAX
// package).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace e3 {

enum DType { DT_F32 = 0, DT_BF16 = 1 };
enum Act { ACT_LINEAR = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

constexpr float kLeakySlope = 0.1f;

__device__ __forceinline__ float act_fwd(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.0f);
  if (act == ACT_LEAKY) return v > 0.0f ? v : kLeakySlope * v;
  return v;
}

// act'(pre) as the JAX kernels take it (flat_fused.py _act_deriv):
// relu passes where pre > 0.
__device__ __forceinline__ float act_grad(float pre, int act) {
  if (act == ACT_RELU) return pre > 0.0f ? 1.0f : 0.0f;
  if (act == ACT_LEAKY) return pre > 0.0f ? 1.0f : kLeakySlope;
  return 1.0f;
}

// The pre-activation x * inv + shift, with the multiply and the add
// rounded separately (no fused multiply-add), as the plain PyTorch
// version computes it, so both give the same float32 value.
__device__ __forceinline__ float pre_act(float x, float inv, float shift) {
  return __fadd_rn(__fmul_rn(x, inv), shift);
}

// The prologue a = act(x * inv + shift).
__device__ __forceinline__ float prologue(float x, float inv, float shift,
                                          int act) {
  return act_fwd(pre_act(x, inv, shift), act);
}

// dy_tot = dy + ds + 2 * y * dq: the statistics cotangent folded into
// the output cotangent on load, in the plain version's order.
__device__ __forceinline__ float dy_tot(float dy, float y, float ds,
                                        float dq) {
  return __fadd_rn(__fadd_rn(dy, ds), __fmul_rn(2.0f * y, dq));
}

// Reduce-scatter of 32 per-lane values over a warp: on return v[0] of
// lane l holds the warp's sum of v[l]. 31 shuffles.
__device__ __forceinline__ float warp_reduce_scatter32(float* v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int j = 0; j < off; ++j) {
      const float send = upper ? v[j] : v[j + off];
      const float keep = upper ? v[j + off] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0];
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float32 value to the activation dtype and back: the JAX
// kernels store the prologued operand in the model dtype before the
// multiply, so the port rounds at the same place.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Load 8 consecutive channels as float32. The address must be 16-byte
// aligned (the wrappers check the base pointer; channel counts are
// multiples of 8 wherever this is used).
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}

// Load 8 channels of a row of ``ci`` channels from channel ``cb`` on,
// vectorized when ``ci % 8 == 0``, else one by one with channels past
// ``ci`` read as 0.
template <typename T>
__device__ __forceinline__ void load8_tail(const T* p, int ci, int cb,
                                           float* v) {
  if (ci % 8 == 0) {
    load8(p, v);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = (cb + c < ci) ? to_f(p[c]) : 0.0f;
  }
}

// Store 8 consecutive channels from float32 (16-byte aligned).
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

}  // namespace e3
