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

// The prologue a = act(x * inv + shift), with the multiply and the add
// rounded separately (no fused multiply-add), as the plain PyTorch
// version computes it, so both give the same float32 value.
__device__ __forceinline__ float prologue(float x, float inv, float shift,
                                          int act) {
  return act_fwd(__fadd_rn(__fmul_rn(x, inv), shift), act);
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
