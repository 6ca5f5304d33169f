// Shared helpers for the port's hand-written kernels: element types (fp32,
// bf16) and their fp32 conversions, the dtype codes the Python wrappers pass
// (ewvit_tpu_torch/ops/extension.py DTYPE_CODES), and a warp sum.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace ewvit {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Two neighbouring elements in one load; p must be aligned to 2 elements.
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x; b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __bfloat162float(v.x); b = __bfloat162float(v.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace ewvit

// Dispatch a templated launch on the runtime dtype code.
#define EWVIT_DISPATCH(code, T, ...)                         \
  switch (code) {                                            \
    case ewvit::kF32: { using T = float; __VA_ARGS__; break; }          \
    case ewvit::kBF16: { using T = __nv_bfloat16; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;              \
  }
