// Element-type helpers for the kernels templated on their row type (bf16
// or fp32: K9b, K9c, K12a, K12b): a value as fp32 and back, two
// neighbouring values loaded and stored as fp32. (Every fp32 product runs
// on the tensor cores as three bf16 parts, hopper.cuh; no fp32 form
// multiplies on the CUDA cores.)

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vit {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Two neighbouring values at p (4-byte aligned for bf16, 8 for fp32).
template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
  } else {
    return *reinterpret_cast<const float2*>(p);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<uint32_t*>(&v);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  }
}

}  // namespace vit
