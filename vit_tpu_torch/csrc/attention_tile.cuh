// Constants and helpers shared by the attention kernels on Hopper
// (attention_fwd.cu: K6 and its packed form K1; attention_bwd.cu: K7/K8
// and K2; bf16 and fp32 alike).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace vit {

constexpr int kHeadDim = 64;

// Element strides (batch, head, row) of one (B, H, S, 64) operand or head
// view of the attention kernels; head_dim is contiguous.
struct Strides {
  long long b, h, s;
};

// Offset of head (b, h) of an operand with strides `st`.
__device__ __forceinline__ size_t offset(const Strides& st, int b, int h) {
  return static_cast<size_t>(b) * st.b + static_cast<size_t>(h) * st.h;
}

constexpr float kScale = 0.125f;  // 1/√64, a power of two

// Head h's slices of the packed projection's (3·H·64,) bf16 bias, q at
// h·64, k at (H + h)·64 and v at (2H + h)·64, into `dst` in shared memory:
// threads 0..23 of the block copy 16 bytes each; the caller synchronises.
__device__ __forceinline__ void load_head_bias(bf16 (&dst)[3][kHeadDim],
                                               const bf16* bias, int h,
                                               int H) {
  if (threadIdx.x < 3 * kHeadDim / 8) {
    const int part = threadIdx.x / 8, c = 8 * (threadIdx.x % 8);
    *reinterpret_cast<uint4*>(&dst[part][c]) = *reinterpret_cast<const uint4*>(
        bias + (static_cast<size_t>(part) * H + h) * kHeadDim + c);
  }
}

}  // namespace vit
