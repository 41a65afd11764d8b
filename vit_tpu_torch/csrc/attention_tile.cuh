// Tiles shared by the packed-attention forward (K1) and backward (K2):
// head_dim 64, 64-row tiles, four warps of 16 rows each.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace vit {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;      // rows of a q, k, v or dO tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
// Shared-memory row pitch in bf16: 72 elements = 144 bytes, so the 8 row groups
// of a fragment load hit 8 distinct 4-bank groups.
constexpr int kPitch = kHeadDim + 8;

// Copy a 64 x 64 tile of one head's q, k, v or dO (rows `row_stride` apart in
// global memory) into shared memory. Each value becomes
//   x' = bf16(x + bias)                     (kBias; otherwise x' = x)
//   y  = bf16(x' · scale · row_scale[r])    (kRowScale; otherwise x' · scale)
// so the bias is added in bf16 as the TPU kernel adds it, and a power-of-two
// scale is exact. Rows at or past `rows` are written as zeros, so padded rows
// contribute 0 · 0 and never NaN. kTranspose stores the tile as [column][row],
// for products whose B operand runs along the tile's rows. The options are
// template parameters so that K1's loads carry no test for the backward's.
template <bool kTranspose, bool kBias = true, bool kRowScale = false>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g,
                                          const bf16* bias, int rows,
                                          size_t row_stride, float scale,
                                          const float* row_scale = nullptr) {
  for (int i = threadIdx.x; i < kTile * (kHeadDim / 8); i += kThreads) {
    const int r = i / (kHeadDim / 8);
    const int c = (i % (kHeadDim / 8)) * 8;
    const bool valid = r < rows;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (valid) raw = *reinterpret_cast<const uint4*>(g + r * row_stride + c);
    float mult = scale;
    if constexpr (kRowScale) mult *= valid ? row_scale[r] : 1.0f;
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
    uint4 packed;
    bf16* y = reinterpret_cast<bf16*>(&packed);
    if constexpr (kBias) {
      const uint4 braw = *reinterpret_cast<const uint4*>(bias + c);
      const bf16* bb = reinterpret_cast<const bf16*>(&braw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16 biased =
            __float2bfloat16(__bfloat162float(x[j]) + __bfloat162float(bb[j]));
        y[j] = valid ? __float2bfloat16(__bfloat162float(biased) * mult)
                     : __float2bfloat16(0.0f);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j] = valid ? __float2bfloat16(__bfloat162float(x[j]) * mult)
                     : __float2bfloat16(0.0f);
    }
    if (kTranspose) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sm[(c + j) * kPitch + r] = y[j];
    } else {
      *reinterpret_cast<uint4*>(sm + r * kPitch + c) = packed;
    }
  }
}

// A warp's 16 rows of a 64-wide tile as A fragments, one per 16-wide step.
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[kHeadDim / 16][4],
                                            const bf16* tile, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks)
    load_a(f[ks], tile, kPitch, ks * 16, g, t);
}

}  // namespace vit
