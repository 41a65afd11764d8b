// Tiles shared by the attention kernels, packed (K1 forward, K2 backward)
// and unpacked (K6 forward, K7/K8 backward): head_dim 64, 64-row tiles, four
// warps of 16 rows each.

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

// Element strides (batch, head, row) of one unpacked (B, H, S, 64) operand
// of K6-K8; head_dim is contiguous.
struct Strides {
  long long b, h, s;
};

// Offset of head (b, h) of an operand with strides `st`.
__device__ __forceinline__ size_t offset(const Strides& st, int b, int h) {
  return static_cast<size_t>(b) * st.b + static_cast<size_t>(h) * st.h;
}

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

// s = q kᵀ for a warp's 16 rows and one 64-key tile (8 column tiles of 8
// keys), with the key-padding and causal masks applied as -inf. q is already
// scaled; rows and columns are global positions in the sequence.
__device__ __forceinline__ void scores(float (&s)[kTile / 8][4],
                                       const uint32_t (&qf)[kHeadDim / 16][4],
                                       const bf16* sK, int k0, int row0, int S,
                                       int causal, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    mma_row<kHeadDim / 16>(s[nt], qf, sK, kPitch, nt * 8, g, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + nt * 8 + 2 * t + (e & 1);
      const int row = row0 + (e >> 1) * 8;
      if (col >= S || (causal && col > row)) s[nt][e] = -INFINITY;
    }
  }
}

constexpr float kScale = 0.125f;  // 1/√64, a power of two

// The backward's ds = ph · ((dp - Δ·linv) · (scale·linv)) with the TPU
// kernel's operation order and no contraction into fused multiply-adds.
__device__ __forceinline__ float dscore(float ph, float dp, float delta,
                                        float linv) {
  const float centred = __fsub_rn(dp, __fmul_rn(delta, linv));
  return __fmul_rn(ph, __fmul_rn(centred, __fmul_rn(kScale, linv)));
}

// Rows row0 and row0 + 8 of a warp's 16 x 64 accumulator to bf16 at `dst`
// (row r at dst + r·stride), skipping rows at or past S.
__device__ __forceinline__ void store_rows(const float (&acc)[kHeadDim / 8][4],
                                           bf16* dst, size_t stride, int row0,
                                           int S, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= S) continue;
    bf16* p = dst + static_cast<size_t>(row) * stride;
#pragma unroll
    for (int nt = 0; nt < kHeadDim / 8; ++nt)
      *reinterpret_cast<uint32_t*>(p + nt * 8 + 2 * t) =
          pack_bf16x2(acc[nt][2 * r], acc[nt][2 * r + 1]);
  }
}

}  // namespace vit
