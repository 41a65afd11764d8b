// The tanh-composed erf GELU of vit_tpu/ops/gelu.py and its flat
// derivative (vit_tpu/kernels/convnext_block.py:_gelu, _gelu_grad), in fp32,
// and a warp sum: shared by the ConvNeXt tail (K3/K4) and the fused
// LayerNorm → matmul kernels (K9a/K9b/K9c).

#pragma once

namespace vit {

constexpr float kInvSqrt2 = 0.7071067811865476f;
// minimax fit of erf(u) = tanh(c1·u + c3·u³ + c5·u⁵), vit_tpu/ops/gelu.py
constexpr float kC1 = 1.12814338f, kC3 = 0.10408119f, kC5 = -0.00178647f;

__device__ __forceinline__ float gelu(float z) {
  const float u = fminf(fmaxf(z * kInvSqrt2, -4.0f), 4.0f);
  const float u2 = u * u;
  return 0.5f * z * (1.0f + tanhf(u * (kC1 + u2 * (kC3 + u2 * kC5))));
}

__device__ __forceinline__ float gelu_grad(float z) {
  const float u = fminf(fmaxf(z * kInvSqrt2, -4.0f), 4.0f);
  const float u2 = u * u;
  const float th = tanhf(u * (kC1 + u2 * (kC3 + u2 * kC5)));
  const float dp = kC1 + u2 * (3.0f * kC3 + u2 * (5.0f * kC5));
  return 0.5f * (1.0f + th) + 0.5f * z * (1.0f - th * th) * dp * kInvSqrt2;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace vit
