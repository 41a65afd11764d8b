// Tensor-core and fragment helpers shared by the attention and ConvNeXt
// kernels: mma.sync m16n8k16 (bf16 in, fp32 accumulate) and its operand
// loads. Fragment layout of m16n8k16, with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9];
//   B (16 x 8), read from Bt[n][k] (k contiguous):
//                           b0 = Bt[g][2t..2t+1],  b1 = Bt[g][2t+8..2t+9];
//   C/D (16 x 8):           c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
// A 16 x 16 A-fragment is therefore two neighbouring C tiles (n-tiles 2j and
// 2j + 1) repacked to bf16, which is how a score or activation accumulator
// feeds the next product without a shared-memory round trip.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vit {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [0, 16) and columns [k0, k0 + 16) of a row-major tile
// in shared memory whose rows are `pitch` elements apart.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int pitch, int k0, int g, int t) {
  a[0] = ld32(tile + g * pitch + k0 + 2 * t);
  a[1] = ld32(tile + (g + 8) * pitch + k0 + 2 * t);
  a[2] = ld32(tile + g * pitch + k0 + 2 * t + 8);
  a[3] = ld32(tile + (g + 8) * pitch + k0 + 2 * t + 8);
}

// d += A · B for one 16 x 8 output tile, A given as fragments over k, B read
// from Bt rows n0..n0+7 (k contiguous, `pitch` apart), k from 0 to 16·KS.
template <int KS>
__device__ __forceinline__ void mma_row(float (&d)[4], const uint32_t (&a)[KS][4],
                                        const bf16* bt, int pitch, int n0,
                                        int g, int t) {
  const bf16* r = bt + (n0 + g) * pitch + 2 * t;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    mma_16816(d, a[ks], ld32(r + ks * 16), ld32(r + ks * 16 + 8));
}

}  // namespace vit
