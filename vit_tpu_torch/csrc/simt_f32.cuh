// The fp32 forms' shared pieces: element-type helpers for kernels templated
// on their row type (bf16 or fp32), and a register-blocked fp32 tile product
// on the CUDA cores.
//
// Why not the tensor cores: the JAX package runs its Pallas kernels on fp32
// operands at Precision.HIGHEST, full fp32 products. The tensor cores' fp32
// path is TF32 (10 mantissa bits), and the bf16 kernels' mma.sync fragments
// pack two bf16 values per register with no fp32 fragment of that shape, so
// the fp32 forms multiply with plain fmaf on the CUDA cores. fp32 is the
// parity and debug mode of the port, not a speed mode; their ceiling is the
// card's fp32 FMA rate, which fma_probe.cu measures.
//
// The tile product: a block of 256 threads seen as 16 x 16 (ty = tid / 16,
// tx = tid % 16). Thread (ty, tx) owns rows ty + 16·i (i < TM) and columns
// tx + 16·j (j < TN) of a (16·TM) x (16·TN) output tile, so a half-warp
// shares its rows (A values broadcast) and reads 16 neighbouring B columns.
// Operands sit in shared memory, either orientation:
//   A(r, k) = kAT ? a[k·lda + r] : a[r·lda + k]
//   B(k, c) = kBT ? b[c·ldb + k] : b[k·ldb + c]
// A warp reads two rows of A (broadcast within each half) and 16 columns of
// B, so a row-major A or a transposed B wants a pitch that is odd modulo 32
// to keep those reads on distinct banks. Every product here is a chain of
// fmaf in k order, one rounding per step.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vit {

constexpr int kSimtSide = 16;
constexpr int kSimtThreads = kSimtSide * kSimtSide;

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

__device__ __forceinline__ int simt_ty() { return threadIdx.x / kSimtSide; }
__device__ __forceinline__ int simt_tx() { return threadIdx.x % kSimtSide; }

template <int TM, int TN>
__device__ __forceinline__ void simt_zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
}

// acc[i][j] += Σ_{k < K} A(ty + 16i, k) · B(k, tx + 16j).
template <int TM, int TN, bool kAT, bool kBT>
__device__ __forceinline__ void simt_product(float (&acc)[TM][TN],
                                             const float* a, int lda,
                                             const float* b, int ldb, int K) {
  const int ty = simt_ty(), tx = simt_tx();
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = kAT ? a[k * lda + ty + 16 * i] : a[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      bv[j] = kBT ? b[(tx + 16 * j) * ldb + k] : b[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Sum of v over the 16 threads of a half-warp (one tile row of threads).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 1; o < kSimtSide; o *= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace vit
