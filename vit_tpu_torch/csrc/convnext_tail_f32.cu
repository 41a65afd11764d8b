// The fp32 form of K4, the frozen ConvNeXt block tail's input gradient, for
// Hopper (sm_90a). (K3's fp32 form is convnext_tail.cu's kernel with
// kParts = 3.)
//
// Replaces the Pallas kernel vit_tpu/kernels/convnext_block.py:_bwd_kernel
// (:109, launched by _bwd_impl :276) when it runs on fp32 rows, where its
// products run at Precision.HIGHEST (:117). The math of convnext_tail.cu's
// K4 without its bf16 casts, on rows (N, C) with fp32 parameters:
//   u = LN(h)·lns + lnb; z = u·W1ᵀ + b1; do = γ⊙dy; da = do·W2;
//   dz = da⊙gelu′(z); du = dz·W1;
//   dh = rstd·(dû − mean(dû) − û·mean(dû⊙û)), dû = du⊙lns
// with the two-pass fp32 LN statistics and the tanh-erf GELU derivative of
// gelu.cuh. W1 (4C, C) and W2 (C, 4C) come in PyTorch's Linear layout; the
// SIMT products read either orientation, so no transposed copies are made.
//
// Design: a block of 256 threads owns 32 rows and keeps them on chip: the
// LN output u and γ⊙dy as 32 x C fp32 tiles in shared memory and the
// 32 x C accumulator of du in registers (each thread 2 rows x C/16
// columns). It walks the 4C dimension in chunks of 64: z and da for the
// chunk from u and γ⊙dy against W1 and W2 streamed through shared memory in
// pieces of 32 columns of C, then dz into shared memory, then du += dz·W1
// against the chunk's W1 rows, streamed in pieces of 16 rows. The (N, 4C)
// intermediates never reach device memory, as on the TPU. 32 rows, so that
// u, γ⊙dy and the pieces fit in 227 KB.
//
// What bounds it: 24·C² FLOP per row against 3·C·4 bytes of rows: the CUDA
// cores' fp32 FMA rate (fma_probe.cu), far from the memory. Weights are
// re-read from L2 once per block.

#include <cuda_runtime.h>
#include <math.h>

#include "gelu.cuh"
#include "simt_f32.cuh"

namespace {

using namespace vit;

constexpr int kBwdRows = 32;
constexpr int kF = 64;       // 4C columns per chunk
constexpr int kKc = 32;      // C columns per streamed W1 (W2ᵀ) piece
constexpr int kKf = 16;      // 4C rows per streamed second-product piece
constexpr int kFP = kF + 1;
constexpr int kKcP = kKc + 1;
constexpr int kWarps = kSimtThreads / 32;

// LayerNorm of rows [r0, r0 + R) of h into sU (pitch C + 1): two-pass fp32
// statistics, u = û·lns + lnb, and the statistics into sMu, sRstd. Rows at
// or past N read as zeros (u = lnb: finite, never stored).
template <int C, int R>
__device__ __forceinline__ void layer_norm_rows(float* sU, float* sMu,
                                                float* sRstd,
                                                const float* __restrict__ h,
                                                const float* __restrict__ lns,
                                                const float* __restrict__ lnb,
                                                int r0, int N, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += kWarps) {
    const int row = r0 + r;
    const float* hr = h + static_cast<size_t>(row) * C;
    float v[C / 32];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      v[j] = row < N ? hr[lane + 32 * j] : 0.0f;
      sum += v[j];
    }
    const float mu = warp_sum(sum) / C;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      v[j] -= mu;
      sq += v[j] * v[j];
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      sU[r * (C + 1) + c] = v[j] * rstd * lns[c] + lnb[c];
    }
    if (lane == 0) {
      sMu[r] = mu;
      sRstd[r] = rstd;
    }
  }
}

// Rows [r0, r0 + rows) x columns [c0, c0 + cols) of a row-major (·, ld)
// matrix into sm with pitch `pitch`.
__device__ __forceinline__ void load_block(float* sm, int pitch,
                                           const float* __restrict__ src,
                                           int ld, int r0, int rows, int c0,
                                           int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += kSimtThreads) {
    const int r = i / cols, c = i % cols;
    sm[r * pitch + c] = src[static_cast<size_t>(r0 + r) * ld + c0 + c];
  }
}

template <int C>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (2 * kBwdRows * (C + 1) + kF * kKcP + kKc * kFP +
                          kBwdRows * kFP + kKf * (C + 1) + 2 * kBwdRows);
}

template <int C>
__global__ void __launch_bounds__(kSimtThreads)
convnext_tail_f32_bwd_kernel(const float* __restrict__ h,
                             const float* __restrict__ dy,
                             const float* __restrict__ lns,
                             const float* __restrict__ lnb,
                             const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const float* __restrict__ w2,
                             const float* __restrict__ gamma,
                             float* __restrict__ dh, int N, float eps) {
  constexpr int R = kBwdRows, TM = R / kSimtSide, TC = C / kSimtSide;
  constexpr int TF = kF / kSimtSide;
  extern __shared__ float smem[];
  float* sU = smem;                    // [R][C + 1]: u
  float* sDO = sU + R * (C + 1);       // [R][C + 1]: γ⊙dy
  float* sW1 = sDO + R * (C + 1);      // [64][33]: W1 rows f, columns c
  float* sW2 = sW1 + kF * kKcP;        // [32][65]: W2 rows c, columns f
  float* sDZ = sW2 + kKc * kFP;        // [R][65]: dz
  float* sW1r = sDZ + R * kFP;         // [16][C + 1]: W1 rows f, every c
  float* sMu = sW1r + kKf * (C + 1);
  float* sRstd = sMu + R;

  const int r0 = blockIdx.x * R;
  const int ty = simt_ty(), tx = simt_tx();
  layer_norm_rows<C, R>(sU, sMu, sRstd, h, lns, lnb, r0, N, eps);
  for (int i = threadIdx.x; i < R * C; i += kSimtThreads) {
    const int r = i / C, c = i % C;
    sDO[r * (C + 1) + c] =
        r0 + r < N ? dy[static_cast<size_t>(r0 + r) * C + c] * gamma[c] : 0.0f;
  }

  float du[TM][TC];
  simt_zero(du);
  for (int f0 = 0; f0 < 4 * C; f0 += kF) {
    float z[TM][TF], da[TM][TF];
    simt_zero(z);
    simt_zero(da);
    for (int c0 = 0; c0 < C; c0 += kKc) {
      __syncthreads();
      load_block(sW1, kKcP, w1, C, f0, kF, c0, kKc);
      load_block(sW2, kFP, w2, 4 * C, c0, kKc, f0, kF);
      __syncthreads();
      simt_product<TM, TF, false, true>(z, sU + c0, C + 1, sW1, kKcP, kKc);
      simt_product<TM, TF, false, false>(da, sDO + c0, C + 1, sW2, kFP, kKc);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TF; ++j)
        sDZ[(ty + 16 * i) * kFP + tx + 16 * j] =
            da[i][j] * gelu_grad(z[i][j] + b1[f0 + tx + 16 * j]);
    for (int f1 = 0; f1 < kF; f1 += kKf) {
      __syncthreads();
      load_block(sW1r, C + 1, w1, C, f0 + f1, kKf, 0, C);
      __syncthreads();
      simt_product<TM, TC, false, false>(du, sDZ + f1, kFP, sW1r, C + 1, kKf);
    }
  }

  // LN backward: per-row sums of dû and dû·û over the 16 threads of a row.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int lr = ty + 16 * i, row = r0 + lr;
    const float mu = sMu[lr], rstd = sRstd[lr];
    float uhat[TC], s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = tx + 16 * j;
      const float hv = row < N ? h[static_cast<size_t>(row) * C + col] : 0.0f;
      uhat[j] = (hv - mu) * rstd;
      du[i][j] *= lns[col];   // dû
      s1 += du[i][j];
      s2 += du[i][j] * uhat[j];
    }
    const float c1 = row_sum16(s1) / C, c2 = row_sum16(s2) / C;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < TC; ++j)
      dh[static_cast<size_t>(row) * C + tx + 16 * j] =
          rstd * (du[i][j] - c1 - uhat[j] * c2);
  }
}

template <int C>
int launch_bwd(const void* h, const void* dy, const void* lns, const void* lnb,
               const void* w1, const void* b1, const void* w2,
               const void* gamma, void* dh, int N, float eps,
               cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(
      convnext_tail_f32_bwd_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  convnext_tail_f32_bwd_kernel<C>
      <<<(N + kBwdRows - 1) / kBwdRows, kSimtThreads, smem, stream>>>(
          static_cast<const float*>(h), static_cast<const float*>(dy),
          static_cast<const float*>(lns), static_cast<const float*>(lnb),
          static_cast<const float*>(w1), static_cast<const float*>(b1),
          static_cast<const float*>(w2), static_cast<const float*>(gamma),
          static_cast<float*>(dh), N, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h, dy, dh: (N, C) fp32; lns, lnb, gamma: (C,); w1: (4C, C); b1: (4C,);
// w2: (C, 4C); all fp32 and contiguous. C in {96, 192, 384}.
extern "C" int convnext_tail_f32_bwd(const void* h, const void* dy,
                                     const void* lns, const void* lnb,
                                     const void* w1, const void* b1,
                                     const void* w2, const void* gamma,
                                     void* dh, int N, int C, float eps,
                                     void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return launch_bwd<96>(h, dy, lns, lnb, w1, b1, w2, gamma, dh, N, eps, st);
    case 192: return launch_bwd<192>(h, dy, lns, lnb, w1, b1, w2, gamma, dh, N, eps, st);
    case 384: return launch_bwd<384>(h, dy, lns, lnb, w1, b1, w2, gamma, dh, N, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
