// K3 / K4: the frozen ConvNeXt block tail, forward and input gradient, for
// Hopper (sm_90a).
//
// Replace the Pallas kernels vit_tpu/kernels/convnext_block.py:_fwd_kernel
// (:89, launched by _fwd_impl :248) and _bwd_kernel (:109, launched by
// _bwd_impl :276), behind frozen_convnext_block_tail (:457). On rows
// (N, C) = the flattened B·H·W of a channels-last activation:
//   K3: y  = x + γ ⊙ (gelu(LN(h)·W1 + b1)·W2 + b2)
//   K4: dh from dy, recomputing z from h:
//       do = γ⊙dy; da = do·W2ᵀ; dz = da⊙gelu′(z); du = dz·W1ᵀ;
//       dh = rstd·(dû − mean(dû) − û·mean(dû⊙û)), dû = du⊙ln_scale.
// LN eps is given (1e-6), with the two-pass fp32 statistics of :80-86. GELU
// is the tanh-composed erf of vit_tpu/ops/gelu.py, and gelu′ its flat
// derivative (:60-77). Rounding points follow the Pallas kernels: every
// parameter is bf16 (γ = 1e-6 rounds); u, a, do and dz are cast to bf16 before
// their products; accumulators and LN statistics are fp32.
//
// Weights arrive in PyTorch's Linear layout, which is exactly the B operand
// (k contiguous) each product needs: w1 (4C, C) for z = u·W1, w2 (C, 4C) for
// o = a·W2; the backward also takes w2t (4C, C) for da and w1t (C, 4C) for du,
// as the Pallas backward takes its transposed copies.
//
// What bounds it: 4·C·4C FLOP per row forward (6·C·4C backward) against 3·C·2
// bytes of h, x and y: the (N, 4C) intermediate and the LN output never
// reach device memory, as on the TPU. Unlike the TPU's VMEM, shared memory
// cannot hold the weights at C = 384 (W1 alone is 1.18 MB in bf16), so a block
// of 64 rows streams the 4C dimension in chunks of 32: per chunk it loads the
// W1 rows and W2 columns of the chunk, forms z and a for its rows in
// registers and shared memory, and adds the chunk's a·W2 into a 64 x C fp32
// accumulator held in the registers of its 8 warps (4 row groups x 2 column
// halves). The per-row epilogue (residual and γ, or the LN backward) runs once
// at the end of the tile. Every weight byte is re-read once per 64 rows, so
// the L2 → shared-memory traffic is 64 FLOP per byte; mma.sync m16n8k16,
// bf16 in, fp32 accumulate. cp.async double buffering of the chunks, wgmma
// and larger row tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"
#include "mma.cuh"

namespace {

using namespace vit;

constexpr int kRows = 64;     // rows per block
constexpr int kChunk = 32;    // 4C columns per streamed chunk
constexpr int kWarps = 8;
constexpr int kBlock = kWarps * 32;
constexpr int kChunkPitch = kChunk + 8;  // 40 bf16 = 80 bytes

__device__ __forceinline__ float bf(const bf16* p, int i) {
  return __bfloat162float(p[i]);
}

// Rows [r0, r0 + n) of a row-major (·, cols) matrix into shared memory with
// pitch cols + 8; 16-byte copies.
template <int kCols>
__device__ __forceinline__ void load_row_block(bf16* sm, const bf16* src,
                                               int r0, int n) {
  for (int i = threadIdx.x; i < n * (kCols / 8); i += kBlock) {
    const int r = i / (kCols / 8);
    const int c = (i % (kCols / 8)) * 8;
    *reinterpret_cast<uint4*>(sm + r * (kCols + 8) + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * kCols + c);
  }
}

// Columns [c0, c0 + kChunk) of every one of `rows` rows of a row-major
// (rows, stride) matrix into shared memory with pitch kChunkPitch.
__device__ __forceinline__ void load_col_block(bf16* sm, const bf16* src,
                                               int rows, int stride, int c0) {
  for (int i = threadIdx.x; i < rows * (kChunk / 8); i += kBlock) {
    const int r = i / (kChunk / 8);
    const int c = (i % (kChunk / 8)) * 8;
    *reinterpret_cast<uint4*>(sm + r * kChunkPitch + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * stride + c0 + c);
  }
}

// LayerNorm statistics of the block's rows (two-pass, fp32) and the affine
// output u = û·ln_scale + ln_bias, rounded to bf16, into sU. Rows at or past N
// read as zeros (û = 0, u = ln_bias: finite, never stored).
template <int C>
__device__ __forceinline__ void layer_norm_rows(
    bf16* sU, float* sMu, float* sRstd, const bf16* __restrict__ h,
    const bf16* __restrict__ lns, const bf16* __restrict__ lnb, int r0,
    int N, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = r0 + r;
    const bf16* hr = h + static_cast<size_t>(row) * C;
    float v[C / 32];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      v[j] = row < N ? bf(hr, lane + 32 * j) : 0.0f;
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
      const float uhat = v[j] * rstd;
      sU[r * (C + 8) + c] = __float2bfloat16(uhat * bf(lns, c) + bf(lnb, c));
    }
    if (lane == 0) {
      sMu[r] = mu;
      sRstd[r] = rstd;
    }
  }
}

// acc (16 x 16: two n-tiles) += rows [0, 16) of the row-major tile `a`
// (pitch C + 8) times Bt rows n0..n0+15 of `bt` (pitch C + 8), over k < C.
template <int C>
__device__ __forceinline__ void product_k_c(float (&acc)[2][4], const bf16* a,
                                            const bf16* bt, int n0, int g,
                                            int t) {
#pragma unroll 4
  for (int ks = 0; ks < C / 16; ++ks) {
    uint32_t af[4];
    load_a(af, a, C + 8, ks * 16, g, t);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16* r = bt + (n0 + j * 8 + g) * (C + 8) + ks * 16 + 2 * t;
      mma_16816(acc[j], af, ld32(r), ld32(r + 8));
    }
  }
}

// acc (16 x C/2: C/16 n-tiles) += rows [0, 16) of the chunk tile `a` (pitch
// kChunkPitch) times Bt rows n0.. of `bt` (pitch kChunkPitch), k < kChunk.
template <int C>
__device__ __forceinline__ void product_k_chunk(float (&acc)[C / 16][4],
                                                const bf16* a, const bf16* bt,
                                                int n0, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < kChunk / 16; ++ks) {
    uint32_t af[4];
    load_a(af, a, kChunkPitch, ks * 16, g, t);
#pragma unroll
    for (int nt = 0; nt < C / 16; ++nt) {
      const bf16* r = bt + (n0 + nt * 8 + g) * kChunkPitch + ks * 16 + 2 * t;
      mma_16816(acc[nt], af, ld32(r), ld32(r + 8));
    }
  }
}

template <int C>
constexpr size_t fwd_smem_bytes() {
  return sizeof(bf16) * (kRows * (C + 8) + kChunk * (C + 8) +
                         C * kChunkPitch + kRows * kChunkPitch) +
         sizeof(float) * 2 * kRows;
}

template <int C>
__global__ void __launch_bounds__(kBlock)
convnext_tail_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ x,
                         const bf16* __restrict__ lns,
                         const bf16* __restrict__ lnb,
                         const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                         const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                         const bf16* __restrict__ gamma, bf16* __restrict__ y,
                         int N, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sU = reinterpret_cast<bf16*>(smem);           // [64][C + 8]
  bf16* sW1 = sU + kRows * (C + 8);                    // [32][C + 8]: W1 rows
  bf16* sW2 = sW1 + kChunk * (C + 8);                  // [C][40]: W2 columns
  bf16* sAct = sW2 + C * kChunkPitch;                  // [64][40]: a, bf16
  float* sMu = reinterpret_cast<float*>(sAct + kRows * kChunkPitch);
  float* sRstd = sMu + kRows;

  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp & 3;   // rows rg·16 .. + 16
  const int ch = warp >> 2;  // z columns ch·16 .. + 16 of a chunk; o columns
                             // ch·C/2 .. + C/2

  layer_norm_rows<C>(sU, sMu, sRstd, h, lns, lnb, r0, N, eps);

  float o[C / 16][4];
#pragma unroll
  for (int nt = 0; nt < C / 16; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;

  for (int f0 = 0; f0 < 4 * C; f0 += kChunk) {
    __syncthreads();  // LN done / previous chunk's readers done
    load_row_block<C>(sW1, w1, f0, kChunk);
    load_col_block(sW2, w2, C, 4 * C, f0);
    __syncthreads();

    float z[2][4] = {};
    product_k_c<C>(z, sU + rg * 16 * (C + 8), sW1, ch * 16, g, t);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = ch * 16 + j * 8 + 2 * t;
      const float bb0 = bf(b1, f0 + col), bb1 = bf(b1, f0 + col + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rg * 16 + g + r * 8;
        *reinterpret_cast<uint32_t*>(sAct + row * kChunkPitch + col) =
            pack_bf16x2(gelu(z[j][2 * r] + bb0), gelu(z[j][2 * r + 1] + bb1));
      }
    }
    __syncthreads();
    product_k_chunk<C>(o, sAct + rg * 16 * kChunkPitch, sW2, ch * (C / 2), g, t);
  }

  // y = x + γ·(o + b2), rows below N.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + rg * 16 + g + r * 8;
    if (row >= N) continue;
#pragma unroll
    for (int nt = 0; nt < C / 16; ++nt) {
      const int col = ch * (C / 2) + nt * 8 + 2 * t;
      const size_t i = static_cast<size_t>(row) * C + col;
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + i);
      const float y0 = __bfloat162float(xv.x) +
                       bf(gamma, col) * (o[nt][2 * r] + bf(b2, col));
      const float y1 = __bfloat162float(xv.y) +
                       bf(gamma, col + 1) * (o[nt][2 * r + 1] + bf(b2, col + 1));
      *reinterpret_cast<uint32_t*>(y + i) = pack_bf16x2(y0, y1);
    }
  }
}

template <int C>
constexpr size_t bwd_smem_bytes() {
  return sizeof(bf16) * (2 * kRows * (C + 8) + 2 * kChunk * (C + 8) +
                         C * kChunkPitch + kRows * kChunkPitch) +
         sizeof(float) * 6 * kRows;
}

template <int C>
__global__ void __launch_bounds__(kBlock)
convnext_tail_bwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ dy,
                         const bf16* __restrict__ lns,
                         const bf16* __restrict__ lnb,
                         const bf16* __restrict__ w1, const bf16* __restrict__ w1t,
                         const bf16* __restrict__ w2t,
                         const bf16* __restrict__ b1,
                         const bf16* __restrict__ gamma, bf16* __restrict__ dh,
                         int N, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sU = reinterpret_cast<bf16*>(smem);    // [64][C + 8]: u
  bf16* sDO = sU + kRows * (C + 8);             // [64][C + 8]: bf16(γ·dy)
  bf16* sW1 = sDO + kRows * (C + 8);            // [32][C + 8]: W1 rows (z)
  bf16* sW2 = sW1 + kChunk * (C + 8);           // [32][C + 8]: W2ᵀ rows (da)
  bf16* sW1c = sW2 + kChunk * (C + 8);          // [C][40]: W1ᵀ columns (du)
  bf16* sDZ = sW1c + C * kChunkPitch;           // [64][40]: dz, bf16
  float* sMu = reinterpret_cast<float*>(sDZ + kRows * kChunkPitch);
  float* sRstd = sMu + kRows;
  float* sSum1 = sRstd + kRows;  // [2][64]: Σ dû per column half
  float* sSum2 = sSum1 + 2 * kRows;  // [2][64]: Σ dû·û

  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp & 3;
  const int ch = warp >> 2;

  layer_norm_rows<C>(sU, sMu, sRstd, h, lns, lnb, r0, N, eps);
  for (int i = threadIdx.x; i < kRows * (C / 8); i += kBlock) {
    const int r = i / (C / 8);
    const int c = (i % (C / 8)) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N)
      raw = *reinterpret_cast<const uint4*>(dy + static_cast<size_t>(r0 + r) * C + c);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
    uint4 packed;
    bf16* out = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[j] = __float2bfloat16(__bfloat162float(v[j]) * bf(gamma, c + j));
    *reinterpret_cast<uint4*>(sDO + r * (C + 8) + c) = packed;
  }

  float du[C / 16][4];
#pragma unroll
  for (int nt = 0; nt < C / 16; ++nt) du[nt][0] = du[nt][1] = du[nt][2] = du[nt][3] = 0.0f;

  for (int f0 = 0; f0 < 4 * C; f0 += kChunk) {
    __syncthreads();
    load_row_block<C>(sW1, w1, f0, kChunk);
    load_row_block<C>(sW2, w2t, f0, kChunk);
    load_col_block(sW1c, w1t, C, 4 * C, f0);
    __syncthreads();

    float z[2][4] = {}, da[2][4] = {};
    product_k_c<C>(z, sU + rg * 16 * (C + 8), sW1, ch * 16, g, t);
    product_k_c<C>(da, sDO + rg * 16 * (C + 8), sW2, ch * 16, g, t);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = ch * 16 + j * 8 + 2 * t;
      const float bb0 = bf(b1, f0 + col), bb1 = bf(b1, f0 + col + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rg * 16 + g + r * 8;
        *reinterpret_cast<uint32_t*>(sDZ + row * kChunkPitch + col) =
            pack_bf16x2(da[j][2 * r] * gelu_grad(z[j][2 * r] + bb0),
                        da[j][2 * r + 1] * gelu_grad(z[j][2 * r + 1] + bb1));
      }
    }
    __syncthreads();
    product_k_chunk<C>(du, sDZ + rg * 16 * kChunkPitch, sW1c, ch * (C / 2), g, t);
  }

  // LN backward. Each row's columns are spread over the 4 threads of a group
  // and the two column-half warps: per-row sums of dû and dû·û go through
  // shuffles, then shared memory.
  float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = rg * 16 + g + r * 8;
    const int row = r0 + lr;
    const float mu = sMu[lr], rstd = sRstd[lr];
#pragma unroll
    for (int nt = 0; nt < C / 16; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = ch * (C / 2) + nt * 8 + 2 * t + j;
        const float hv =
            row < N ? __bfloat162float(h[static_cast<size_t>(row) * C + col])
                    : 0.0f;
        const float uhat = (hv - mu) * rstd;
        const float dhat = du[nt][2 * r + j] * bf(lns, col);
        s1[r] += dhat;
        s2[r] += dhat * uhat;
      }
    }
    s1[r] += __shfl_xor_sync(0xffffffffu, s1[r], 1);
    s1[r] += __shfl_xor_sync(0xffffffffu, s1[r], 2);
    s2[r] += __shfl_xor_sync(0xffffffffu, s2[r], 1);
    s2[r] += __shfl_xor_sync(0xffffffffu, s2[r], 2);
    if (t == 0) {
      sSum1[ch * kRows + lr] = s1[r];
      sSum2[ch * kRows + lr] = s2[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = rg * 16 + g + r * 8;
    const int row = r0 + lr;
    if (row >= N) continue;
    const float mu = sMu[lr], rstd = sRstd[lr];
    const float c1 = (sSum1[lr] + sSum1[kRows + lr]) / C;
    const float c2 = (sSum2[lr] + sSum2[kRows + lr]) / C;
#pragma unroll
    for (int nt = 0; nt < C / 16; ++nt) {
      const int col = ch * (C / 2) + nt * 8 + 2 * t;
      const size_t i = static_cast<size_t>(row) * C + col;
      const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(h + i);
      const float u0 = (__bfloat162float(hv.x) - mu) * rstd;
      const float u1 = (__bfloat162float(hv.y) - mu) * rstd;
      const float d0 = du[nt][2 * r] * bf(lns, col);
      const float d1 = du[nt][2 * r + 1] * bf(lns, col + 1);
      *reinterpret_cast<uint32_t*>(dh + i) =
          pack_bf16x2(rstd * (d0 - c1 - u0 * c2), rstd * (d1 - c1 - u1 * c2));
    }
  }
}

template <int C>
int launch_fwd(const void* h, const void* x, const void* lns, const void* lnb,
               const void* w1, const void* b1, const void* w2, const void* b2,
               const void* gamma, void* y, int N, float eps,
               cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(
      convnext_tail_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  convnext_tail_fwd_kernel<C><<<(N + kRows - 1) / kRows, kBlock, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(x),
      static_cast<const bf16*>(lns), static_cast<const bf16*>(lnb),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<const bf16*>(gamma), static_cast<bf16*>(y), N, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_bwd(const void* h, const void* dy, const void* lns, const void* lnb,
               const void* w1, const void* w1t, const void* w2t, const void* b1,
               const void* gamma, void* dh, int N, float eps,
               cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(
      convnext_tail_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  convnext_tail_bwd_kernel<C><<<(N + kRows - 1) / kRows, kBlock, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(lns), static_cast<const bf16*>(lnb),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w1t),
      static_cast<const bf16*>(w2t), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(gamma), static_cast<bf16*>(dh), N, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h, x, y: (N, C) bf16; lns, lnb, b2, gamma: (C,) bf16; w1: (4C, C) bf16;
// b1: (4C,) bf16; w2: (C, 4C) bf16. All contiguous and 16-byte aligned.
// C in {96, 192, 384}. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for another C).
extern "C" int convnext_tail_fwd(const void* h, const void* x, const void* lns,
                                 const void* lnb, const void* w1, const void* b1,
                                 const void* w2, const void* b2,
                                 const void* gamma, void* y, int N, int C,
                                 float eps, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return launch_fwd<96>(h, x, lns, lnb, w1, b1, w2, b2, gamma, y, N, eps, st);
    case 192: return launch_fwd<192>(h, x, lns, lnb, w1, b1, w2, b2, gamma, y, N, eps, st);
    case 384: return launch_fwd<384>(h, x, lns, lnb, w1, b1, w2, b2, gamma, y, N, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// h, dy, dh: (N, C) bf16; w1: (4C, C), w1t: (C, 4C), w2t: (4C, C) bf16; lns,
// lnb, gamma: (C,) bf16; b1: (4C,) bf16. C in {96, 192, 384}.
extern "C" int convnext_tail_bwd(const void* h, const void* dy, const void* lns,
                                 const void* lnb, const void* w1,
                                 const void* w1t, const void* w2t,
                                 const void* b1, const void* gamma, void* dh,
                                 int N, int C, float eps, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return launch_bwd<96>(h, dy, lns, lnb, w1, w1t, w2t, b1, gamma, dh, N, eps, st);
    case 192: return launch_bwd<192>(h, dy, lns, lnb, w1, w1t, w2t, b1, gamma, dh, N, eps, st);
    case 384: return launch_bwd<384>(h, dy, lns, lnb, w1, w1t, w2t, b1, gamma, dh, N, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
