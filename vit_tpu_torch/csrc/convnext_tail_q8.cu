// K12a / K12b: the int8 frozen ConvNeXt block tail, forward and input
// gradient, for Hopper (sm_90a).
//
// Replace the Pallas kernels vit_tpu/kernels/convnext_block.py:_fwd_kernel_q8
// (:148, launched by _fwd_impl_q8 :310) and _bwd_kernel_q8 (:172, launched
// by _bwd_impl_q8 :342), the quant="int8" form of K3/K4 behind
// frozen_convnext_block_tail (:457). On rows (N, C):
//   K12a: u = LN(h)·lns + lnb; (uq, su) = q(u); z = (uq·W1q)·su·s1 + b1;
//         (aq, sa) = q(gelu(z)); o = (aq·W2q)·sa·s2 + b2; y = x + γ⊙o
//   K12b: z as above; (dq, sd) = q(γ⊙dy); da = (dq·W2ᵀq)·sd·s2ᵀ;
//         (gq, sg) = q(da⊙gelu′(z)); du = (gq·W1ᵀq)·sg·s1ᵀ;
//         dh = rstd·(dû − mean(dû) − û·mean(dû⊙û)), dû = du⊙lns
// where q(v) is the per-row symmetric int8 quantization of _quant_rows
// (:140-145): s = max(absmax, 1e-8)·(1/127), q = clip(rint(v / s), ±127),
// round half to even. The weights arrive quantized per output channel by the
// wrapper (_quant_cols, :204-212), each as an (n, k) operand with k
// contiguous: W1q (4C, C), W2q (C, 4C), W2ᵀq (4C, C), W1ᵀq (C, 4C), with fp32
// scales; lns, lnb, b1, b2 and γ in the row type, read in fp32. The rows
// (h, x or dy, y or dh) and those vectors are bf16, or fp32 in the
// convnext_tail_*_q8_f32 entries, as _fwd_kernel_q8 reads rows of any dtype
// (the kernels are templated on that type only). Every product is
// mma.sync m16n8k32 on int8 with an int32 accumulator, exact as on the MXU,
// and rescaled as ((float)acc·s_row)·s_col + bias. LN statistics are the
// two-pass fp32 ones of _normalize (:80-86); GELU and gelu′ the tanh-erf
// pair of gelu.cuh.
//
// The design trap: K3/K4 stream the 4C dimension in chunks and add each
// chunk's a·W2 as it goes, but a (and dz in the backward) is quantized with
// the absmax of its whole 4C-wide row, which is known only after every
// chunk. So each 64-row block makes two passes over 4C: the first computes
// z (and da) chunk by chunk and keeps only the row absmax of gelu(z) (of
// dz); the second recomputes them with the same instructions, quantizes
// with the now known scale and accumulates the second product, as K3/K4 do,
// in a 64 x C int32 accumulator in the registers of 8 warps (4 row groups x
// 2 column halves). The first product is recomputed, at the int8 rate: 3
// products forward and 5 backward where the TPU kernel does 2 and 3. The
// scales of u and do (absmax over C) are known up front.
//
// What bounds it: 2·2·C·4C int8 operations per row forward (3 products
// backward) against 3·C·2 bytes of rows; the (N, 4C) intermediate never
// reaches device memory. The weights (4C·C bytes each) stream from L2 once
// per 64 rows, in chunks of 64 of the 4C dimension; cp.async pipelining,
// wgmma and larger tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"
#include "mma.cuh"
#include "simt_f32.cuh"

namespace {

using namespace vit;

constexpr int kRows = 64;      // rows per block
constexpr int kChunk = 64;     // 4C columns per streamed chunk
constexpr int kWarps = 8;
constexpr int kBlock = kWarps * 32;
constexpr int kChunkPitch = kChunk + 16;   // bytes; 20 words: no bank conflicts
constexpr float kInv127 = 1.0f / 127.0f;

template <int C>
__host__ __device__ constexpr int pitch() { return C + 16; }  // bytes of an int8 row

template <typename T>
__device__ __forceinline__ float bf(const T* p, int i) {
  return to_f(p[i]);
}

__device__ __forceinline__ int quantize(float v, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(v / s), -127.0f), 127.0f));
}

// Rows [r0, r0 + n) of a row-major int8 (·, kCols) matrix into shared memory
// with pitch kCols + 16; 16-byte copies.
template <int kCols>
__device__ __forceinline__ void load_rows(int8_t* sm, const int8_t* src, int r0,
                                          int n) {
  for (int i = threadIdx.x; i < n * (kCols / 16); i += kBlock) {
    const int r = i / (kCols / 16);
    const int c = (i % (kCols / 16)) * 16;
    *reinterpret_cast<uint4*>(sm + r * (kCols + 16) + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * kCols + c);
  }
}

// Columns [c0, c0 + kChunk) of every one of `rows` rows of a row-major int8
// (rows, stride) matrix into shared memory with pitch kChunkPitch.
__device__ __forceinline__ void load_cols(int8_t* sm, const int8_t* src,
                                          int rows, int stride, int c0) {
  for (int i = threadIdx.x; i < rows * (kChunk / 16); i += kBlock) {
    const int r = i / (kChunk / 16);
    const int c = (i % (kChunk / 16)) * 16;
    *reinterpret_cast<uint4*>(sm + r * kChunkPitch + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * stride + c0 + c);
  }
}

// The values v[j] (column lane + 32j) of one row, held by a warp: their
// per-row int8 quantization into dst and the scale into *scale.
template <int C>
__device__ __forceinline__ void quantize_row(const float (&v)[C / 32],
                                             int8_t* dst, float* scale,
                                             int lane) {
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < C / 32; ++j) amax = fmaxf(amax, fabsf(v[j]));
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(amax, 1e-8f) * kInv127;
#pragma unroll
  for (int j = 0; j < C / 32; ++j)
    dst[lane + 32 * j] = static_cast<int8_t>(quantize(v[j], s));
  if (lane == 0) *scale = s;
}

// LayerNorm of the block's rows (two-pass fp32 statistics), u = û·lns + lnb
// in fp32, quantized per row into sU with its scale in sUs. Rows at or past
// N read as zeros (u = lnb: finite, never stored).
template <int C, typename T>
__device__ __forceinline__ void ln_quant_rows(int8_t* sU, float* sUs,
                                              float* sMu, float* sRstd,
                                              const T* __restrict__ h,
                                              const T* __restrict__ lns,
                                              const T* __restrict__ lnb,
                                              int r0, int N, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = r0 + r;
    const T* hr = h + static_cast<size_t>(row) * C;
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
      v[j] = v[j] * rstd * bf(lns, c) + bf(lnb, c);
    }
    quantize_row<C>(v, sU + r * pitch<C>(), sUs + r, lane);
    if (lane == 0 && sMu != nullptr) {
      sMu[r] = mu;
      sRstd[r] = rstd;
    }
  }
}

// acc (16 x 8·NT) += rows [0, 16) of the int8 tile `a` (pitch pa bytes)
// times Bt rows n0 .. n0 + 8·NT of `bt` (pitch pb bytes), over k < K.
template <int K, int NT>
__device__ __forceinline__ void product(int (&acc)[NT][4], const int8_t* a,
                                        int pa, const int8_t* bt, int pb,
                                        int n0, int g, int t) {
#pragma unroll 4
  for (int ks = 0; ks < K / 32; ++ks) {
    const int8_t* ar = a + ks * 32 + 4 * t;
    const uint32_t af[4] = {ld32(ar + g * pa), ld32(ar + (g + 8) * pa),
                            ld32(ar + g * pa + 16), ld32(ar + (g + 8) * pa + 16)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int8_t* r = bt + (n0 + nt * 8 + g) * pb + ks * 32 + 4 * t;
      mma_s8_16832(acc[nt], af, ld32(r), ld32(r + 16));
    }
  }
}

// The largest |v| of rows g and g + 8 of a warp's 16-row group, over its
// four lanes t, into sMax[ch][row]: a column half's share of the row absmax.
__device__ __forceinline__ void store_row_max(float (&m)[2], float* sMax,
                                              int ch, int rg, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    if (t == 0) sMax[ch * kRows + rg * 16 + g + 8 * r] = m[r];
  }
}

// z = (uq·W1q)·su·s1 + b1 for the warp's 16 rows and 32 columns of the
// chunk at f0: the int32 tile z and its fp32 value at (j, e) of row r.
template <int C>
struct ZTile {
  int acc[4][4];
  __device__ __forceinline__ void compute(const int8_t* sU, const int8_t* sW1,
                                          int rg, int ch, int g, int t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    product<C, 4>(acc, sU + rg * 16 * pitch<C>(), pitch<C>(), sW1, pitch<C>(),
                  ch * 32, g, t);
  }
  __device__ __forceinline__ float value(int j, int r, int e, float su,
                                         float s1, float b1) const {
    return static_cast<float>(acc[j][2 * r + e]) * su * s1 + b1;
  }
};

template <int C>
constexpr size_t fwd_smem_bytes() {
  return kRows * pitch<C>() + kChunk * pitch<C>() + C * kChunkPitch +
         kRows * kChunkPitch + sizeof(float) * 4 * kRows;
}

template <int C, typename T>
__global__ void __launch_bounds__(kBlock)
convnext_tail_fwd_q8_kernel(const T* __restrict__ h, const T* __restrict__ x,
                            const T* __restrict__ lns,
                            const T* __restrict__ lnb,
                            const int8_t* __restrict__ w1q,
                            const float* __restrict__ w1s,
                            const T* __restrict__ b1,
                            const int8_t* __restrict__ w2q,
                            const float* __restrict__ w2s,
                            const T* __restrict__ b2,
                            const T* __restrict__ gamma, T* __restrict__ y,
                            int N, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sU = reinterpret_cast<int8_t*>(smem);      // [64][C + 16]: uq
  int8_t* sW1 = sU + kRows * pitch<C>();              // [64][C + 16]: W1q rows
  int8_t* sW2 = sW1 + kChunk * pitch<C>();            // [C][80]: W2q columns
  int8_t* sAct = sW2 + C * kChunkPitch;               // [64][80]: aq
  float* sUs = reinterpret_cast<float*>(sAct + kRows * kChunkPitch);
  float* sMax = sUs + kRows;                          // [2][64]
  float* sAs = sMax + 2 * kRows;                      // [64]: a's scales

  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp & 3;   // rows rg·16 .. + 16
  const int ch = warp >> 2;  // z columns ch·32 .. + 32 of a chunk; o columns
                             // ch·C/2 .. + C/2

  ln_quant_rows<C, T>(sU, sUs, nullptr, nullptr, h, lns, lnb, r0, N, eps);
  ZTile<C> z;

  // Pass 1: the row absmax of a = gelu(z) over all 4C columns.
  float amax[2] = {0.0f, 0.0f};
  for (int f0 = 0; f0 < 4 * C; f0 += kChunk) {
    __syncthreads();
    load_rows<C>(sW1, w1q, f0, kChunk);
    __syncthreads();
    z.compute(sU, sW1, rg, ch, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = f0 + ch * 32 + j * 8 + 2 * t + e;
        const float s1 = w1s[f], bb = bf(b1, f);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          amax[r] = fmaxf(amax[r], fabsf(gelu(z.value(
                                       j, r, e, sUs[rg * 16 + g + 8 * r], s1, bb))));
      }
  }
  store_row_max(amax, sMax, ch, rg, g, t);
  __syncthreads();
  if (threadIdx.x < kRows)
    sAs[threadIdx.x] =
        fmaxf(fmaxf(sMax[threadIdx.x], sMax[kRows + threadIdx.x]), 1e-8f) * kInv127;

  // Pass 2: recompute z, quantize a with its row scale, o += aq·W2q.
  int o[C / 16][4];
#pragma unroll
  for (int nt = 0; nt < C / 16; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0;
  for (int f0 = 0; f0 < 4 * C; f0 += kChunk) {
    __syncthreads();
    load_rows<C>(sW1, w1q, f0, kChunk);
    load_cols(sW2, w2q, C, 4 * C, f0);
    __syncthreads();
    z.compute(sU, sW1, rg, ch, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = ch * 32 + j * 8 + 2 * t;
      const float s10 = w1s[f0 + col], s11 = w1s[f0 + col + 1];
      const float b10 = bf(b1, f0 + col), b11 = bf(b1, f0 + col + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rg * 16 + g + 8 * r;
        const float su = sUs[row], sa = sAs[row];
        char2 q;
        q.x = static_cast<signed char>(quantize(gelu(z.value(j, r, 0, su, s10, b10)), sa));
        q.y = static_cast<signed char>(quantize(gelu(z.value(j, r, 1, su, s11, b11)), sa));
        *reinterpret_cast<char2*>(sAct + row * kChunkPitch + col) = q;
      }
    }
    __syncthreads();
    product<kChunk, C / 16>(o, sAct + rg * 16 * kChunkPitch, kChunkPitch, sW2,
                            kChunkPitch, ch * (C / 2), g, t);
  }

  // y = x + γ·((o·sa)·s2 + b2), rows below N.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = rg * 16 + g + r * 8;
    const int row = r0 + lr;
    if (row >= N) continue;
    const float sa = sAs[lr];
#pragma unroll
    for (int nt = 0; nt < C / 16; ++nt) {
      const int col = ch * (C / 2) + nt * 8 + 2 * t;
      const size_t i = static_cast<size_t>(row) * C + col;
      const float2 xv = load2(x + i);
      const float o0 = static_cast<float>(o[nt][2 * r]) * sa * w2s[col] + bf(b2, col);
      const float o1 =
          static_cast<float>(o[nt][2 * r + 1]) * sa * w2s[col + 1] + bf(b2, col + 1);
      store2(y + i, xv.x + bf(gamma, col) * o0, xv.y + bf(gamma, col + 1) * o1);
    }
  }
}

template <int C>
constexpr size_t bwd_smem_bytes() {
  return 2 * kRows * pitch<C>() + 2 * kChunk * pitch<C>() + C * kChunkPitch +
         kRows * kChunkPitch + sizeof(float) * 11 * kRows;
}

template <int C, typename T>
__global__ void __launch_bounds__(kBlock)
convnext_tail_bwd_q8_kernel(const T* __restrict__ h, const T* __restrict__ dy,
                            const T* __restrict__ lns,
                            const T* __restrict__ lnb,
                            const int8_t* __restrict__ w1q,
                            const float* __restrict__ w1s,
                            const int8_t* __restrict__ w2tq,
                            const float* __restrict__ w2ts,
                            const int8_t* __restrict__ w1tq,
                            const float* __restrict__ w1ts,
                            const T* __restrict__ b1,
                            const T* __restrict__ gamma,
                            T* __restrict__ dh, int N, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sU = reinterpret_cast<int8_t*>(smem);  // [64][C + 16]: uq
  int8_t* sDO = sU + kRows * pitch<C>();          // [64][C + 16]: (γ⊙dy)q
  int8_t* sW1 = sDO + kRows * pitch<C>();         // [64][C + 16]: W1q rows
  int8_t* sW2 = sW1 + kChunk * pitch<C>();        // [64][C + 16]: W2ᵀq rows
  int8_t* sW1c = sW2 + kChunk * pitch<C>();       // [C][80]: W1ᵀq columns
  int8_t* sDZ = sW1c + C * kChunkPitch;           // [64][80]: dzq
  float* sUs = reinterpret_cast<float*>(sDZ + kRows * kChunkPitch);
  float* sDOs = sUs + kRows;
  float* sMu = sDOs + kRows;
  float* sRstd = sMu + kRows;
  float* sDZs = sRstd + kRows;
  float* sMax = sDZs + kRows;     // [2][64]
  float* sSum1 = sMax + 2 * kRows;  // [2][64]: Σ dû per column half
  float* sSum2 = sSum1 + 2 * kRows;  // [2][64]: Σ dû·û

  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp & 3;
  const int ch = warp >> 2;

  ln_quant_rows<C, T>(sU, sUs, sMu, sRstd, h, lns, lnb, r0, N, eps);
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = r0 + r;
    float v[C / 32];
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      v[j] = row < N ? bf(dy + static_cast<size_t>(row) * C, c) * bf(gamma, c) : 0.0f;
    }
    quantize_row<C>(v, sDO + r * pitch<C>(), sDOs + r, lane);
  }

  ZTile<C> z, da;
  // dz at (j, r, e) of the warp's tile of the chunk at f0
  auto dz_value = [&](int f0, int j, int r, int e) {
    const int f = f0 + ch * 32 + j * 8 + 2 * t + e;
    const int row = rg * 16 + g + 8 * r;
    const float zf = z.value(j, r, e, sUs[row], w1s[f], bf(b1, f));
    return da.value(j, r, e, sDOs[row], w2ts[f], 0.0f) * gelu_grad(zf);
  };

  // Pass 1: the row absmax of dz = da⊙gelu′(z) over all 4C columns.
  float amax[2] = {0.0f, 0.0f};
  for (int f0 = 0; f0 < 4 * C; f0 += kChunk) {
    __syncthreads();
    load_rows<C>(sW1, w1q, f0, kChunk);
    load_rows<C>(sW2, w2tq, f0, kChunk);
    __syncthreads();
    z.compute(sU, sW1, rg, ch, g, t);
    da.compute(sDO, sW2, rg, ch, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          amax[r] = fmaxf(amax[r], fabsf(dz_value(f0, j, r, e)));
  }
  store_row_max(amax, sMax, ch, rg, g, t);
  __syncthreads();
  if (threadIdx.x < kRows)
    sDZs[threadIdx.x] =
        fmaxf(fmaxf(sMax[threadIdx.x], sMax[kRows + threadIdx.x]), 1e-8f) * kInv127;

  // Pass 2: recompute dz, quantize it with its row scale, du += dzq·W1ᵀq.
  int du[C / 16][4];
#pragma unroll
  for (int nt = 0; nt < C / 16; ++nt) du[nt][0] = du[nt][1] = du[nt][2] = du[nt][3] = 0;
  for (int f0 = 0; f0 < 4 * C; f0 += kChunk) {
    __syncthreads();
    load_rows<C>(sW1, w1q, f0, kChunk);
    load_rows<C>(sW2, w2tq, f0, kChunk);
    load_cols(sW1c, w1tq, C, 4 * C, f0);
    __syncthreads();
    z.compute(sU, sW1, rg, ch, g, t);
    da.compute(sDO, sW2, rg, ch, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rg * 16 + g + 8 * r;
        const float s = sDZs[row];
        char2 q;
        q.x = static_cast<signed char>(quantize(dz_value(f0, j, r, 0), s));
        q.y = static_cast<signed char>(quantize(dz_value(f0, j, r, 1), s));
        *reinterpret_cast<char2*>(sDZ + row * kChunkPitch + ch * 32 + j * 8 + 2 * t) = q;
      }
    __syncthreads();
    product<kChunk, C / 16>(du, sDZ + rg * 16 * kChunkPitch, kChunkPitch, sW1c,
                            kChunkPitch, ch * (C / 2), g, t);
  }

  // LN backward with dû = ((du·sg)·s1ᵀ)⊙lns: per-row sums of dû and dû·û
  // through shuffles over the 4 lanes of a group and shared memory over the
  // two column halves, as K4.
  float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = rg * 16 + g + r * 8;
    const int row = r0 + lr;
    const float mu = sMu[lr], rstd = sRstd[lr], sg = sDZs[lr];
#pragma unroll
    for (int nt = 0; nt < C / 16; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = ch * (C / 2) + nt * 8 + 2 * t + e;
        const float hv =
            row < N ? to_f(h[static_cast<size_t>(row) * C + col]) : 0.0f;
        const float uhat = (hv - mu) * rstd;
        const float dhat =
            static_cast<float>(du[nt][2 * r + e]) * sg * w1ts[col] * bf(lns, col);
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
    const float mu = sMu[lr], rstd = sRstd[lr], sg = sDZs[lr];
    const float c1 = (sSum1[lr] + sSum1[kRows + lr]) / C;
    const float c2 = (sSum2[lr] + sSum2[kRows + lr]) / C;
#pragma unroll
    for (int nt = 0; nt < C / 16; ++nt) {
      const int col = ch * (C / 2) + nt * 8 + 2 * t;
      const size_t i = static_cast<size_t>(row) * C + col;
      const float2 hv = load2(h + i);
      const float u0 = (hv.x - mu) * rstd;
      const float u1 = (hv.y - mu) * rstd;
      const float d0 = static_cast<float>(du[nt][2 * r]) * sg * w1ts[col] * bf(lns, col);
      const float d1 =
          static_cast<float>(du[nt][2 * r + 1]) * sg * w1ts[col + 1] * bf(lns, col + 1);
      store2(dh + i, rstd * (d0 - c1 - u0 * c2), rstd * (d1 - c1 - u1 * c2));
    }
  }
}

template <int C, typename T>
int launch_fwd(const void* h, const void* x, const void* lns, const void* lnb,
               const void* w1q, const void* w1s, const void* b1, const void* w2q,
               const void* w2s, const void* b2, const void* gamma, void* y,
               int N, float eps, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(
      convnext_tail_fwd_q8_kernel<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  convnext_tail_fwd_q8_kernel<C, T><<<(N + kRows - 1) / kRows, kBlock, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(x),
      static_cast<const T*>(lns), static_cast<const T*>(lnb),
      static_cast<const int8_t*>(w1q), static_cast<const float*>(w1s),
      static_cast<const T*>(b1), static_cast<const int8_t*>(w2q),
      static_cast<const float*>(w2s), static_cast<const T*>(b2),
      static_cast<const T*>(gamma), static_cast<T*>(y), N, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int C, typename T>
int launch_bwd(const void* h, const void* dy, const void* lns, const void* lnb,
               const void* w1q, const void* w1s, const void* w2tq,
               const void* w2ts, const void* w1tq, const void* w1ts,
               const void* b1, const void* gamma, void* dh, int N, float eps,
               cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(
      convnext_tail_bwd_q8_kernel<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  convnext_tail_bwd_q8_kernel<C, T><<<(N + kRows - 1) / kRows, kBlock, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(dy),
      static_cast<const T*>(lns), static_cast<const T*>(lnb),
      static_cast<const int8_t*>(w1q), static_cast<const float*>(w1s),
      static_cast<const int8_t*>(w2tq), static_cast<const float*>(w2ts),
      static_cast<const int8_t*>(w1tq), static_cast<const float*>(w1ts),
      static_cast<const T*>(b1), static_cast<const T*>(gamma),
      static_cast<T*>(dh), N, eps);
  return static_cast<int>(cudaGetLastError());
}


// The C entries' bodies for bf16 rows (convnext_tail_*_q8) and fp32 rows
// (convnext_tail_*_q8_f32).
template <typename T>
int fwd_q8(const void* h, const void* x, const void* lns, const void* lnb,
           const void* w1q, const void* w1s, const void* b1, const void* w2q,
           const void* w2s, const void* b2, const void* gamma, void* y, int N,
           int C, float eps, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return launch_fwd<96, T>(h, x, lns, lnb, w1q, w1s, b1, w2q, w2s, b2, gamma, y, N, eps, st);
    case 192: return launch_fwd<192, T>(h, x, lns, lnb, w1q, w1s, b1, w2q, w2s, b2, gamma, y, N, eps, st);
    case 384: return launch_fwd<384, T>(h, x, lns, lnb, w1q, w1s, b1, w2q, w2s, b2, gamma, y, N, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int bwd_q8(const void* h, const void* dy, const void* lns, const void* lnb,
           const void* w1q, const void* w1s, const void* w2tq,
           const void* w2ts, const void* w1tq, const void* w1ts,
           const void* b1, const void* gamma, void* dh, int N, int C,
           float eps, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return launch_bwd<96, T>(h, dy, lns, lnb, w1q, w1s, w2tq, w2ts, w1tq, w1ts, b1, gamma, dh, N, eps, st);
    case 192: return launch_bwd<192, T>(h, dy, lns, lnb, w1q, w1s, w2tq, w2ts, w1tq, w1ts, b1, gamma, dh, N, eps, st);
    case 384: return launch_bwd<384, T>(h, dy, lns, lnb, w1q, w1s, w2tq, w2ts, w1tq, w1ts, b1, gamma, dh, N, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// h, x, y: (N, C) bf16; lns, lnb, b2, gamma: (C,) bf16; b1: (4C,) bf16;
// w1q: (4C, C) int8 with scales w1s (4C,) fp32; w2q: (C, 4C) int8 with w2s
// (C,) fp32. All contiguous and 16-byte aligned. C in {96, 192, 384}.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// another C).
extern "C" int convnext_tail_fwd_q8(const void* h, const void* x, const void* lns,
                                    const void* lnb, const void* w1q,
                                    const void* w1s, const void* b1,
                                    const void* w2q, const void* w2s,
                                    const void* b2, const void* gamma, void* y,
                                    int N, int C, float eps, void* stream) {
  return fwd_q8<bf16>(h, x, lns, lnb, w1q, w1s, b1, w2q, w2s, b2, gamma, y, N,
                      C, eps, stream);
}

// The fp32-row form: h, x, y and lns, lnb, b1, b2, gamma fp32; the int8
// operands and their scales as for convnext_tail_fwd_q8.
extern "C" int convnext_tail_fwd_q8_f32(const void* h, const void* x,
                                        const void* lns, const void* lnb,
                                        const void* w1q, const void* w1s,
                                        const void* b1, const void* w2q,
                                        const void* w2s, const void* b2,
                                        const void* gamma, void* y, int N,
                                        int C, float eps, void* stream) {
  return fwd_q8<float>(h, x, lns, lnb, w1q, w1s, b1, w2q, w2s, b2, gamma, y,
                       N, C, eps, stream);
}

// h, dy, dh: (N, C) bf16; lns, lnb, gamma: (C,) bf16; b1: (4C,) bf16; int8
// operands with fp32 scales: w1q (4C, C) / w1s (4C,), w2tq (4C, C) / w2ts
// (4C,), w1tq (C, 4C) / w1ts (C,). C in {96, 192, 384}.
extern "C" int convnext_tail_bwd_q8(const void* h, const void* dy, const void* lns,
                                    const void* lnb, const void* w1q,
                                    const void* w1s, const void* w2tq,
                                    const void* w2ts, const void* w1tq,
                                    const void* w1ts, const void* b1,
                                    const void* gamma, void* dh, int N, int C,
                                    float eps, void* stream) {
  return bwd_q8<bf16>(h, dy, lns, lnb, w1q, w1s, w2tq, w2ts, w1tq, w1ts, b1,
                      gamma, dh, N, C, eps, stream);
}

// The fp32-row form: h, dy, dh and lns, lnb, b1, gamma fp32; the int8
// operands as for convnext_tail_bwd_q8.
extern "C" int convnext_tail_bwd_q8_f32(const void* h, const void* dy,
                                        const void* lns, const void* lnb,
                                        const void* w1q, const void* w1s,
                                        const void* w2tq, const void* w2ts,
                                        const void* w1tq, const void* w1ts,
                                        const void* b1, const void* gamma,
                                        void* dh, int N, int C, float eps,
                                        void* stream) {
  return bwd_q8<float>(h, dy, lns, lnb, w1q, w1s, w2tq, w2ts, w1tq, w1ts, b1,
                       gamma, dh, N, C, eps, stream);
}
