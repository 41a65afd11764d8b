// K9a: the non-affine LayerNorm fused into the product that follows it, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel vit_tpu/kernels/ln_matmul.py:_fwd_kernel (:60,
// launched by _fwd_impl :121) behind fused_ln_matmul (:359). For rows x
// (N, C) of the raw residual stream and W (F, C) in PyTorch's Linear layout:
//   x̂ = (x − mean) · rsqrt(var + 1e-5)   fp32, two passes, rounded to bf16
//   acc = x̂ · Wᵀ (+ bf16 b)              fp32 sum
//   zpre = bf16(acc); z = bf16(gelu(acc)) at the fc1 site, else z = bf16(acc)
// and x̂ itself, which the backward's dW product needs. Rounding points as
// in the Pallas kernel; the GELU is always the tanh-composed erf
// (gelu.cuh), whatever the model's GELU setting.
//
// What bounds it: 2·N·C·F FLOP against N·C + C·F + N·F (+ N·F + N·C) bf16
// values, ≈ 300 FLOP per byte at the flagship's C 768, F 2304 / 3072: the
// tensor cores, at the card's bf16 ridge. The design keeps both passes over
// x on chip: a block owns 64 rows, loads them once, computes their
// statistics from shared memory, and keeps the whole 64 × C bf16 x̂ tile
// there (99 KB at C 768, 132 KB at C 1024) while it walks its share of the
// F tiles of 128 columns, streaming W through a three-stage cp.async ring
// in chunks of 128 × 64. Eight warps hold a 64 × 128 fp32 accumulator
// (32 × 32 each, mma.sync m16n8k16 fed by ldmatrix); bias, GELU and the
// bf16 rounding run on it in registers. x̂ reaches device memory once,
// from the blocks of the first F split (the TPU rewrites it for every F
// tile). When the F tiles of one row block are too few to fill the card,
// the grid splits them over blockIdx.y and each split recomputes the
// (cheap) statistics. The ragged last row block is masked; nothing is
// padded. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"
#include "mma.cuh"

namespace {

using namespace vit;

constexpr int kRows = 64;      // rows per block
constexpr int kFTile = 128;    // output columns per tile
constexpr int kK = 64;         // C per streamed W chunk
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kWarps = 8;
constexpr int kBlock = kWarps * 32;
constexpr int kWPitch = kK + 8;  // 144 bytes: ldmatrix rows on distinct banks
constexpr int kMaxC = 1024;

size_t smem_bytes(int C) {
  return sizeof(bf16) * (static_cast<size_t>(kRows) * (C + 8) +
                         static_cast<size_t>(kStages) * kFTile * kWPitch);
}

// One W chunk: rows [f0, f0 + 128) and columns [k0, k0 + 64) of W (F, C).
__device__ __forceinline__ void load_w_chunk(bf16* sW, const bf16* __restrict__ w,
                                             int C, int f0, int k0) {
#pragma unroll
  for (int i = 0; i < kFTile * (kK / 8) / kBlock; ++i) {
    const int idx = threadIdx.x + i * kBlock;
    const int r = idx / (kK / 8);
    const int c = (idx % (kK / 8)) * 8;
    cp_async16(sW + r * kWPitch + c, w + static_cast<size_t>(f0 + r) * C + k0 + c);
  }
}

__global__ void __launch_bounds__(kBlock)
ln_matmul_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const bf16* __restrict__ b, bf16* __restrict__ z,
                     bf16* __restrict__ zpre, bf16* __restrict__ xhat, int N,
                     int C, int F, int tiles_per_split, int gelu_on) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);      // [64][C + 8]: x, then x̂
  bf16* sW = sX + kRows * (C + 8);               // [3][128][72]: W chunks
  const int pitch = C + 8;

  const int r0 = blockIdx.x * kRows;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(F / kFTile, t_begin + tiles_per_split);
  const int chunks = C / kK;
  const int steps = (t_end - t_begin) * chunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp >> 2;  // rows wr·32 .. + 32 of the tile
  const int wc = warp & 3;   // columns wc·32 .. + 32 of the tile

  // The ring's first two chunks start while the rows are normalised.
  auto prefetch = [&](int s) {
    if (s < steps)
      load_w_chunk(sW + (s % kStages) * kFTile * kWPitch, w, C,
                   (t_begin + s / chunks) * kFTile, (s % chunks) * kK);
    cp_async_commit();
  };
  prefetch(0);
  prefetch(1);

  // The block's rows into shared memory; rows at or past N read as zeros
  // (x̂ = 0 there, never stored).
  for (int i = threadIdx.x; i < kRows * (C / 8); i += kBlock) {
    const int r = i / (C / 8);
    const int c = (i % (C / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N)
      v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(r0 + r) * C + c);
    *reinterpret_cast<uint4*>(sX + r * pitch + c) = v;
  }
  __syncthreads();

  // Statistics, one warp per row: lane owns columns lane·4 + 128·j.
  for (int r = warp; r < kRows; r += kWarps) {
    bf16* row = sX + r * pitch;
    float v[kMaxC / 128][4];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxC / 128; ++j) {
      if (j < C / 128) {
        const uint2 raw = *reinterpret_cast<const uint2*>(row + lane * 4 + 128 * j);
        const bf16* p = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[j][e] = __bfloat162float(p[e]);
          sum += v[j][e];
        }
      }
    }
    const float mu = warp_sum(sum) / C;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxC / 128; ++j) {
      if (j < C / 128) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[j][e] -= mu;
          sq += v[j][e] * v[j][e];
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + 1e-5f);
#pragma unroll
    for (int j = 0; j < kMaxC / 128; ++j) {
      if (j < C / 128) {
        uint2 packed;
        packed.x = pack_bf16x2(v[j][0] * rstd, v[j][1] * rstd);
        packed.y = pack_bf16x2(v[j][2] * rstd, v[j][3] * rstd);
        *reinterpret_cast<uint2*>(row + lane * 4 + 128 * j) = packed;
      }
    }
  }
  __syncthreads();

  if (xhat != nullptr && blockIdx.y == 0) {
    for (int i = threadIdx.x; i < kRows * (C / 8); i += kBlock) {
      const int r = i / (C / 8);
      const int c = (i % (C / 8)) * 8;
      if (r0 + r < N)
        *reinterpret_cast<uint4*>(xhat + static_cast<size_t>(r0 + r) * C + c) =
            *reinterpret_cast<const uint4*>(sX + r * pitch + c);
    }
  }

  float acc[2][4][4];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<1>();
    __syncthreads();  // chunk s landed; every warp is done with chunk s − 1
    prefetch(s + 2);
    const int kc = s % chunks;
    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.0f;
    }
    const bf16* sWs = sW + (s % kStages) * kFTile * kWPitch;
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], sX + (wr * 32 + mi * 16 + (lane % 16)) * pitch +
                               kc * kK + ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4];  // n-tiles 2np, 2np + 1; k halves 0, 1
        ldmatrix_x4(bq, sWs + (wc * 32 + np * 16 + (lane % 8) + (lane / 16) * 8) * kWPitch +
                            ks * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_16816(acc[mi][2 * np], a[mi], bq[0], bq[1]);
          mma_16816(acc[mi][2 * np + 1], a[mi], bq[2], bq[3]);
        }
      }
    }
    if (kc == chunks - 1) {  // the tile's epilogue: bias, GELU, bf16 stores
      const int f0 = (t_begin + s / chunks) * kFTile;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = f0 + wc * 32 + ni * 8 + 2 * t;
        float b0 = 0.0f, b1 = 0.0f;
        if (b != nullptr) {
          b0 = __bfloat162float(b[col]);
          b1 = __bfloat162float(b[col + 1]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + wr * 32 + mi * 16 + g + h * 8;
            if (row >= N) continue;
            const float v0 = acc[mi][ni][2 * h] + b0;
            const float v1 = acc[mi][ni][2 * h + 1] + b1;
            const size_t i = static_cast<size_t>(row) * F + col;
            if (gelu_on) {
              if (zpre != nullptr)
                *reinterpret_cast<uint32_t*>(zpre + i) = pack_bf16x2(v0, v1);
              *reinterpret_cast<uint32_t*>(z + i) = pack_bf16x2(gelu(v0), gelu(v1));
            } else {
              *reinterpret_cast<uint32_t*>(z + i) = pack_bf16x2(v0, v1);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace

// x (N, C), xhat (N, C), w (F, C), b (F,) or null, z and zpre (N, F) or
// null: bf16, contiguous, 16-byte aligned. C a multiple of 128 up to 1024,
// F a multiple of 128. gelu: 0 or 1. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for another C or F).
extern "C" int ln_matmul_fwd(const void* x, const void* w, const void* b,
                             void* z, void* zpre, void* xhat, int N, int C,
                             int F, int gelu, void* stream) {
  if (C % 128 || C > kMaxC || C <= 0 || F % kFTile || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(C);
  err = cudaFuncSetAttribute(ln_matmul_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // Split a row block's F tiles over enough blocks for ~4 waves of one
  // block per SM (the x̂ tile leaves room for one).
  const int row_blocks = (N + kRows - 1) / kRows;
  const int tiles = F / kFTile;
  int splits = (4 * sms + row_blocks - 1) / row_blocks;
  splits = splits < 1 ? 1 : (splits > tiles ? tiles : splits);
  const int per_split = (tiles + splits - 1) / splits;
  splits = (tiles + per_split - 1) / per_split;
  ln_matmul_fwd_kernel<<<dim3(row_blocks, splits), kBlock, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<bf16*>(z),
      static_cast<bf16*>(zpre), static_cast<bf16*>(xhat), N, C, F, per_split,
      gelu);
  return static_cast<int>(cudaGetLastError());
}
