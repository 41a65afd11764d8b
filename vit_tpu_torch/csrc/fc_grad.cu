// K10: a linear layer's weight and bias gradients in one pass over the
// upstream gradient, for Hopper (sm_90a).
//
// Replaces the Pallas kernel vit_tpu/kernels/fc_grad.py:_fc_grad_kernel
// (:74, launched by matmul_dw_db :145) behind fused_dense (:237). With the
// port's (out, in) weights, for g (N, F_out) and x (N, F_in):
//   dW = gᵀ · x   (F_out, F_in) fp32,   db = Σₙ g   (F_out) fp32,
// the JAX package's fc2 arrangement, for fc1 and fc2 alike. Rows past N are
// zero-filled in both operands (the Pallas kernel zeroes both for the same
// reason: undefined rows times zeros are not zero).
//
// What bounds it: 2·N·F_out·F_in FLOP against N·(F_out + F_in) bf16 values
// read and F_out·F_in fp32 values written, ≈ 600 FLOP per byte at the
// flagship's 768 × 3072 over N 20480: the tensor cores. A block owns a
// 128 × 128 tile of dW and walks N in chunks of 32 rows of g and x through a
// three-stage cp.async ring; both tiles sit in shared memory N-major, as
// they lie in device memory, and ldmatrix.trans turns them into the
// fragments of gᵀ and x for mma.sync m16n8k16 (eight warps of 64 × 32,
// fp32 accumulators). The blocks of the first F_in column also sum the g
// tile's columns from shared memory: db costs no extra read of g. At the
// flagship's shapes the output has only 6 × 24 tiles for 132 SMs, so the
// contraction is cut into `splits` parts (chosen by the caller) that write
// fp32 partials, and a second kernel adds them in a fixed order: the result
// is deterministic, with no atomics. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace vit;

constexpr int kTile = 128;     // dW tile, both sides
constexpr int kChunk = 32;     // rows of N per stage
constexpr int kStages = 3;
constexpr int kWarps = 8;
constexpr int kBlock = kWarps * 32;
constexpr int kPitch = kTile + 8;   // 272 bytes: ldmatrix rows on distinct banks
constexpr size_t kStageElems = 2 * kChunk * kPitch;   // g then x
constexpr size_t kSmem = sizeof(bf16) * kStages * kStageElems;

// Rows [n0, n0 + 32) of the g and x column blocks into one stage; rows at
// or past n_end are zero-filled.
__device__ __forceinline__ void load_stage(bf16* st, const bf16* __restrict__ g,
                                           const bf16* __restrict__ x, int Fo,
                                           int Fi, int m0, int c0, int n0,
                                           int n_end) {
#pragma unroll
  for (int i = 0; i < 2 * kChunk * (kTile / 8) / kBlock; ++i) {
    const int idx = threadIdx.x + i * kBlock;
    const int op = idx / (kChunk * (kTile / 8));   // 0: g, 1: x
    const int rem = idx % (kChunk * (kTile / 8));
    const int r = rem / (kTile / 8);
    const int c = (rem % (kTile / 8)) * 8;
    const bool in = n0 + r < n_end;
    const int row = in ? n0 + r : 0;
    const bf16* src = op == 0 ? g + static_cast<size_t>(row) * Fo + m0 + c
                              : x + static_cast<size_t>(row) * Fi + c0 + c;
    cp_async16(st + op * kChunk * kPitch + r * kPitch + c, src, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kBlock)
fc_grad_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
               float* __restrict__ dw, float* __restrict__ db, int N, int Fo,
               int Fi, int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const int c0 = blockIdx.x * kTile;   // F_in columns of dW
  const int m0 = blockIdx.y * kTile;   // F_out rows of dW
  const int split = blockIdx.z;   // its own slice of the partials
  dw += static_cast<size_t>(split) * Fo * Fi;
  db += static_cast<size_t>(split) * Fo;
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  const int steps = n_end > n_begin ? (n_end - n_begin + kChunk - 1) / kChunk : 0;
  const bool with_db = blockIdx.x == 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int wm = warp >> 2;   // dW rows wm·64 .. + 64 of the tile
  const int wn = warp & 3;    // dW columns wn·32 .. + 32 of the tile

  auto prefetch = [&](int s) {
    if (s < steps)
      load_stage(ring + (s % kStages) * kStageElems, g, x, Fo, Fi, m0, c0,
                 n_begin + s * kChunk, n_end);
    cp_async_commit();
  };
  prefetch(0);
  prefetch(1);

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.0f;
  float dbacc = 0.0f;   // column threadIdx.x % 128, rows of half threadIdx.x / 128

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<1>();
    __syncthreads();   // stage s landed; every warp is done with stage s − 1
    prefetch(s + 2);
    const bf16* sG = ring + (s % kStages) * kStageElems;   // [32][136]: g
    const bf16* sX = sG + kChunk * kPitch;                 // [32][136]: x
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      const int q = lane / 8, i = lane % 8;
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)   // gᵀ rows wm·64 + mi·16 ..: tiles (k, m)
        ldmatrix_x4_trans(a[mi], sG + (kk + (q >> 1) * 8 + i) * kPitch +
                                     wm * 64 + mi * 16 + (q & 1) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4];   // n-tiles 2np, 2np + 1; k halves 0, 1
        ldmatrix_x4_trans(bq, sX + (kk + (q & 1) * 8 + i) * kPitch + wn * 32 +
                                  np * 16 + (q >> 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_16816(acc[mi][2 * np], a[mi], bq[0], bq[1]);
          mma_16816(acc[mi][2 * np + 1], a[mi], bq[2], bq[3]);
        }
      }
    }
    if (with_db) {
      const int col = threadIdx.x % kTile, half = threadIdx.x / kTile;
#pragma unroll
      for (int r = 0; r < kChunk / 2; ++r)
        dbacc += __bfloat162float(sG[(half * (kChunk / 2) + r) * kPitch + col]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + g4 + h * 8;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = c0 + wn * 32 + ni * 8 + 2 * t4;
        *reinterpret_cast<float2*>(dw + static_cast<size_t>(row) * Fi + col) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  }
  if (with_db) {   // the two halves of each column, in a fixed order
    __syncthreads();
    float* sDb = reinterpret_cast<float*>(smem);
    sDb[threadIdx.x] = dbacc;
    __syncthreads();
    if (threadIdx.x < kTile)
      db[m0 + threadIdx.x] = sDb[threadIdx.x] + sDb[threadIdx.x + kTile];
  }
}

// out[i] = Σ_s part[s][i] over `splits` partials of n floats, s in order.
__global__ void __launch_bounds__(kBlock)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                  long long n, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x;
       i < n / 4; i += stride) {
    float4 s = reinterpret_cast<const float4*>(part)[i];
    for (int k = 1; k < splits; ++k) {
      const float4 v = reinterpret_cast<const float4*>(part + k * n)[i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(out)[i] = s;
  }
}

int sum_splits(const float* part, float* out, long long n, int splits,
               cudaStream_t stream) {
  long long blocks = (n / 4 + kBlock - 1) / kBlock;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  sum_splits_kernel<<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      part, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g (N, Fo), x (N, Fi): bf16, contiguous, 16-byte aligned; Fo and Fi
// multiples of 128 (cudaErrorInvalidValue otherwise). dw (Fo, Fi) and db
// (Fo) fp32. With splits > 1, part (splits, Fo, Fi) and part_db (splits, Fo)
// fp32 scratch. Returns cudaGetLastError() after the launches.
extern "C" int fc_grad(const void* g, const void* x, void* dw, void* db,
                       void* part, void* part_db, int N, int Fo, int Fi,
                       int splits, void* stream) {
  if (Fo % kTile || Fi % kTile || Fo <= 0 || Fi <= 0 || splits < 1 ||
      (splits > 1 && (part == nullptr || part_db == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fc_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (N + kChunk - 1) / kChunk;
  const int rows_per_split = ((chunks + splits - 1) / splits) * kChunk;
  float* dw_out = splits > 1 ? static_cast<float*>(part) : static_cast<float*>(dw);
  float* db_out = splits > 1 ? static_cast<float*>(part_db) : static_cast<float*>(db);
  fc_grad_kernel<<<dim3(Fi / kTile, Fo / kTile, splits), kBlock, kSmem, st>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(x), dw_out, db_out,
      N, Fo, Fi, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int e = sum_splits(static_cast<const float*>(part), static_cast<float*>(dw),
                           static_cast<long long>(Fo) * Fi, splits, st);
  if (e) return e;
  return sum_splits(static_cast<const float*>(part_db), static_cast<float*>(db),
                    Fo, splits, st);
}
