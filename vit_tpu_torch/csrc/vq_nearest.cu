// K5: nearest codebook entry per row, for Hopper (sm_90a).
//
// Replaces the Pallas kernel vit_tpu/kernels/vq.py:_vq_kernel (:36), launched
// by _vq_impl (:83) behind nearest_code (:134). Same math: with l2_normalize,
// both z and every code are scaled by rsqrt(sum x² + 1e-24) (:41-42) and the
// index is the argmax of z·e; without it, the argmax of z·e - ‖e‖²/2 (:46-49).
// Plain fp32 FMAs throughout (the TPU kernel asks for Precision.HIGHEST), never
// TF32. Ties go to the LOWEST index, as jnp.argmax does. No code is padded:
// the loops stop at C, which is what the TPU kernel's n_codes mask means.
//
// What bounds it: N·C·D fused multiply-adds on little data (flagship serving:
// N = bs·256 rows of 48 bytes against a 96 KB codebook, 4 bytes out per row),
// so fp32 FMA issue; the (N, C) score matrix is never written. At the paths'
// N (2048 to 32768) the rows alone give too few blocks for 132 SMs, so the
// design splits the codes too:
//   - a block of four warps owns 32·R rows, R a lane (R = 4; 2 at D 32), in
//     registers: R independent FMA chains for each code read, and each code
//     an LDS.128 broadcast (every lane of a warp reads the same code);
//   - blockIdx.y picks a slice of the codes; the block stages its slice in
//     shared memory once, each code normalised once there by the thread
//     that loads it (rsqrtf(ee + 1e-24f) and the same products as ever, so
//     the normalised values and every score's bits are unchanged: fmaf over
//     k = 0 .. D − 1 from 0, then minus the offset);
//   - its four warps take a quarter of the slice each, keep the first best
//     (strict >), and merge by (max score, then lowest index) through
//     shared memory;
//   - with more than one slice, the rows' (score, index) pairs meet in one
//     64-bit key a row by atomicMax: the score's bits made order-preserving
//     above, the complement of the index below, so the max is the best
//     score and, among equal scores, the lowest index, whatever order the
//     slices arrive in (−0.0 is made +0.0 first, so equal scores stay
//     ties). The last block of a row block to finish (a count a row block)
//     turns the keys into indices and leaves keys and count zero again,
//     so the wrapper keeps that scratch from call to call.
// The host's plan (kernels/vq.py:plan) picks the slices: enough blocks for
// about four an SM, at least 64 codes a slice, at most 40 KB of codes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // a block: each warp a quarter of the slice
constexpr int kThreads = 32 * kWarps;

// Rows a lane: R independent chains; fewer at D 32, whose rows take 32
// registers each.
template <int D>
constexpr int kRowsPerLane = D <= 16 ? 4 : 2;

// score as an unsigned integer with the order of the floats (−0.0 as
// +0.0), above the complement of the index.
__device__ __forceinline__ unsigned long long pack(float score, int index) {
  const uint32_t u = __float_as_uint(score + 0.0f);
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ord) << 32) |
         (0xFFFFFFFFu - static_cast<uint32_t>(index));
}

template <int D, bool kL2>
__global__ void __launch_bounds__(kThreads)
vq_nearest_kernel(const float* __restrict__ z, const float* __restrict__ codebook,
                  int* __restrict__ idx, unsigned long long* __restrict__ keys,
                  int* __restrict__ done, int N, int C, int slice) {
  constexpr int R = kRowsPerLane<D>;
  constexpr int kRows = 32 * R;  // rows a block
  extern __shared__ float4 dyn[];
  float* s_code = reinterpret_cast<float*>(dyn);  // [slice][D]
  float* s_off = s_code + slice * D;               // [slice]: ‖e‖²/2
  __shared__ float s_best[kWarps][kRows];
  __shared__ int s_idx[kWarps][kRows];
  __shared__ int s_last;

  const int lo = blockIdx.y * slice, n = min(C, lo + slice) - lo;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float e[D];
    float ee = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      e[k] = codebook[static_cast<size_t>(lo + j) * D + k];
      ee = fmaf(e[k], e[k], ee);
    }
    const float r = kL2 ? rsqrtf(ee + 1e-24f) : 1.0f;
#pragma unroll
    for (int k = 0; k < D; k += 4)
      *reinterpret_cast<float4*>(s_code + j * D + k) =
          make_float4(e[k] * r, e[k + 1] * r, e[k + 2] * r, e[k + 3] * r);
    if (!kL2) s_off[j] = 0.5f * ee;
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = blockIdx.x * kRows + lane;
  float zr[R][D];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + 32 * i;
    float zz = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      zr[i][k] = row < N ? z[static_cast<size_t>(row) * D + k] : 0.0f;
      zz = fmaf(zr[i][k], zr[i][k], zz);
    }
    if (kL2) {
      const float r = rsqrtf(zz + 1e-24f);
#pragma unroll
      for (int k = 0; k < D; ++k) zr[i][k] *= r;
    }
  }
  __syncthreads();  // the slice is staged

  const int quarter = (n + kWarps - 1) / kWarps;
  const int jlo = warp * quarter, jhi = min(n, jlo + quarter);
  float best[R];
  int best_j[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    best[i] = -INFINITY;
    best_j[i] = jlo;
  }
#pragma unroll 2
  for (int j = jlo; j < jhi; ++j) {
    float e[D];
#pragma unroll
    for (int k = 0; k < D; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(s_code + j * D + k);
      e[k] = v.x;
      e[k + 1] = v.y;
      e[k + 2] = v.z;
      e[k + 3] = v.w;
    }
    const float off = kL2 ? 0.0f : s_off[j];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) acc = fmaf(zr[i][k], e[k], acc);
      const float score = kL2 ? acc : acc - off;  // acc − 0 is acc, bit for bit
      if (score > best[i]) {
        best[i] = score;
        best_j[i] = j;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s_best[warp][lane + 32 * i] = best[i];
    s_idx[warp][lane + 32 * i] = lo + best_j[i];
  }
  __syncthreads();

  const bool sliced = gridDim.y > 1;
  for (int t = threadIdx.x; t < kRows; t += kThreads) {
    const int row = blockIdx.x * kRows + t;
    float b = s_best[0][t];
    int bi = s_idx[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float v = s_best[w][t];
      const int vi = s_idx[w][t];
      if (v > b || (v == b && vi < bi)) {
        b = v;
        bi = vi;
      }
    }
    if (row >= N) continue;
    if (sliced)
      atomicMax(keys + row, pack(b, bi));
    else
      idx[row] = bi;
  }
  if (!sliced) return;
  __threadfence();  // this block's keys before its count
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(done + blockIdx.x, 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int t = threadIdx.x; t < kRows; t += kThreads) {
    const int row = blockIdx.x * kRows + t;
    if (row >= N) continue;
    idx[row] = static_cast<int>(
        0xFFFFFFFFu - static_cast<uint32_t>(__ldcg(keys + row) & 0xFFFFFFFFull));
    keys[row] = 0;  // zero again for the next call
  }
  if (threadIdx.x == 0) done[blockIdx.x] = 0;
}

template <int D>
int launch(const void* z, const void* codebook, void* idx, void* scratch,
           int N, int C, int l2_normalize, int splits, cudaStream_t stream) {
  constexpr int kRows = 32 * kRowsPerLane<D>;
  const int slice = (C + splits - 1) / splits;
  const size_t smem = static_cast<size_t>(slice) * (D + 1) * sizeof(float);
  if (splits < 1 || (splits - 1) * slice >= C || smem > 40 * 1024 ||
      (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_blocks = (N + kRows - 1) / kRows;
  unsigned long long* keys = static_cast<unsigned long long*>(scratch);
  int* done = reinterpret_cast<int*>(keys + N);
  const dim3 grid(row_blocks, splits);
  auto* kernel = l2_normalize ? vq_nearest_kernel<D, true> : vq_nearest_kernel<D, false>;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(codebook),
      static_cast<int*>(idx), keys, done, N, C, slice);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z: (N, D) fp32, codebook: (C, D) fp32, idx: (N,) int32, all contiguous.
// D must be one of 8, 12, 16, 32. The codes are cut into `splits` slices of
// ceil(C / splits) (none empty, at most 40 KB of codes each); with splits >
// 1, scratch is N 64-bit keys then an int a row block, all zero (and
// zero again when the kernel ends).
// Returns cudaGetLastError() after the launch.
extern "C" int vq_nearest(const void* z, const void* codebook, void* idx,
                          void* scratch, int N, int C, int D, int l2_normalize,
                          int splits, void* stream) {
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch<8>(z, codebook, idx, scratch, N, C, l2_normalize, splits, s);
    case 12: return launch<12>(z, codebook, idx, scratch, N, C, l2_normalize, splits, s);
    case 16: return launch<16>(z, codebook, idx, scratch, N, C, l2_normalize, splits, s);
    case 32: return launch<32>(z, codebook, idx, scratch, N, C, l2_normalize, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Rows a block for D (32 lanes × R), the plan's row block.
extern "C" int vq_nearest_block_rows(int D) {
  switch (D) {
    case 8: return 32 * kRowsPerLane<8>;
    case 12: return 32 * kRowsPerLane<12>;
    case 16: return 32 * kRowsPerLane<16>;
    case 32: return 32 * kRowsPerLane<32>;
    default: return 0;
  }
}
