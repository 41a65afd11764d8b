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
// N = bs·256 rows of 48 bytes, a 96 KB codebook that every block re-reads from
// L2, 4 bytes out per row), so fp32 FMA issue bounds it, and the (N, C) score
// matrix is never written. The design: a block owns 32 rows, one
// per lane, held in registers; its 8 warps split the codes, so every lane of a
// warp reads the same code from shared memory (a broadcast, no bank
// conflicts) while eight code streams run in parallel. The codebook is staged
// in 256-code tiles, normalised once per tile by the thread that loads each
// code, so shared memory stays at 12 KB for D = 12 whatever C is. Each warp
// keeps its first best (strict >), and the cross-warp reduction compares
// (score, index) pairs, so the lowest index wins every tie.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 32;     // rows per block: one per lane
constexpr int kSplits = 8;    // warps per block, each scanning a slice of codes
constexpr int kTile = 256;    // codes staged per tile: one per thread
constexpr int kThreads = kRows * kSplits;

template <int D>
__global__ void __launch_bounds__(kThreads)
vq_nearest_kernel(const float* __restrict__ z, const float* __restrict__ codebook,
                  int* __restrict__ idx, int N, int C, int l2_normalize) {
  __shared__ float s_code[kTile][D];
  __shared__ float s_offset[kTile];  // 0, or ‖e‖²/2 when not normalising
  __shared__ float s_best[kSplits][kRows];
  __shared__ int s_idx[kSplits][kRows];

  const int lane = threadIdx.x % 32;
  const int split = threadIdx.x / 32;
  const int row = blockIdx.x * kRows + lane;

  float zr[D];
  float zz = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    zr[k] = row < N ? z[static_cast<size_t>(row) * D + k] : 0.0f;
    zz = fmaf(zr[k], zr[k], zz);
  }
  if (l2_normalize) {
    const float r = rsqrtf(zz + 1e-24f);
#pragma unroll
    for (int k = 0; k < D; ++k) zr[k] *= r;
  }

  float best = -INFINITY;
  int best_i = 0;
  for (int c0 = 0; c0 < C; c0 += kTile) {
    __syncthreads();  // the previous tile is no longer read
    const int c = c0 + threadIdx.x;
    if (c < C) {
      float e[D];
      float ee = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        e[k] = codebook[static_cast<size_t>(c) * D + k];
        ee = fmaf(e[k], e[k], ee);
      }
      const float r = l2_normalize ? rsqrtf(ee + 1e-24f) : 1.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) s_code[threadIdx.x][k] = e[k] * r;
      s_offset[threadIdx.x] = l2_normalize ? 0.0f : 0.5f * ee;
    }
    __syncthreads();

    const int lo = split * (kTile / kSplits);
    const int hi = min(lo + kTile / kSplits, C - c0);
    for (int j = lo; j < hi; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) acc = fmaf(zr[k], s_code[j][k], acc);
      const float score = acc - s_offset[j];
      if (score > best) {
        best = score;
        best_i = c0 + j;
      }
    }
  }

  s_best[split][lane] = best;
  s_idx[split][lane] = best_i;
  __syncthreads();
  if (split == 0 && row < N) {
    for (int s = 1; s < kSplits; ++s) {
      const float b = s_best[s][lane];
      const int i = s_idx[s][lane];
      if (b > best || (b == best && i < best_i)) {
        best = b;
        best_i = i;
      }
    }
    idx[row] = best_i;
  }
}

template <int D>
int launch(const void* z, const void* codebook, void* idx, int N, int C,
           int l2_normalize, cudaStream_t stream) {
  const dim3 grid((N + kRows - 1) / kRows);
  vq_nearest_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(codebook),
      static_cast<int*>(idx), N, C, l2_normalize);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z: (N, D) fp32, codebook: (C, D) fp32, idx: (N,) int32, all contiguous.
// D must be one of 8, 12, 16, 32. Returns cudaGetLastError() after the launch.
extern "C" int vq_nearest(const void* z, const void* codebook, void* idx, int N,
                          int C, int D, int l2_normalize, void* stream) {
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch<8>(z, codebook, idx, N, C, l2_normalize, s);
    case 12: return launch<12>(z, codebook, idx, N, C, l2_normalize, s);
    case 16: return launch<16>(z, codebook, idx, N, C, l2_normalize, s);
    case 32: return launch<32>(z, codebook, idx, N, C, l2_normalize, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
