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
// about four an SM, at least 64 codes a slice (or as many as fit), at most
// 40 KB of codes.
//
// D 8, 12, 16 and 32 have the tuned form above (the rows in registers). Every
// other D runs vq_nearest_any_kernel, a register-tiled
// form with D a runtime value: a block holds 64 rows and walks its slice 128
// codes at a time, each thread 8 rows × 8 codes, with D staged in chunks of
// 16 by cp.async into two buffers, so neither the rows nor a slice has to
// fit shared memory whole and the next chunk loads while one is scored.
// With l2_normalize it scores z·e times the code's scale (a row's scale
// does not move its argmax). Each thread visits its codes in increasing
// order keeping the first best, and the slices merge through the same
// 64-bit keys, so the tie rule is unchanged. Its slices are whole tiles of
// 128 codes.

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

// The P partial bests of each of the block's kRows rows merged (max score,
// then lowest index); with one slice the row's index is written, else its
// key goes to atomicMax and the row block's last block turns the keys into
// indices, zeroing keys and count again.
template <int P, int kRows>
__device__ __forceinline__ void merge(const float (&s_best)[P][kRows],
                                      const int (&s_idx)[P][kRows],
                                      int* s_last, int* __restrict__ idx,
                                      unsigned long long* __restrict__ keys,
                                      int* __restrict__ done, int N) {
  const bool sliced = gridDim.y > 1;
  for (int t = threadIdx.x; t < kRows; t += kThreads) {
    const int row = blockIdx.x * kRows + t;
    float b = s_best[0][t];
    int bi = s_idx[0][t];
#pragma unroll
    for (int w = 1; w < P; ++w) {
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
    *s_last = atomicAdd(done + blockIdx.x, 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!*s_last) return;
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

  merge<kWarps, kRows>(s_best, s_idx, &s_last, idx, keys, done, N);
}

// The runtime-D form: a block of 128 threads scores a tile of 64 rows
// against its slice's codes 128 at a time, each thread 8 rows × 8 codes in
// registers (64 FMAs for four LDS.128 a step of k), with D walked in
// chunks of 16 staged k-major in shared memory by cp.async, two buffers:
// the next chunk (of this tile, or the first of the next tile) is in flight
// while the current one is scored. The rows and codes are staged raw. With
// l2_normalize a row's scale does not change its argmax, so a score is the
// fmaf chain z·e over k = 0 .. D − 1 from 0 times the code's scale
// rsqrtf(ee + 1e-24f), ee the code's own fmaf chain of e² in the same order,
// which each thread keeps for its eight codes beside their products; without
// it, z·e − ee/2 as in the tuned form. Nothing bounds D: the staged chunks
// are of 16 whatever D is, and offsets into z and the codes are size_t.
constexpr int kTileRows = 64, kTileCodes = 128, kChunk = 16;
constexpr int kThreadRows = 8, kThreadCodes = 8;
constexpr int kCodeLanes = kTileCodes / kThreadCodes;  // threads sharing a row
constexpr int kPad = 4;  // keeps the k-major rows 16-byte aligned
static_assert(kCodeLanes * (kTileRows / kThreadRows) == kThreads, "tile");

typedef float RowChunk[kChunk][kTileRows + kPad];
typedef float CodeChunk[kChunk][kTileCodes + kPad];

// 4 bytes global → shared, asynchronous; zero-filled where !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// acc[i][c] += zrow_i[k] · code_c[k] and ee[c] += code_c[k]² over the
// chunk's first kc values of k
template <int kKnown>
__device__ __forceinline__ void accumulate(const RowChunk& s_z, const CodeChunk& s_e, int ty,
                                           int tx, int kc,
                                           float (&acc)[kThreadRows][kThreadCodes],
                                           float (&ee)[kThreadCodes]) {
  const int n = kKnown ? kKnown : kc;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&s_z[k][ty * kThreadRows]);
    const float4 a1 = *reinterpret_cast<const float4*>(&s_z[k][ty * kThreadRows + 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&s_e[k][tx * kThreadCodes]);
    const float4 b1 = *reinterpret_cast<const float4*>(&s_e[k][tx * kThreadCodes + 4]);
    const float zv[kThreadRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float ev[kThreadCodes] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int c = 0; c < kThreadCodes; ++c) ee[c] = fmaf(ev[c], ev[c], ee[c]);
#pragma unroll
    for (int i = 0; i < kThreadRows; ++i)
#pragma unroll
      for (int c = 0; c < kThreadCodes; ++c) acc[i][c] = fmaf(zv[i], ev[c], acc[i][c]);
  }
}

template <bool kL2>
__global__ void __launch_bounds__(kThreads)
vq_nearest_any_kernel(const float* __restrict__ z,
                      const float* __restrict__ codebook, int* __restrict__ idx,
                      unsigned long long* __restrict__ keys,
                      int* __restrict__ done, int N, int C, int D, int slice) {
  __shared__ __align__(16) RowChunk s_z[2];
  __shared__ __align__(16) CodeChunk s_e[2];
  __shared__ float s_best[kCodeLanes][kTileRows];
  __shared__ int s_idx[kCodeLanes][kTileRows];
  __shared__ int s_last;

  const int tx = threadIdx.x % kCodeLanes, ty = threadIdx.x / kCodeLanes;
  const int first = blockIdx.x * kTileRows;
  const int lo = blockIdx.y * slice, hi = min(C, lo + slice);
  const int chunks = (D + kChunk - 1) / kChunk;
  const int steps = (hi - lo + kTileCodes - 1) / kTileCodes * chunks;

  // step q: tile q / chunks, chunk q % chunks, into buffer q % 2. A thread
  // copies k = sk of rows and codes sm + 8i. With one chunk a tile the
  // rows' chunk never changes: both buffers take it once.
  constexpr int kPass = kThreads / kChunk;  // rows a pass of the threads
  const int sk = threadIdx.x % kChunk, sm = threadIdx.x / kChunk;
  const float* zsrc = z + static_cast<size_t>(first + sm) * D + sk;
  unsigned rows_in = 0;
#pragma unroll
  for (int i = 0; i < kTileRows / kPass; ++i)
    rows_in |= static_cast<unsigned>(first + sm + kPass * i < N) << i;
  auto stage = [&](int q) {
    const int t0 = lo + q / chunks * kTileCodes, k0 = q % chunks * kChunk;
    const bool k_in = k0 + sk < D, rows = chunks > 1 || q < 2;
    const float* esrc = codebook + static_cast<size_t>(t0 + sm) * D + k0 + sk;
    float* zdst = &s_z[q & 1][sk][sm];
    float* edst = &s_e[q & 1][sk][sm];
#pragma unroll
    for (int i = 0; i < kTileCodes / kPass; ++i) {
      const size_t step = static_cast<size_t>(kPass) * i * D;
      const bool zin = k_in && i < kTileRows / kPass && (rows_in >> i & 1u);
      const bool ein = k_in && t0 + sm + kPass * i < hi;
      if (rows && i < kTileRows / kPass)
        cp_async4(zdst + kPass * i, zin ? zsrc + k0 + step : z, zin);
      cp_async4(edst + kPass * i, ein ? esrc + step : codebook, ein);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float best[kThreadRows];
  int best_j[kThreadRows];
#pragma unroll
  for (int i = 0; i < kThreadRows; ++i) {
    best[i] = -INFINITY;
    best_j[i] = lo;
  }
  float acc[kThreadRows][kThreadCodes], ee[kThreadCodes];
  if (steps > 0) stage(0);
  for (int q = 0; q < steps; ++q) {
    const int ci = q % chunks, t0 = lo + q / chunks * kTileCodes;
    const int kc = min(kChunk, D - ci * kChunk);
    if (q + 1 < steps) {
      stage(q + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // step q's chunk is staged
    if (ci == 0) {
#pragma unroll
      for (int c = 0; c < kThreadCodes; ++c) {
        ee[c] = 0.0f;
#pragma unroll
        for (int i = 0; i < kThreadRows; ++i) acc[i][c] = 0.0f;
      }
    }
    if (kc == kChunk)
      accumulate<kChunk>(s_z[q & 1], s_e[q & 1], ty, tx, kc, acc, ee);
    else
      accumulate<0>(s_z[q & 1], s_e[q & 1], ty, tx, kc, acc, ee);
    if (ci == chunks - 1) {  // the tile's scores: codes in increasing order
#pragma unroll
      for (int c = 0; c < kThreadCodes; ++c) {
        const int j = t0 + tx * kThreadCodes + c;
        const float sc = kL2 ? rsqrtf(ee[c] + 1e-24f) : 0.5f * ee[c];
#pragma unroll
        for (int i = 0; i < kThreadRows; ++i) {
          const float score = kL2 ? acc[i][c] * sc : acc[i][c] - sc;
          if (j < hi && score > best[i]) {
            best[i] = score;
            best_j[i] = j;
          }
        }
      }
    }
    __syncthreads();  // buffer q % 2 is read
  }
#pragma unroll
  for (int i = 0; i < kThreadRows; ++i) {
    s_best[tx][ty * kThreadRows + i] = best[i];
    s_idx[tx][ty * kThreadRows + i] = best_j[i];
  }
  __syncthreads();
  merge<kCodeLanes, kTileRows>(s_best, s_idx, &s_last, idx, keys, done, N);
}

// The codes cut into `splits` slices of whole tiles: ceil(tiles / splits)
// tiles each (the host's plan picks splits so that none is empty).
int launch_any(const void* z, const void* codebook, void* idx, void* scratch, int N,
               int C, int D, int l2_normalize, int splits, cudaStream_t stream) {
  const int tiles = (C + kTileCodes - 1) / kTileCodes;
  const int slice = splits < 1 ? 0 : (tiles + splits - 1) / splits * kTileCodes;
  if (D < 1 || splits < 1 || (splits - 1) * slice >= C ||
      (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long* keys = static_cast<unsigned long long*>(scratch);
  int* done = reinterpret_cast<int*>(keys + N);
  const dim3 grid((N + kTileRows - 1) / kTileRows, splits);
  auto* kernel = l2_normalize ? vq_nearest_any_kernel<true> : vq_nearest_any_kernel<false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(codebook),
      static_cast<int*>(idx), keys, done, N, C, D, slice);
  return static_cast<int>(cudaGetLastError());
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
// D 8, 12, 16 and 32 take the tuned form, any other D ≥ 1 the runtime-D
// form. The codes are cut into `splits` slices, none
// empty: of ceil(C / splits) codes (at most 40 KB of them) in the tuned
// form, of ceil(ceil(C / 128) / splits) tiles of 128 in the runtime-D form;
// with splits > 1, scratch is N 64-bit keys then an int a row block, all
// zero (and zero again when the kernel ends).
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
    default: return launch_any(z, codebook, idx, scratch, N, C, D, l2_normalize, splits, s);
  }
}

// Rows a block for D (32 lanes × R), the plan's row block; 0 for a D out of
// reach.
extern "C" int vq_nearest_block_rows(int D) {
  switch (D) {
    case 8: return 32 * kRowsPerLane<8>;
    case 12: return 32 * kRowsPerLane<12>;
    case 16: return 32 * kRowsPerLane<16>;
    case 32: return 32 * kRowsPerLane<32>;
    default: return D >= 1 ? kTileRows : 0;
  }
}
