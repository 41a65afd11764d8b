// K11a / K11b: the 7x7 SAME depthwise convolution on channels-last
// activations, forward and backward, for Hopper (sm_90a).
//
// Replace the Pallas kernels vit_tpu/kernels/depthwise.py:_dw_kernel (:24,
// launched by _dw_forward :44) and _dw_bwd_kernel (:77, launched by _dw_bwd
// :124), behind depthwise_conv (:68). On x (N, H, W, C), taps w (7, 7, C)
// and bias b (C,), in bf16 or fp32:
//   K11a: y[i][j] = b + Σ_{di,dj} x[i + di − 3][j + dj − 3] · w[di][dj]
//   K11b: dx[i][j] = Σ g[i + di − 3][j + dj − 3] · wf[di][dj]  (wf = w
//         flipped, by the wrapper), dw[di][dj] = Σ_{n,i,j} x[i + di − 3]
//         [j + dj − 3] · g[i][j] and db = Σ_{n,i,j} g[i][j], in fp32,
// with zero padding. As in the Pallas kernel, the fp32 accumulator starts
// from the bias, the taps are added di-major, and y (dx) is rounded once.
//
// The TPU kernel holds one halo-padded image per grid step in VMEM (1.5 MB
// at 56 x 56 x 96 in fp32); shared memory holds 227 KB. So a block takes an
// (8 rows + 6) x (≤ 32 columns + 6) x 32-channel halo tile of one image into
// shared memory in fp32 (16-byte loads along C, zeros outside the image).
// Each lane owns one channel, with its 49 taps in registers, and each of the
// 8 warps a few columns of the tile; a thread walks its column's input rows
// once, each row's 7 values feeding every output row it touches, so an
// output costs ~12 shared-memory loads for its 49 fused multiply-adds.
// K11b does the same over a 4-row tile of x and of g together: dx from the g
// tile, and dw (49 fp32 sums in registers) and db from the x tile times the
// g values of the thread's pixels. A block walks up to 4 such row tiles of
// one image, sums its 8 warps' dw and db in a fixed order, and writes one
// fp32 partial row; a second kernel adds the partial rows in a fixed order:
// no atomics, so dw and db are the same bits run to run.
//
// What bounds it: 98 fp32 operations per output element (3 x 98 backward)
// against one read of x and one write of y (x, g, dx): about even between
// the fp32 rate (67 TFLOP/s) and the bytes (3.35 TB/s) at bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kK = 7;            // taps per side
constexpr int kTaps = kK * kK;
constexpr int kHalo = kK / 2;
constexpr int kCS = 32;          // channels per block: one per lane
constexpr int kSlots = 8;        // warps; each owns every 8th column
constexpr int kBlock = kCS * kSlots;
constexpr int kFwdRows = 8;      // output rows per forward tile
constexpr int kBwdRows = 4;      // output rows per backward tile
constexpr int kBwdTiles = 4;     // row tiles per backward block
constexpr int kMaxTileW = 32;    // output columns per tile
constexpr int kParts = kTaps + 1;  // a partial row: 49 taps and the bias

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

int tile_width(int W) { return W < kMaxTileW ? W : kMaxTileW; }
int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Rows [i0 − 3, i0 + rows − 3) x columns [j0 − 3, j0 + tw + 3) x channels
// [c0, c0 + 32) of one image (H, W, C) into `tile` in fp32, zeros outside the
// image and past C: tile[(r·(tw + 6) + col)·32 + channel].
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ img,
                                          int i0, int j0, int c0, int rows,
                                          int tw, int H, int W, int C) {
  constexpr int kVec = 16 / sizeof(T);  // channels per 16-byte load
  constexpr int kPerPixel = kCS / kVec;
  const int cols = tw + 2 * kHalo;
  const int total = rows * cols * kPerPixel;
  for (int idx = threadIdx.x; idx < total; idx += kBlock) {
    const int v = idx % kPerPixel;
    const int p = idx / kPerPixel;
    const int i = i0 - kHalo + p / cols, j = j0 - kHalo + p % cols;
    const int c = c0 + v * kVec;
    float vals[kVec];
    if (i >= 0 && i < H && j >= 0 && j < W && c < C) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          img + (static_cast<size_t>(i) * W + j) * C + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < kVec; ++k) vals[k] = to_f(e[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) vals[k] = 0.0f;
    }
    float4* dst = reinterpret_cast<float4*>(tile + p * kCS + v * kVec);
#pragma unroll
    for (int k = 0; k < kVec / 4; ++k)
      dst[k] = make_float4(vals[4 * k], vals[4 * k + 1], vals[4 * k + 2],
                           vals[4 * k + 3]);
  }
}

// The 49 taps (di-major) of channel c, or zeros past C.
template <typename T>
__device__ __forceinline__ void load_taps(float (&w)[kTaps], const T* __restrict__ taps,
                                          int c, int C) {
#pragma unroll
  for (int k = 0; k < kTaps; ++k) w[k] = c < C ? to_f(taps[k * C + c]) : 0.0f;
}

// acc[i] += Σ_{di,dj} tile[i + di][j + dj] · w[di][dj] for the TH output
// rows of column j: each input row's 7 values are read once and feed every
// output row they touch, di increasing for each.
template <int TH>
__device__ __forceinline__ void conv_column(float (&acc)[TH], const float* tile,
                                            int cols, int j, int lane,
                                            const float (&w)[kTaps]) {
#pragma unroll
  for (int r = 0; r < TH + 2 * kHalo; ++r) {
    float xr[kK];
#pragma unroll
    for (int dj = 0; dj < kK; ++dj) xr[dj] = tile[(r * cols + j + dj) * kCS + lane];
#pragma unroll
    for (int i = 0; i < TH; ++i) {
      const int di = r - i;
      if (di >= 0 && di < kK) {
#pragma unroll
        for (int dj = 0; dj < kK; ++dj) acc[i] = fmaf(xr[dj], w[di * kK + dj], acc[i]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
depthwise_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ b, T* __restrict__ y, int H, int W,
                     int C, int tw, int wtiles) {
  extern __shared__ __align__(16) float tile[];
  const int c0 = blockIdx.x * kCS;
  const int i0 = (blockIdx.y / wtiles) * kFwdRows;
  const int j0 = (blockIdx.y % wtiles) * tw;
  const size_t img = static_cast<size_t>(blockIdx.z) * H * W * C;
  const int lane = threadIdx.x % 32, slot = threadIdx.x / 32;
  const int c = c0 + lane;
  const int cols = tw + 2 * kHalo;

  load_tile<T>(tile, x + img, i0, j0, c0, kFwdRows + 2 * kHalo, tw, H, W, C);
  float taps[kTaps];
  load_taps<T>(taps, w, c, C);
  const float bias = c < C ? to_f(b[c]) : 0.0f;
  __syncthreads();

  for (int j = slot; j < tw; j += kSlots) {
    float acc[kFwdRows];
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i) acc[i] = bias;
    conv_column<kFwdRows>(acc, tile, cols, j, lane, taps);
    if (c >= C || j0 + j >= W) continue;
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i)
      if (i0 + i < H)
        y[img + (static_cast<size_t>(i0 + i) * W + j0 + j) * C + c] = from_f<T>(acc[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
depthwise_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const T* __restrict__ wf, T* __restrict__ dx,
                     float* __restrict__ part, int H, int W, int C, int tw,
                     int wtiles, int groups) {
  extern __shared__ __align__(16) float smem[];
  const int cols = tw + 2 * kHalo;
  float* tx = smem;                                        // x halo tile
  float* tg = smem + (kBwdRows + 2 * kHalo) * cols * kCS;  // g halo tile
  const int c0 = blockIdx.x * kCS;
  const int wt = blockIdx.y % wtiles, grp = blockIdx.y / wtiles;
  const int j0 = wt * tw;
  const size_t img = static_cast<size_t>(blockIdx.z) * H * W * C;
  const int lane = threadIdx.x % 32, slot = threadIdx.x / 32;
  const int c = c0 + lane;

  float taps[kTaps], dw[kTaps], db = 0.0f;
  load_taps<T>(taps, wf, c, C);
#pragma unroll
  for (int k = 0; k < kTaps; ++k) dw[k] = 0.0f;

  const int first = grp * kBwdTiles * kBwdRows;
  const int last = min(H, first + kBwdTiles * kBwdRows);
  for (int i0 = first; i0 < last; i0 += kBwdRows) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T>(tx, x + img, i0, j0, c0, kBwdRows + 2 * kHalo, tw, H, W, C);
    load_tile<T>(tg, g + img, i0, j0, c0, kBwdRows + 2 * kHalo, tw, H, W, C);
    __syncthreads();
    for (int j = slot; j < tw; j += kSlots) {
      float acc[kBwdRows], gc[kBwdRows];
#pragma unroll
      for (int i = 0; i < kBwdRows; ++i) {
        acc[i] = 0.0f;
        gc[i] = tg[((i + kHalo) * cols + j + kHalo) * kCS + lane];  // 0 off the image
        db += gc[i];
      }
#pragma unroll
      for (int r = 0; r < kBwdRows + 2 * kHalo; ++r) {
        float xr[kK], gr[kK];
#pragma unroll
        for (int dj = 0; dj < kK; ++dj) {
          xr[dj] = tx[(r * cols + j + dj) * kCS + lane];
          gr[dj] = tg[(r * cols + j + dj) * kCS + lane];
        }
#pragma unroll
        for (int i = 0; i < kBwdRows; ++i) {
          const int di = r - i;
          if (di >= 0 && di < kK) {
#pragma unroll
            for (int dj = 0; dj < kK; ++dj) {
              acc[i] = fmaf(gr[dj], taps[di * kK + dj], acc[i]);
              dw[di * kK + dj] = fmaf(xr[dj], gc[i], dw[di * kK + dj]);
            }
          }
        }
      }
      if (c >= C || j0 + j >= W) continue;
#pragma unroll
      for (int i = 0; i < kBwdRows; ++i)
        if (i0 + i < H)
          dx[img + (static_cast<size_t>(i0 + i) * W + j0 + j) * C + c] =
              from_f<T>(acc[i]);
    }
  }

  // The 8 warps' sums, added in a fixed order: one partial row of this
  // block, part[p][k][c], k < 49 the taps and k = 49 the bias.
  __syncthreads();
  float* red = smem;  // [8][50][32]
#pragma unroll
  for (int k = 0; k < kTaps; ++k) red[(slot * kParts + k) * kCS + lane] = dw[k];
  red[(slot * kParts + kTaps) * kCS + lane] = db;
  __syncthreads();
  const size_t p = (static_cast<size_t>(blockIdx.z) * groups + grp) * wtiles + wt;
  for (int e = threadIdx.x; e < kParts * kCS; e += kBlock) {
    const int k = e / kCS, l = e % kCS;
    if (c0 + l >= C) continue;
    float s = 0.0f;
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) s += red[(sl * kParts + k) * kCS + l];
    part[(p * kParts + k) * C + c0 + l] = s;
  }
}

// dw[k][c] (k < 49) and db[c] (k = 49): the sum of the P partial rows, in a
// fixed order: lane y of a (32, 8) block adds rows y, y + 8, ..., then the 8
// lanes' sums are added in order.
__global__ void __launch_bounds__(256)
depthwise_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                            float* __restrict__ db, int P, int C) {
  __shared__ float red[8][32];
  const int e = blockIdx.x * 32 + threadIdx.x;
  const int n = kParts * C;
  float s = 0.0f;
  if (e < n) {
#pragma unroll 4
    for (int p = threadIdx.y; p < P; p += 8) s += part[static_cast<size_t>(p) * n + e];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || e >= n) return;
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) total += red[k][threadIdx.x];
  if (e < kTaps * C) dw[e] = total;
  else db[e - kTaps * C] = total;
}

template <typename T>
int launch_fwd(const void* x, const void* w, const void* b, void* y, int N, int H,
               int W, int C, cudaStream_t stream) {
  const int tw = tile_width(W), wtiles = ceil_div(W, tw);
  const size_t smem = sizeof(float) * (kFwdRows + 2 * kHalo) * (tw + 2 * kHalo) * kCS;
  cudaError_t err = cudaFuncSetAttribute(depthwise_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(C, kCS), ceil_div(H, kFwdRows) * wtiles, N);
  depthwise_fwd_kernel<T><<<grid, kBlock, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), H, W, C, tw, wtiles);
  return static_cast<int>(cudaGetLastError());
}

int bwd_groups(int H) { return ceil_div(ceil_div(H, kBwdRows), kBwdTiles); }

template <typename T>
int launch_bwd(const void* x, const void* g, const void* wf, void* dx, void* part,
               void* dw, void* db, int N, int H, int W, int C,
               cudaStream_t stream) {
  const int tw = tile_width(W), wtiles = ceil_div(W, tw), groups = bwd_groups(H);
  const size_t tiles =
      sizeof(float) * 2 * (kBwdRows + 2 * kHalo) * (tw + 2 * kHalo) * kCS;
  const size_t reduce = sizeof(float) * kSlots * kParts * kCS;
  const size_t smem = tiles > reduce ? tiles : reduce;
  cudaError_t err = cudaFuncSetAttribute(depthwise_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(C, kCS), groups * wtiles, N);
  depthwise_bwd_kernel<T><<<grid, kBlock, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(wf),
      static_cast<T*>(dx), static_cast<float*>(part), H, W, C, tw, wtiles, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = N * groups * wtiles;
  depthwise_bwd_reduce_kernel<<<ceil_div(kParts * C, 32), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw),
      static_cast<float*>(db), P, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (N, H, W, C), w: (7, 7, C), b: (C,), all bf16 (is_bf16) or all
// fp32, contiguous and 16-byte aligned; C a multiple of 8. Returns
// cudaGetLastError() after the launch.
extern "C" int depthwise_fwd(const void* x, const void* w, const void* b, void* y,
                             int N, int H, int W, int C, int is_bf16,
                             void* stream) {
  if (N == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (C % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<bf16>(x, w, b, y, N, H, W, C, st)
                 : launch_fwd<float>(x, w, b, y, N, H, W, C, st);
}

// The partial rows depthwise_bwd's `part` needs: part is (P, 50, C) fp32.
extern "C" int depthwise_bwd_parts(int N, int H, int W) {
  if (N == 0 || H == 0 || W == 0) return 0;
  const int tw = tile_width(W);
  return N * bwd_groups(H) * ceil_div(W, tw);
}

// x, g, dx: (N, H, W, C) and wf (the flipped taps, 7, 7, C), all bf16 or all
// fp32; part: (depthwise_bwd_parts(N, H, W), 50, C) fp32 scratch; dw: (7, 7,
// C) fp32; db: (C,) fp32. Contiguous and 16-byte aligned; C a multiple of 8.
extern "C" int depthwise_bwd(const void* x, const void* g, const void* wf,
                             void* dx, void* part, void* dw, void* db, int N,
                             int H, int W, int C, int is_bf16, void* stream) {
  if (C % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || H == 0 || W == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<bf16>(x, g, wf, dx, part, dw, db, N, H, W, C, st)
                 : launch_bwd<float>(x, g, wf, dx, part, dw, db, N, H, W, C, st);
}
