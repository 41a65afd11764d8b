// K11a / K11b: the 7x7 SAME depthwise convolution on channels-last
// activations, forward and backward, for Hopper (sm_90a).
//
// Replace the Pallas kernels vit_tpu/kernels/depthwise.py:_dw_kernel (:24,
// launched by _dw_forward :44) and _dw_bwd_kernel (:77, launched by _dw_bwd
// :124), behind depthwise_conv (:68). On x (N, H, W, C), taps w (7, 7, C)
// and bias b (C,), in bf16 or fp32:
//   K11a: y[i][j] = b + Σ_{di,dj} x[i + di − 3][j + dj − 3] · w[di][dj]
//   K11b: dx[i][j] = Σ g[i + di − 3][j + dj − 3] · wf[di][dj]  (wf = w
//         flipped, read so by the kernel), dw[di][dj] = Σ_{n,i,j}
//         x[i + di − 3][j + dj − 3] · g[i][j] and db = Σ_{n,i,j} g[i][j],
//         in fp32,
// with zero padding. As in the Pallas kernel, the fp32 accumulator starts
// from the bias (dx: from zero), the taps are added di-major with dj inner
// (fused multiply-adds), and y (dx) is rounded once. K11b has two forms: the
// full one (dx, dw, db) and a dx-only one for callers that need no weight
// gradient (the frozen perceptual trunk); both compute dx with the same
// code, so their dx are the same bits.
//
// What bounds it: 49 fp32 multiply-adds per output element (98 in the full
// backward) against one read of x and one write of y (x, g and dx), about
// even between P's fp32 rate and 3.35 TB/s at bf16. Every instruction that
// is not an FMA takes an FMA's issue slot, so the design keeps loads few:
//
// - Patches. A thread owns one channel (a lane of a 32-channel group) and a
//   7 x 7 patch of outputs, its 49 taps and 49 accumulators in registers.
//   It walks the patch's 13 input rows once; each row's 13 values, read
//   from shared memory into registers, feed every output row they touch:
//   169 loads for 2,401 FMAs (the kernel this one replaced read ~12 values
//   for each 49 FMAs and was bound by its shared-memory loads). 7 divides
//   every ConvNeXt-S stage width (56, 28, 14, 7), so no warp idles on a
//   ragged column count there.
// - Tiles by TMA, in and out. A block of tr·tc·ti warps takes a tile of
//   tr x tc patches of ti images: one 4-D box (32 channels, 7·tc + 6
//   columns, 7·tr + 6 rows, ti images) of the tensor map over (C, W, H, N),
//   loaded at (c0, j0 − 3, i0 − 3, n0). The hardware fills the halo outside
//   the image (and past N and C) with zeros, which is the SAME padding. The
//   tile stays in the input's dtype in shared memory. The outputs go the
//   same way back: each thread writes its 49 rounded values into an output
//   box in shared memory and one thread stores the box (32, 7·tc, 7·tr, ti)
//   with one TMA store, which leaves out what lies outside the tensor. On
//   the H100, the 49 scattered 64-byte global stores a warp made per patch
//   instead were the largest cost beside the FMAs themselves.
// - A tile plan for each shape, chosen here on the host (choose_plan): up
//   to 2 x 2 patches, so a 14 x 14 or 7 x 7 image is one tile (four 7 x 7
//   images in one box), and larger ones are cut into 14 x 14 tiles;
//   smaller tiles where the runtime's occupancy query puts more warps on an
//   SM that way.
// - Persistent blocks. Block (group, walker) walks tiles walker, walker +
//   walkers, ... of its channel group through a 2-stage mbarrier ring:
//   once every warp has read a tile, thread 0 issues the copy of the tile
//   two ahead into its stage, so it overlaps the FMAs on the tile between.
// - The full backward's dw and db. After a tile's dx, the same thread
//   multiplies the x tile by its patch's 49 g values into 49 dw sums (and db)
//   kept in registers across the whole walk; at the end the block adds its
//   warps' sums in a fixed order and writes one fp32 partial row a walker,
//   and a second kernel adds the partial rows in a fixed order: no atomics,
//   so dw and db are the same bits run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace vit::hopper;

constexpr int kK = 7;                 // taps per side
constexpr int kTaps = kK * kK;
constexpr int kHalo = kK / 2;
constexpr int kP = 7;                 // a thread's patch: kP x kP outputs
constexpr int kIn = kP + 2 * kHalo;   // the 13 x 13 inputs a patch reads
constexpr int kCS = 32;               // channels per tile, one per lane
constexpr int kMaxWarps = 4;          // patches per tile, one per warp
constexpr int kStages = 2;            // tiles in flight per block
constexpr int kParts = kTaps + 1;     // a partial row: 49 taps and the bias
constexpr int kMaxSmem = 232448;      // the most a block may ask for
// the blocks an SM the kernels are built for (__launch_bounds__): 3, and 2
// for the full backward's 98 taps and sums
constexpr int kBlocks = 3, kBlocksDW = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// A tile plan (choose_plan).
struct Plan {
  int tr, tc, ti;        // patch rows, patch columns and images of a tile
  int warps;             // tr·tc·ti, one a patch
  int tiles_h, tiles_w;  // tiles down and across an image
  int tiles;             // tiles of one channel group: ⌈N/ti⌉·tiles_h·tiles_w
  int rows, cols;        // the tile's box: 7·tr + 6 rows, 7·tc + 6 columns
  int box_bytes;         // one input's box
  int stage_bytes;       // its place in shared memory, a multiple of 1024
  int out_bytes;         // the output box's place, a multiple of 1024, or 0
  int smem;              // a block's dynamic shared memory
  int blocks_per_sm;     // blocks an SM holds (the occupancy query)
  int walkers;           // blocks of a channel group
};

// The top-left input of tile t (halo included) in (image, row, column).
struct TileOrigin {
  int n, i, j;
};
__device__ __forceinline__ TileOrigin tile_origin(const Plan& p, int t) {
  const int per_image = p.tiles_h * p.tiles_w, rest = t % per_image;
  return {t / per_image * p.ti, rest / p.tiles_w * p.tr * kP - kHalo,
          rest % p.tiles_w * p.tc * kP - kHalo};
}

// acc[i][q] += Σ_{di,dj} in[i + di][q + dj] · w[di][dj] over a patch's 13
// x 13 inputs, row r at in[r·pitch], column k at in[r·pitch + k·32]: each
// input row is read once and feeds every output row it touches, di
// increasing for each output and dj inner.
template <typename T>
__device__ __forceinline__ void conv_patch(float (&acc)[kP][kP], const T* in,
                                           int pitch, const float (&w)[kTaps]) {
#pragma unroll
  for (int r = 0; r < kIn; ++r) {
    float v[kIn];
#pragma unroll
    for (int k = 0; k < kIn; ++k) v[k] = to_f(in[r * pitch + k * kCS]);
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int di = r - i;
      if (di < 0 || di >= kK) continue;
#pragma unroll
      for (int q = 0; q < kP; ++q)
#pragma unroll
        for (int dj = 0; dj < kK; ++dj)
          acc[i][q] = fmaf(v[q + dj], w[di * kK + dj], acc[i][q]);
    }
  }
}

// dw[di][dj] += Σ_{i,q} x[i + di][q + dj] · g[i][q] and db += Σ g[i][q] over
// a patch, x its 13 x 13 inputs and g its 7 x 7 outputs' gradients (zero
// outside the image): the patch's g in registers, then x row by row as in
// conv_patch.
template <typename T>
__device__ __forceinline__ void dw_patch(float (&dw)[kTaps], float& db,
                                         const T* x, const T* g, int pitch) {
  float gc[kP][kP];
#pragma unroll
  for (int i = 0; i < kP; ++i)
#pragma unroll
    for (int q = 0; q < kP; ++q) {
      gc[i][q] = to_f(g[(i + kHalo) * pitch + (q + kHalo) * kCS]);
      db += gc[i][q];
    }
#pragma unroll
  for (int r = 0; r < kIn; ++r) {
    float v[kIn];
#pragma unroll
    for (int k = 0; k < kIn; ++k) v[k] = to_f(x[r * pitch + k * kCS]);
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int di = r - i;
      if (di < 0 || di >= kK) continue;
#pragma unroll
      for (int q = 0; q < kP; ++q)
#pragma unroll
        for (int dj = 0; dj < kK; ++dj)
          dw[di * kK + dj] = fmaf(v[q + dj], gc[i][q], dw[di * kK + dj]);
    }
  }
}

// The patch's outputs, each rounded once, into its place in the output box
// at out: row i at out[i·pitch], column q at out[i·pitch + q·32].
template <typename T>
__device__ __forceinline__ void stage_patch(const float (&acc)[kP][kP], T* out,
                                            int pitch) {
#pragma unroll
  for (int i = 0; i < kP; ++i)
#pragma unroll
    for (int q = 0; q < kP; ++q) out[i * pitch + q * kCS] = from_f<T>(acc[i][q]);
}

// Thread 0's copy of tile t, the k-th of its block's walk, into stage k % 2:
// the convolved input's box, and x's beside it (kInputs 2), counted on the
// stage's full barrier.
template <int kInputs>
__device__ __forceinline__ void load_tile(uint8_t* sm, Ring<kStages>* ring,
                                          const CUtensorMap* tin,
                                          const CUtensorMap* tx, const Plan& p,
                                          int t, int k, int c0) {
  const TileOrigin o = tile_origin(p, t);
  const int s = Ring<kStages>::stage(k);
  uint8_t* dst = sm + s * kInputs * p.stage_bytes;
  mbar_arrive_expect_tx(&ring->full[s], kInputs * p.box_bytes);
  tma_load_4d(dst, tin, &ring->full[s], c0, o.j, o.i, o.n);
  if (kInputs == 2)
    tma_load_4d(dst + p.stage_bytes, tx, &ring->full[s], c0, o.j, o.i, o.n);
}

// kBias: the forward (y from x, w, b); else the backward's dx (from g and
// the flipped taps), with dw and db (kDW) from x besides. Block (group,
// walker) walks tiles walker, walker + walkers, ... of channel group
// blockIdx.x; warp w takes patch (w % tc, w / tc % tr) of image w / (tr·tc)
// in each. tin maps the convolved input (x or g), tx x for dw, ty the
// output (y or dx) with the output box.
template <typename T, bool kBias, bool kDW>
__global__ void __launch_bounds__(kMaxWarps * 32, kDW ? kBlocksDW : kBlocks)
depthwise_kernel(const __grid_constant__ CUtensorMap tin,
                 const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap ty,
                 const T* __restrict__ taps, const T* __restrict__ bias,
                 float* __restrict__ part, int C, Plan p) {
  constexpr int kInputs = kDW ? 2 : 1;
  uint8_t* sm = &aligned_smem<uint8_t>();
  uint8_t* outbox = sm + kStages * kInputs * p.stage_bytes;
  auto* ring = reinterpret_cast<Ring<kStages>*>(outbox + p.out_bytes);
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.x * kCS, c = c0 + lane;
  const int pc = warp % p.tc, pr = warp / p.tc % p.tr, ii = warp / (p.tc * p.tr);
  const int walker = blockIdx.y, walkers = gridDim.y;
  const int count = walker < p.tiles ? (p.tiles - 1 - walker) / walkers + 1 : 0;

  if (threadIdx.x == 0) {
    ring->init(1, warps);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < count && k < kStages; ++k)
      load_tile<kInputs>(sm, ring, &tin, &tx, p, walker + k * walkers, k, c0);

  // the taps, flipped for dx (tap (6 − di, 6 − dj) as (di, dj))
  float w[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
    w[k] = c < C ? to_f(taps[(kBias ? k : kTaps - 1 - k) * C + c]) : 0.0f;
  const float start = kBias && c < C ? to_f(bias[c]) : 0.0f;
  float dw[kTaps], db = 0.0f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) dw[k] = 0.0f;

  // the warp's patch inside a stage's box and inside the output box, in
  // elements, and a row of each
  const int patch = ((ii * p.rows + pr * kP) * p.cols + pc * kP) * kCS + lane;
  const int pitch = p.cols * kCS;
  const int out_pitch = kP * p.tc * kCS;
  const int out_patch = (ii * kP * p.tr + pr * kP) * out_pitch + pc * kP * kCS + lane;
  for (int k = 0; k < count; ++k) {
    const TileOrigin o = tile_origin(p, walker + k * walkers);
    const T* in = reinterpret_cast<const T*>(sm + Ring<kStages>::stage(k) *
                                             kInputs * p.stage_bytes);
    ring->wait_full(k);
    if constexpr (kDW)
      dw_patch<T>(dw, db, in + p.stage_bytes / sizeof(T) + patch, in + patch,
                  pitch);
    float acc[kP][kP];
#pragma unroll
    for (int i = 0; i < kP; ++i)
#pragma unroll
      for (int q = 0; q < kP; ++q) acc[i][q] = start;
    conv_patch<T>(acc, in + patch, pitch, w);
    // Every warp has read the stage, and the last tile's store the output
    // box: the copy two ahead goes into the stage, the outputs into the box.
    // A plan without a box of its own (where one would cost warps on an SM)
    // stages the outputs over the stage's last input and issues the copy
    // once the store has read them.
    const bool own_box = p.out_bytes > 0;
    if (threadIdx.x == 0) bulk_wait_read<0>();
    __syncthreads();
    uint8_t* box = own_box ? outbox
                           : sm + (Ring<kStages>::stage(k) * kInputs + kInputs - 1) *
                                      p.stage_bytes;
    if (own_box && threadIdx.x == 0 && k + kStages < count)
      load_tile<kInputs>(sm, ring, &tin, &tx, p, walker + (k + kStages) * walkers,
                         k + kStages, c0);
    stage_patch<T>(acc, reinterpret_cast<T*>(box) + out_patch, out_pitch);
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_store_4d(&ty, box, c0, o.j + kHalo, o.i + kHalo, o.n);
      bulk_commit();
      if (!own_box && k + kStages < count) {
        bulk_wait_read<0>();
        load_tile<kInputs>(sm, ring, &tin, &tx, p,
                           walker + (k + kStages) * walkers, k + kStages, c0);
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait<0>();

  if constexpr (kDW) {
    // The warps' sums, added in a fixed order: this walker's partial row,
    // part[walker][k][c], k < 49 the taps and k = 49 the bias. Every copy
    // in and out is done, so the boxes' space is free.
    __syncthreads();
    float* red = reinterpret_cast<float*>(sm);  // [warps][50][32]
#pragma unroll
    for (int k = 0; k < kTaps; ++k) red[(warp * kParts + k) * kCS + lane] = dw[k];
    red[(warp * kParts + kTaps) * kCS + lane] = db;
    __syncthreads();
    for (int e = threadIdx.x; e < kParts * kCS; e += blockDim.x) {
      const int k = e / kCS, l = e % kCS;
      if (c0 + l >= C) continue;
      float sum = 0.0f;
      for (int v = 0; v < warps; ++v) sum += red[(v * kParts + k) * kCS + l];
      part[(static_cast<size_t>(walker) * kParts + k) * C + c0 + l] = sum;
    }
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

// The plan of tiles tr x tc patches of ti images at (N, H, W), with an
// output box of its own (own) or the outputs staged over a stage's last
// input, and its shared memory: two stages of the inputs' boxes, the output
// box, the ring's barriers and room to align the base to 1024 bytes; false
// where the kernel or the tensor map cannot take it.
bool make_plan(Plan* p, int tr, int tc, int ti, bool own, int N, int H, int W,
               int elem, int inputs) {
  p->tr = tr;
  p->tc = tc;
  p->ti = ti;
  p->warps = tr * tc * ti;
  p->tiles_h = ceil_div(ceil_div(H, kP), tr);
  p->tiles_w = ceil_div(ceil_div(W, kP), tc);
  p->tiles = ceil_div(N, ti) * p->tiles_h * p->tiles_w;
  p->rows = kP * tr + 2 * kHalo;
  p->cols = kP * tc + 2 * kHalo;
  p->box_bytes = kCS * p->cols * p->rows * ti * elem;
  p->stage_bytes = ceil_div(p->box_bytes, 1024) * 1024;
  p->out_bytes = own ? ceil_div(kCS * kP * tc * kP * tr * ti * elem, 1024) * 1024 : 0;
  p->smem = kStages * inputs * p->stage_bytes + p->out_bytes +
            static_cast<int>(sizeof(Ring<kStages>)) + 1024;
  return p->warps <= kMaxWarps && p->rows <= 256 && p->cols <= 256 && ti <= 256 &&
         p->smem <= kMaxSmem;
}

// The map of a contiguous (N, H, W, C) tensor as 4-D (C, W, H, N), boxes of
// (32, cols, rows, ti), no swizzle, zeros outside. Returns 0 or a
// cudaError_t.
int activation_map(CUtensorMap* map, const void* base, int N, int H, int W,
                   int C, int elem, int cols, int rows, int ti) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t e = static_cast<cuuint64_t>(elem);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {dims[0] * e, dims[0] * dims[1] * e,
                                 dims[0] * dims[1] * dims[2] * e};
  const cuuint32_t box[4] = {kCS, static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows),
                             static_cast<cuuint32_t>(ti)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// activation_map through a small per-thread cache keyed by every input of
// the map (an equal key gives an equal map): encoding one costs a few µs of
// host time, which sets the small stages' calls, and a training step calls
// the same shapes on the same buffers of the caching allocator again and
// again. Per thread, since autograd launches the backward from its own.
int cached_map(CUtensorMap* map, const void* base, int N, int H, int W, int C,
               int elem, int cols, int rows, int ti) {
  struct Entry {
    const void* base;
    int key[8];
    CUtensorMap map;
  };
  constexpr int kEntries = 8;
  thread_local Entry cache[kEntries];
  thread_local int used = 0, next = 0;
  const int key[8] = {N, H, W, C, elem, cols, rows, ti};
  for (int e = 0; e < used; ++e) {
    bool same = cache[e].base == base;
    for (int k = 0; k < 8 && same; ++k) same = cache[e].key[k] == key[k];
    if (same) {
      *map = cache[e].map;
      return 0;
    }
  }
  const int err = activation_map(map, base, N, H, W, C, elem, cols, rows, ti);
  if (err) return err;
  Entry& slot = cache[next];
  slot.base = base;
  for (int k = 0; k < 8; ++k) slot.key[k] = key[k];
  slot.map = *map;
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return 0;
}

// Sets depthwise_kernel<T, kBias, kDW>'s shared memory, once per device:
// the largest any plan asks for, and all of the SM's 228 KB as shared
// memory (blocks, not L1).
template <typename T, bool kBias, bool kDW>
int prepare(int device) {
  static bool ready[64] = {};
  if (device < 64 && ready[device]) return 0;
  auto kernel = &depthwise_kernel<T, kBias, kDW>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  if (!err)
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared));
  if (!err && device < 64) ready[device] = true;
  return err;
}

// The tile plan of depthwise_kernel<T, kBias, kDW> at (N, H, W, C) on the
// current device. Of the tiles of tr x tc patches (tr, tc ≤ 2) of ti images
// (1, 2 or 4), with an output box of their own or not, that make_plan takes,
// the one that puts the most warps on an SM (the runtime's occupancy
// query: registers, threads, shared memory; blocks beyond those the kernel
// is built for count as none, since more and smaller blocks ran slower: on
// an H100 at (64, 7, 7, 768) bf16, 1-warp blocks at 9 an SM took 0.018 ms
// where 4-warp blocks at 2 took 0.0125), then an output box of its own,
// then the most patches side by side (the least halo), then the most warps.
// Each of the ⌈C/32⌉ channel groups gets walkers blocks, enough to fill the
// device's SMs at those blocks, and walker v takes the group's tiles v,
// v + walkers, ...
// Cached per thread by device and shape: the queries cost host time, and a
// training step asks for the same shapes again and again.
template <typename T, bool kBias, bool kDW>
int choose_plan(Plan* plan, int N, int H, int W, int C) {
  struct Entry {
    int key[5];
    Plan plan;
  };
  constexpr int kEntries = 16;
  thread_local Entry cache[kEntries];
  thread_local int used = 0, next = 0;
  int device = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (err) return err;
  const int key[5] = {device, N, H, W, C};
  for (int e = 0; e < used; ++e) {
    bool same = true;
    for (int k = 0; k < 5 && same; ++k) same = cache[e].key[k] == key[k];
    if (same) {
      *plan = cache[e].plan;
      return 0;
    }
  }
  int sms = 0;
  err = prepare<T, kBias, kDW>(device);
  if (!err)
    err = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (err) return err;
  constexpr int kInputs = kDW ? 2 : 1;
  const int ph = ceil_div(H, kP), pw = ceil_div(W, kP);
  int best[4] = {0, 0, 0, 0};  // (warps an SM, own box, patches, warps)
  for (int tr = 1; tr <= ph && tr <= 2; ++tr)
    for (int tc = 1; tc <= pw && tc <= 2; ++tc)
      for (int ti = 1; ti <= 4; ti *= 2)
        for (int own = 0; own < 2; ++own) {
          Plan p;
          if (!make_plan(&p, tr, tc, ti, own, N, H, W, sizeof(T), kInputs)) continue;
          err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &p.blocks_per_sm, &depthwise_kernel<T, kBias, kDW>, p.warps * 32,
              p.smem));
          if (err) return err;
          const int blocks = std::min(p.blocks_per_sm, kDW ? kBlocksDW : kBlocks);
          const int score[4] = {blocks * p.warps, own, tr * tc, p.warps};
          int k = 0;
          while (k < 4 && score[k] == best[k]) ++k;
          if (k < 4 && score[k] > best[k]) {
            for (k = 0; k < 4; ++k) best[k] = score[k];
            *plan = p;
          }
        }
  if (best[0] == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = std::min(plan->blocks_per_sm, kDW ? kBlocksDW : kBlocks);
  plan->walkers =
      std::max(1, std::min(plan->tiles, ceil_div(sms * blocks, ceil_div(C, kCS))));
  Entry& slot = cache[next];
  for (int k = 0; k < 5; ++k) slot.key[k] = key[k];
  slot.plan = *plan;
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return 0;
}

// One launch of depthwise_kernel<T, kBias, kDW> at its plan p: (⌈C/32⌉
// groups, walkers) blocks of tr·tc·ti warps; xin the convolved input, x
// (kDW) the forward's input.
template <typename T, bool kBias, bool kDW>
int launch(const void* xin, const void* x, const void* taps, const void* bias,
           void* out, void* part, int N, int H, int W, int C, const Plan& p,
           cudaStream_t stream) {
  CUtensorMap tin, tx, ty;
  int err = cached_map(&tin, xin, N, H, W, C, sizeof(T), p.cols, p.rows, p.ti);
  if (!err && kDW)
    err = cached_map(&tx, x, N, H, W, C, sizeof(T), p.cols, p.rows, p.ti);
  if (!err)
    err = cached_map(&ty, out, N, H, W, C, sizeof(T), kP * p.tc, kP * p.tr,
                     p.ti);
  if (err) return err;
  if (!kDW) tx = tin;  // unread
  const dim3 grid(ceil_div(C, kCS), p.walkers);
  depthwise_kernel<T, kBias, kDW><<<grid, p.warps * 32, p.smem, stream>>>(
      tin, tx, ty, static_cast<const T*>(taps), static_cast<const T*>(bias),
      static_cast<float*>(part), C, p);
  return static_cast<int>(cudaGetLastError());
}

// The plan of form (0: K11a, 1: the dx-only K11b, 2: the full one) in
// bf16 or fp32 at (N, H, W, C).
int plan_of(Plan* p, int form, bool is_bf16, int N, int H, int W, int C) {
  switch (form * 2 + is_bf16) {
    case 0: return choose_plan<float, true, false>(p, N, H, W, C);
    case 1: return choose_plan<bf16, true, false>(p, N, H, W, C);
    case 2: return choose_plan<float, false, false>(p, N, H, W, C);
    case 3: return choose_plan<bf16, false, false>(p, N, H, W, C);
    case 4: return choose_plan<float, false, true>(p, N, H, W, C);
    case 5: return choose_plan<bf16, false, true>(p, N, H, W, C);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The tile plan of form (0: K11a, 1: the dx-only K11b, 2: the full one)
// at (N, H, W, C), bf16 (is_bf16) or fp32, on the current device: out[0..8]
// = tr, tc, ti, own output box, warps, walkers, tiles, shared memory bytes
// and blocks an SM. The full form's caller sizes its partial rows (walkers,
// 50, C) by it. Returns 0 or a cudaError_t.
extern "C" int depthwise_plan(int N, int H, int W, int C, int is_bf16, int form,
                              int* out) {
  Plan p;
  if (form < 0 || form > 2 || N < 1 || H < 1 || W < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = plan_of(&p, form, is_bf16 != 0, N, H, W, C);
  if (err) return err;
  const int fields[9] = {p.tr, p.tc, p.ti, p.out_bytes > 0, p.warps,
                         p.walkers, p.tiles, p.smem, p.blocks_per_sm};
  for (int k = 0; k < 9; ++k) out[k] = fields[k];
  return 0;
}

// K11a. x, y: (N, H, W, C), w: (7, 7, C), b: (C,), all bf16 (is_bf16) or
// all fp32, contiguous and 16-byte aligned; C a multiple of 8.
// Returns cudaGetLastError() after the launch, or the error of a shape the
// plan or the tensor map cannot take.
extern "C" int depthwise_fwd(const void* x, const void* w, const void* b, void* y,
                             int N, int H, int W, int C, int is_bf16,
                             void* stream) {
  if (C % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || H == 0 || W == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan p;
  const int err = plan_of(&p, 0, is_bf16 != 0, N, H, W, C);
  if (err) return err;
  return is_bf16 ? launch<bf16, true, false>(x, nullptr, w, b, y, nullptr, N, H,
                                             W, C, p, st)
                 : launch<float, true, false>(x, nullptr, w, b, y, nullptr, N,
                                              H, W, C, p, st);
}

// K11b. g, dx: (N, H, W, C) and w (the forward's taps, 7, 7, C), all bf16 or
// all fp32, contiguous and 16-byte aligned; C a multiple of 8. With x null,
// dx alone (part, dw and db unused). Else x (N, H, W, C) in the same dtype,
// part fp32 scratch of part_rows ≥ the full form's walkers
// (depthwise_plan) rows of (50, C), dw (7, 7, C) and db (C,) fp32.
extern "C" int depthwise_bwd(const void* x, const void* g, const void* w,
                             void* dx, void* part, void* dw, void* db, int N,
                             int H, int W, int C, int is_bf16, int part_rows,
                             void* stream) {
  if (C % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || H == 0 || W == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool full = x != nullptr;
  Plan p;
  int err = plan_of(&p, full ? 2 : 1, is_bf16 != 0, N, H, W, C);
  if (err) return err;
  if (!full)
    return is_bf16 ? launch<bf16, false, false>(g, nullptr, w, nullptr, dx,
                                                nullptr, N, H, W, C, p, st)
                   : launch<float, false, false>(g, nullptr, w, nullptr, dx,
                                                 nullptr, N, H, W, C, p, st);
  if (part_rows < p.walkers) return static_cast<int>(cudaErrorInvalidValue);
  err = is_bf16 ? launch<bf16, false, true>(g, x, w, nullptr, dx, part, N, H,
                                            W, C, p, st)
                : launch<float, false, true>(g, x, w, nullptr, dx, part, N, H,
                                             W, C, p, st);
  if (err) return err;
  depthwise_bwd_reduce_kernel<<<ceil_div(kParts * C, 32), dim3(32, 8), 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw),
      static_cast<float*>(db), p.walkers, C);
  return static_cast<int>(cudaGetLastError());
}
