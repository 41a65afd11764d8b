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
// tensor cores, at the card's bf16 ridge.
//
// Two launches a call (csrc/hopper.cuh has the primitives):
// 1. The row pre-pass (ln_rows_kernel): a row a warp, each lane four
//    neighbouring values of every 128, two-pass fp32 statistics from
//    registers, x̂ written in the compute dtype. x̂ is the backward's
//    residual, and scratch of the call when no gradient is tracked. The
//    product's blocks then share x̂ through L2 instead of each normalising
//    its rows again: one more read of x̂ (31.5 MB at the flagship, ≈ 0.01
//    ms), where a block holding a whole 128 × C x̂ tile could not also hold
//    a ring deep enough to keep the tensor cores fed.
// 2. The product (ln_matmul_fwd_kernel<kParts, kBN>): persistent blocks,
//    one an SM, walk the output's tiles of 128 rows × kBN columns, columns
//    fastest. A producer warpgroup, one thread of which issues every TMA
//    load, streams each tile's x̂ and W atoms (64 columns of C, the 128-byte
//    swizzle) into a ring of mbarrier-guarded stages, running ahead into
//    the next tile while the consumers finish this one. Two consumer
//    warpgroups take 64 rows each and share every W atom, so W is read
//    from L2 once per 128 rows (the mma.sync kernel's: once per 64). Each
//    issues wgmma.mma_async m64nkBNk16 on the stage (hopper.cuh:
//    wgmma_ss_wide) and keeps one atom's products in flight, releasing a
//    stage when they are done. The producer gives its registers up
//    (setmaxnreg 40) so the consumers can hold 232: the fp32 accumulator
//    of a 64 × 256 tile is 128 of them. The epilogue adds the bias and
//    takes the GELU at fc1 in registers, 128 bytes of columns at a time,
//    writes them into a swizzled staging box, and one thread of the
//    warpgroup stores the box by TMA (full lines; rows past N are
//    clipped). The tile plan is chosen in C (choose_bn): kBN 256 where F
//    divides and the tiles cover every SM twice, else 128 (F 384, the
//    bs-8 encode's 2560 rows).
//    Built on an H100 and not kept (PERF.md §6): two-CTA clusters that
//    multicast W (the ring is not short of L2 bandwidth; with a
//    cluster-scope release on the remote arrivals they were much slower),
//    and 128 × 128 tiles with the warpgroups in ping pong, one's epilogue
//    under the other's products (slower; a 128 × 128 tile moves more
//    shared-memory bytes a FLOP). The epilogue runs
//    while the tensor cores wait; a second accumulator to overlap it does
//    not fit beside the 128 registers of a 64 × 256 tile.
//
// The fp32 form (ln_matmul_fwd_f32, kParts = 3), for fp32 rows, where the
// Pallas kernel takes its products at Precision.HIGHEST (:63): the same
// function without the bf16 casts (x̂, z, zpre fp32), its product as the
// TPU's six bf16 passes: six bf16 wgmma products an fp32 product
// (hopper.cuh:mma_abt_parts_wide, small terms first). The pre-pass also
// writes x̂'s three bf16 parts (x̂ = x0 + x1 + x2 exactly) into scratch of
// the call, and split_kernel W's; both are read through tensor maps of
// (3, rows, C) (hopper.cuh:parts_map), a ring stage holding an atom's
// three parts of x̂ and of W (96 KB at kBN 128: two stages). Each atom's
// six products go into a fresh accumulator added to the tile's sum in
// registers: chained over the atoms in one accumulator the tensor cores'
// fp32 sum loses low bits at each product (attention_tile.cuh:head_rb_into).
// Bound: 12·N·C·F FLOP at 989/6 TFLOP/s (0.586 ms at the flagship's fc1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gelu.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace vit;
using namespace vit::hopper;

constexpr int kMaxC = 1024;
constexpr float kEps = 1e-5f;

// ---- the row pre-pass ------------------------------------------------------

constexpr int kRowWarps = 8;  // rows a block, a warp each

// Four neighbouring values of T at p, as floats, and back.
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  v[0] = raw.x, v[1] = raw.y, v[2] = raw.z, v[3] = raw.w;
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// x̂ of rows x (N, C), C a multiple of 128 up to 1024: a row a warp, lane l
// holding columns 128j + 4l .. + 3, the mean and then the mean of squared
// deviations summed from registers. x̂ into xhat (in T) where it is not
// null, and its three bf16 parts into parts (3, N, C) where that is not
// null (fp32 rows).
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
ln_rows_kernel(const T* __restrict__ x, T* __restrict__ xhat,
               bf16* __restrict__ parts, int N, int C) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= N) return;
  const int pieces = C / 128;
  const size_t at = static_cast<size_t>(row) * C + 4 * lane;
  float v[kMaxC / 128][4];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxC / 128; ++j)
    if (j < pieces) {
      load4(x + at + 128 * j, v[j]);
      sum += (v[j][0] + v[j][1]) + (v[j][2] + v[j][3]);
    }
  const float mu = warp_sum(sum) / C;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxC / 128; ++j)
    if (j < pieces)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[j][e] -= mu;
        sq += v[j][e] * v[j][e];
      }
  const float rstd = rsqrtf(warp_sum(sq) / C + kEps);
#pragma unroll
  for (int j = 0; j < kMaxC / 128; ++j)
    if (j < pieces) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] *= rstd;
      if (xhat != nullptr) store4(xhat + at + 128 * j, v[j]);
      if (parts != nullptr)
        store_parts(v[j], parts + at + 128 * j, static_cast<size_t>(N) * C);
    }
}

// W's three bf16 parts (3, n) from fp32 W (n values, a multiple of 4): a
// thread takes four, a 16-byte load and three 8-byte stores.
__global__ void split_kernel(const float* __restrict__ w,
                             bf16* __restrict__ parts, long long n) {
  const long long i = 4 * (static_cast<long long>(blockIdx.x) * blockDim.x +
                           threadIdx.x);
  if (i >= n) return;
  float v[4];
  load4(w + i, v);
  store_parts(v, parts + i, static_cast<size_t>(n));
}

// ---- the product -----------------------------------------------------------

constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 128;    // + the producer warpgroup
constexpr int kRows = 128;                    // output rows of a tile
// The dynamic shared memory a block may use, less the alignment slack, and
// the ring's barriers after the stages
constexpr int kSmemLimit = 232448 - 1024;
constexpr int kBarBytes = 256;

// The shared memory: the ring, then each consumer warpgroup's staging
// boxes of z and zpre (64 rows x 128 bytes each), then the ring's
// barriers. A ring stage holds the atom's x̂ tile (128 rows, two 64-row
// boxes) of each part, then its W tile (kBN rows, kBN / 64 boxes) of each
// part, every box 64 x 64 bf16 with the 128-byte swizzle. As many stages as
// fit, up to 8.
template <int kParts, int kBN>
struct Plan {
  static constexpr int kXPart = 2 * static_cast<int>(kTileBytes);
  static constexpr int kWPart = kBN / 64 * static_cast<int>(kTileBytes);
  static constexpr int kX = kParts * kXPart;
  static constexpr int kStage = kX + kParts * kWPart;
  static constexpr int kStaging = 2 * 2 * static_cast<int>(kTileBytes);
  static constexpr int kFit = (kSmemLimit - kBarBytes - kStaging) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kOut = kStages * kStage;
  static constexpr int kRing = kOut + kStaging;
  static constexpr int kBytes = kRing + kBarBytes + 1024;
  static_assert(kStages >= 2, "two stages in flight");
  static_assert(sizeof(Ring<kStages>) <= kBarBytes, "the ring's barriers");
};

// The row type of the kParts form: bf16, or fp32 for kParts = 3
template <int kParts>
using RowT = std::conditional_t<kParts == 1, bf16, float>;

// Box (c0 = column, c1 = row) of part p of an operand: a 2-D map of the
// bf16 matrix (kParts 1) or a 4-D map of its three parts.
template <int kParts>
__device__ __forceinline__ void load_box(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int p) {
  if constexpr (kParts == 1)
    tma_load_2d(dst, map, bar, c0, c1);
  else
    tma_load_4d(dst, map, bar, c0, c1, p, 0);
}

// The tile's first row and column: blocks walk the tiles in turn, column
// tiles fastest.
__device__ __forceinline__ int2 tile_origin(int tile, int f_tiles, int bn) {
  return make_int2((tile / f_tiles) * kRows, (tile % f_tiles) * bn);
}

// The producer thread: every tile's atoms in the order the consumers take
// them, each as soon as its stage is free.
template <int kParts, int kBN>
__device__ __forceinline__ void produce(uint8_t* sm, const CUtensorMap* tx,
                                        const CUtensorMap* tw, int tiles,
                                        int f_tiles, int atoms) {
  using P = Plan<kParts, kBN>;
  Ring<P::kStages>& ring = *reinterpret_cast<Ring<P::kStages>*>(sm + P::kRing);
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int2 o = tile_origin(tile, f_tiles, kBN);
    for (int k = 0; k < atoms; ++k, ++i) {
      const int st = ring.stage(i);
      uint8_t* dst = sm + st * P::kStage;
      ring.wait_empty(i);
      mbar_arrive_expect_tx(&ring.full[st], P::kStage);
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          load_box<kParts>(dst + p * P::kXPart + h * kTileBytes, tx,
                           &ring.full[st], 64 * k, o.x + 64 * h, p);
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j)
          load_box<kParts>(dst + P::kX + p * P::kWPart + j * kTileBytes, tw,
                           &ring.full[st], 64 * k, o.y + 64 * j, p);
      }
    }
  }
}

__device__ __forceinline__ float2 pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// Two neighbouring output values as stored: a bf16 pair or an fp32 pair.
__device__ __forceinline__ void to_pair(uint32_t& out, float lo, float hi) {
  out = pack_bf16x2(lo, hi);
}
__device__ __forceinline__ void to_pair(float2& out, float lo, float hi) {
  out = make_float2(lo, hi);
}

// Pair p at columns 2t, 2t + 1 of 8-column tile jj of row `row` of a
// staging box (64 rows x 128 bytes, swizzled as TMA's 128-byte swizzle
// places them).
template <typename P>
__device__ __forceinline__ void stage_pair(uint8_t* box, int row, int jj,
                                           int t, const P& p) {
  const int cb = (8 * jj + 2 * t) * static_cast<int>(sizeof(P)) / 2;
  *reinterpret_cast<P*>(box + row * 128 + (((cb / 16) ^ (row % 8)) << 4) +
                        cb % 16) = p;
}

// A consumer warpgroup: rows 64·wg .. + 63 of every tile of the block, all
// kBN columns, summed over C's atoms; then the epilogue: the bias and the
// GELU in registers, 128 bytes of columns at a time staged in the
// warpgroup's boxes and written by TMA stores (tz, tzpre), which clip the
// rows past N.
template <int kParts, int kBN>
__device__ __forceinline__ void consume(uint8_t* sm, const CUtensorMap* tz,
                                        const CUtensorMap* tzpre,
                                        const RowT<kParts>* __restrict__ b,
                                        int N, int tiles, int f_tiles,
                                        int atoms, int gelu_on, int has_zpre) {
  using P = Plan<kParts, kBN>;
  using T = RowT<kParts>;
  using Pair = std::conditional_t<kParts == 1, uint32_t, float2>;
  constexpr int kBoxCols = 128 / static_cast<int>(sizeof(T));
  Ring<P::kStages>& ring = *reinterpret_cast<Ring<P::kStages>*>(sm + P::kRing);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const bool lead = threadIdx.x % 128 == 0;  // issues the warpgroup's stores
  uint8_t* box_z = sm + P::kOut + wg * 2 * kTileBytes;
  uint8_t* box_zpre = box_z + kTileBytes;
  const uint32_t base = smem_u32(sm);
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int2 o = tile_origin(tile, f_tiles, kBN);
    float acc[kBN / 2];
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) acc[e] = 0.0f;
    for (int k = 0; k < atoms; ++k, ++i) {
      const uint32_t st = opaque(base + ring.stage(i) * P::kStage);
      const uint32_t a = st + wg * kTileBytes, w = st + P::kX;
      ring.wait_full(i);
      wgmma_fence();
      if constexpr (kParts == 1) {
        // one accumulator over C, the last atom's products in flight
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss_wide<kBN>(acc, desc_k(a + 32 * ks), desc_k(w + 32 * ks), 1);
        wgmma_commit();
        if (k > 0) {
          wgmma_wait<1>();
          ring.release(i - 1);
        }
      } else {
        // each atom's six products in a fresh accumulator
        float f[kBN / 2];
        mma_abt_parts_wide<3, kBN>(f, a, P::kXPart, w, P::kWPart);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(f);
        ring.release(i);
#pragma unroll
        for (int e = 0; e < kBN / 2; ++e) acc[e] = __fadd_rn(acc[e], f[e]);
      }
    }
    if constexpr (kParts == 1) {
      wgmma_wait<0>();
      fence_regs(acc);
      ring.release(i - 1);
    }

    // z (and zpre) = acc + b, GELU at fc1, a box of kBoxCols columns at a
    // time: its values are formed in registers first, then the box is
    // rewritten once the last one's stores have read it
    const int row = warp * 16 + g, r_out = o.x + wg * 64;
#pragma unroll
    for (int c = 0; c < kBN / kBoxCols; ++c) {
      Pair zp[kBoxCols / 8][2], zprep[kBoxCols / 8][2];
#pragma unroll
      for (int jj = 0; jj < kBoxCols / 8; ++jj) {
        const int j = c * (kBoxCols / 8) + jj;
        const float2 bv = b != nullptr ? pair(b + o.y + 8 * j + 2 * t)
                                       : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v0 = acc[4 * j + 2 * r] + bv.x, v1 = acc[4 * j + 2 * r + 1] + bv.y;
          if (gelu_on) {
            to_pair(zprep[jj][r], v0, v1);
            v0 = gelu(v0);
            v1 = gelu(v1);
          }
          to_pair(zp[jj][r], v0, v1);
        }
      }
      if (lead) bulk_wait_read<0>();
      named_barrier(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < kBoxCols / 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          stage_pair(box_z, row + 8 * r, jj, t, zp[jj][r]);
          if (gelu_on && has_zpre)
            stage_pair(box_zpre, row + 8 * r, jj, t, zprep[jj][r]);
        }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (lead && r_out < N) {
        tma_store_2d(tz, box_z, o.y + c * kBoxCols, r_out);
        if (gelu_on && has_zpre)
          tma_store_2d(tzpre, box_zpre, o.y + c * kBoxCols, r_out);
        bulk_commit();
      }
    }
  }
  if (lead) bulk_wait<0>();
}

// K9a's product on x̂ (tx) and W (tw): the bf16 matrices (kParts 1) or
// their three parts (kParts 3). The roles split once: the producer
// warpgroup gives up registers and one of its threads streams the loads;
// the consumers take 232 registers a thread.
template <int kParts, int kBN>
__global__ void __launch_bounds__(kThreads, 1)
ln_matmul_fwd_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tz,
                     const __grid_constant__ CUtensorMap tzpre,
                     const RowT<kParts>* __restrict__ b, int N, int C, int F,
                     int gelu_on, int has_zpre) {
  using P = Plan<kParts, kBN>;
  uint8_t* sm = &aligned_smem<uint8_t>();
  if (threadIdx.x == 0) {
    reinterpret_cast<Ring<P::kStages>*>(sm + P::kRing)->init(1, kConsumers / 32);
    mbar_init_fence();
  }
  __syncthreads();
  const int f_tiles = F / kBN;
  const int tiles = (N + kRows - 1) / kRows * f_tiles;
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers)
      produce<kParts, kBN>(sm, &tx, &tw, tiles, f_tiles, C / 64);
  } else {
    setmaxnreg_inc<232>();
    consume<kParts, kBN>(sm, &tz, &tzpre, b, N, tiles, f_tiles, C / 64,
                         gelu_on, has_zpre);
  }
}

// The output columns of a bf16 tile: 256 where F divides and the tiles
// cover every SM at least twice (the flagship's qkv and fc1), else 128.
int choose_bn(int N, int F, int sms) {
  const long long row_tiles = (N + kRows - 1) / kRows;
  return F % 256 == 0 && row_tiles * (F / 256) >= 2LL * sms ? 256 : 128;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

// The product's launch at (N, F): one persistent block an SM, or one a
// tile if there are fewer tiles.
template <int kParts, int kBN>
int launch_product(const CUtensorMap& tx, const CUtensorMap& tw,
                   const void* b, void* z, void* zpre, int N, int C, int F,
                   int gelu, int sms, cudaStream_t stream) {
  using P = Plan<kParts, kBN>;
  using T = RowT<kParts>;
  CUtensorMap tz, tzpre{};
  int err = matrix_map(&tz, z, N, F, sizeof(T));
  if (!err && zpre != nullptr) err = matrix_map(&tzpre, zpre, N, F, sizeof(T));
  if (!err)
    err = static_cast<int>(cudaFuncSetAttribute(
        ln_matmul_fwd_kernel<kParts, kBN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes));
  if (err) return err;
  const long long tiles =
      static_cast<long long>((N + kRows - 1) / kRows) * (F / kBN);
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  ln_matmul_fwd_kernel<kParts, kBN><<<grid, kThreads, P::kBytes, stream>>>(
      tx, tw, tz, tzpre, static_cast<const T*>(b), N, C, F, gelu,
      zpre != nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* x, void* xhat, void* parts, int N, int C,
                cudaStream_t stream) {
  ln_rows_kernel<T><<<(N + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0,
                      stream>>>(static_cast<const T*>(x), static_cast<T*>(xhat),
                                static_cast<bf16*>(parts), N, C);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int C, int F) {
  return C % 128 || C > kMaxC || C <= 0 || F % 128 || F <= 0;
}

}  // namespace

// x (N, C), xhat (N, C), w (F, C), b (F,) or null, z and zpre (N, F) or
// null: bf16, contiguous, 16-byte aligned; xhat is written (the residual,
// or scratch of the call). C a multiple of 128 up to 1024, F a multiple of
// 128. gelu: 0 or 1. Launches the row pre-pass, then the product. Returns
// cudaGetLastError() after the launches, the error of building a tensor
// map, or cudaErrorInvalidValue for another C or F or a null xhat.
extern "C" int ln_matmul_fwd(const void* x, const void* w, const void* b,
                             void* z, void* zpre, void* xhat, int N, int C,
                             int F, int gelu, void* stream) {
  if (bad_shape(C, F) || xhat == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0;
  int err = sm_count(&sms);
  if (!err) err = launch_rows<bf16>(x, xhat, nullptr, N, C, st);
  CUtensorMap tx, tw;
  if (!err) err = matrix_map(&tx, xhat, N, C);
  if (!err) err = matrix_map(&tw, w, F, C);
  if (err) return err;
  if (choose_bn(N, F, sms) == 256)
    return launch_product<1, 256>(tx, tw, b, z, zpre, N, C, F, gelu, sms, st);
  return launch_product<1, 128>(tx, tw, b, z, zpre, N, C, F, gelu, sms, st);
}

// The fp32 form: x (N, C), xhat (N, C) or null, w (F, C), b (F,) or null,
// z and zpre (N, F) or null, fp32; parts scratch of 3·(N + F)·C bf16 (x̂'s
// three parts, then W's). All contiguous and 16-byte aligned. C and F as
// ln_matmul_fwd's. Launches the row pre-pass, W's split, then the product.
// Returns as ln_matmul_fwd (cudaErrorInvalidValue for a null parts).
extern "C" int ln_matmul_fwd_f32(const void* x, const void* w, const void* b,
                                 void* z, void* zpre, void* xhat, void* parts,
                                 int N, int C, int F, int gelu, void* stream) {
  if (bad_shape(C, F) || parts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* xp = static_cast<bf16*>(parts);
  bf16* wp = xp + 3 * static_cast<size_t>(N) * C;
  const long long n = static_cast<long long>(F) * C;
  int sms = 0;
  int err = sm_count(&sms);
  if (!err) err = launch_rows<float>(x, xhat, xp, N, C, st);
  if (!err) {
    split_kernel<<<static_cast<int>((n / 4 + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(w), wp, n);
    err = static_cast<int>(cudaGetLastError());
  }
  CUtensorMap tx, tw;
  if (!err) err = parts_map(&tx, xp, N, C);
  if (!err) err = parts_map(&tw, wp, F, C);
  if (err) return err;
  return launch_product<3, 128>(tx, tw, b, z, zpre, N, C, F, gelu, sms, st);
}

// The row pre-pass alone (to check and time it): x (N, C) bf16 (f32 0) or
// fp32 (f32 1) into xhat (N, C) of the same type, and for fp32 rows also
// x̂'s three parts into parts (3, N, C) bf16 (or null). Returns as
// ln_matmul_fwd.
extern "C" int ln_matmul_rows(const void* x, void* xhat, void* parts, int N,
                              int C, int f32, void* stream) {
  if (bad_shape(C, 128) || xhat == nullptr || (parts != nullptr && !f32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? launch_rows<float>(x, xhat, parts, N, C, st)
             : launch_rows<bf16>(x, xhat, nullptr, N, C, st);
}

// The tile plan of a call at (N, F) for bf16 (parts 1) or fp32 rows
// (parts 3): a tile's output columns as the return value (fp32: always
// 128); that instantiation's dynamic shared memory in out[0] and the
// blocks of its grid in out[1]. 0 on an error.
extern "C" int ln_matmul_plan(int N, int F, int parts, int* out) {
  int sms = 0;
  if (sm_count(&sms)) return 0;
  const int bn = parts == 3 ? 128 : choose_bn(N, F, sms);
  out[0] = parts == 3 ? Plan<3, 128>::kBytes
           : bn == 256 ? Plan<1, 256>::kBytes : Plan<1, 128>::kBytes;
  const long long tiles = static_cast<long long>((N + kRows - 1) / kRows) * (F / bn);
  out[1] = tiles < sms ? static_cast<int>(tiles) : sms;
  return bn;
}
