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
// round half to even, v / s an IEEE division. The weights arrive quantized
// per output channel by the wrapper (_quant_cols, :204-212), each as an
// (n, k) operand with k contiguous: W1q (4C, C), W2q (C, 4C), W2ᵀq (4C, C),
// W1ᵀq (C, 4C), with fp32 scales; lns, lnb, b1, b2 and γ in the row type,
// read in fp32. The rows (h, x or
// dy, y or dh) and those vectors are bf16, or fp32 in the
// convnext_tail_*_q8_f32 entries, as _fwd_kernel_q8 reads rows of any
// dtype (the kernels are templated on that type only). Every product is
// int8 × int8 → int32, exact as on the MXU, rescaled as ((float)acc·s_row)·
// s_col + bias with the plain version's roundings. LN statistics are the
// two-pass fp32 ones of _normalize (:80-86); GELU and gelu′ the tanh-erf
// pair of gelu.cuh.
//
// The design trap: K3/K4 stream the 4C dimension in chunks and add each
// chunk's a·W2 as it goes, but a (and dz in the backward) is quantized with
// the absmax of its whole 4C-wide row, which is known only after every
// chunk, and a row of z does not fit on chip (64 x 1536 fp32 is 393 KB at
// C 384). So each block makes two passes over 4C: the first computes z
// (and da) chunk by chunk and keeps only the row absmax of gelu(z) (of dz);
// the second quantizes with the now known scale and accumulates the second
// product. K12a recomputes z in its second pass with the same
// instructions, at the int8 rate (3 products where the TPU kernel does 2);
// K12b stores dz in its first pass and reads it back (3 products, as the
// TPU kernel). The scales of u and do (absmax over C) are known up front.
//
// K12a is built as K3 is (convnext_tail.cu, hopper.cuh): one thread of a
// producer warp TMA-loads W1q and W2q chunk tiles (128 of the 4C columns;
// 128-byte swizzled boxes of 128 int8 x 64 rows, zeros past C) into a
// ring: pass 1's W1q tiles, then pass 2's W1q and W2q tile of each chunk.
// The consumers write uq = q(LN(h)) into a swizzled tile and run
// wgmma.mma_async m64n32k32 s8: z = uq·W1qᵀ and o += aq·W2qᵀ, both K-major,
// the only form 8-bit operands have (a k32 step is the 32 bytes of bf16's
// k16 step). A block takes 64 rows and four consumer warpgroups, each on
// 32 columns of every chunk's z and on every fourth 32-column piece of o
// (48 registers of o at C 384), so that an SM holds 16 consumer warps: the
// per-element work between the products (the rescale, GELU, the level)
// is most of the time, and with two warpgroups at 168 registers it ran
// slower than the mma.sync design it replaces. aq passes through a
// swizzled shared tile, two in turn. Pass 1 keeps two z a row for the
// absmax (GeluAbsMax; a row where GELU is flat takes every element,
// exact_absmax), and the levels are taken without a division in the
// common case (level, near_half). The per-row epilogue runs once at the
// end. The fp32-row entry runs the same kernel with the row type as a
// template parameter.
//
// K12b is built on the same machinery, with its own producer and four
// products: z = uq·W1qᵀ and da = doq·W2ᵀqᵀ in pass 1, du += dzq·W1ᵀqᵀ in
// pass 2, all K-major (the wrapper hands W2ᵀq and W1ᵀq over as (n, k)
// operands, so no transposed copy is made). The ring streams units of kCb
// 64-row boxes: each chunk's W1q and W2ᵀq tiles as two 64-row halves in
// pass 1, its W1ᵀq tile as two runs of its 64-row boxes of C in pass 2; at
// C 384 whole tiles (49 KB each) beside uq, doq and the exchange tiles
// would leave room for two, six units of 24 KB keep the next loading
// while one is read. One producer thread of a producer warpgroup streams
// them (setmaxnreg 24), four consumer warpgroups on 64 rows take 112
// registers (du, 64 x C int32, is 48 of them at C 384, beside z and da).
// Pass 1 forms dz = da⊙gelu′(z) chunk by chunk, keeps each row's absmax
// over every element (gelu′ is not monotone, so K12a's two candidates do
// not apply) and stores dz in fp32 scratch of the call, each thread its
// own 64 bytes a chunk; pass 2 reads it back, so its levels come from the
// very values the scale was taken from. Measured on an H100 against forming
// dz again in pass 2 (two more products and the rescale and gelu′ of every
// element, the first design), the round trip through device memory (77 MB
// at C 384, 308 MB at C 96, written and read once) was faster at every
// width (PERF.md §6). The levels are taken as K12a's, dzq passes through a
// swizzled exchange tile as aq does, and the LayerNorm backward runs once
// at the end, its two row sums combined over the warpgroups in shared
// memory.
//
// What bounds them: 2·2·C·4C int8 operations per row forward (3 products
// backward) against 3·C·2 bytes of rows; K12a's (N, 4C) intermediate never
// reaches device memory (K12b's dz does, once each way). At ConvNeXt-S's widths the rows' bytes bound K12a
// at C 96 and 192, its operations at C 384. Every block reads the int8
// weights from L2: W1q twice and W2q once (K12a), W1q, W2ᵀq and W1ᵀq once
// (K12b), per 64 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"
#include "hopper.cuh"
#include "mma.cuh"
#include "simt_f32.cuh"

namespace {

using namespace vit;

constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ int quantize(float v, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(v / s), -127.0f), 127.0f));
}

// ---- K12a on the tensor cores: int8 wgmma fed by a TMA ring -------------

namespace fwd {

using namespace vit::hopper;

constexpr int kGroups = 4;                      // consumer warpgroups
constexpr int kConsumers = 128 * kGroups;
constexpr int kBlockThreads = kConsumers + 32;  // + the producer warp
constexpr int kRows = 64;                       // rows a block
constexpr int kChunk = 128;  // 4C columns a chunk: one 128-byte row of aq
// The dynamic shared memory a block may use, less the alignment slack
constexpr int kSmemLimit = 232448 - 1024;
constexpr int kSmall = 4096;  // the ring's barriers, then the row scales

// The forward's tiling at width C: 64 rows a block; warpgroup wg takes
// columns 32·wg .. 32·wg + 31 of each chunk's z and the 32-column pieces
// wg, wg + 4, ... of o; aq passes through a shared exchange tile.
template <int C>
struct Fwd {
  static constexpr int kCb = (C + 127) / 128;    // 128-byte atoms of a row of C
  static constexpr int kKSteps = C / 32;         // k32 steps of z
  static constexpr int kPieces = C / 32;         // 32-column pieces of o
  static constexpr int kOwn = (kPieces + kGroups - 1) / kGroups;
  static constexpr int kOAtoms = (C + 63) / 64;  // 64-row boxes of W2q
  static constexpr int kChunks = 4 * C / kChunk;
  // a chunk's W1q tile: [half of its 128 rows][atom of C][64][128 B]; its
  // W2q tile: [64 rows of C][the chunk's 128 columns]
  static constexpr int kW1Bytes = 2 * kCb * static_cast<int>(kTileBytes);
  static constexpr int kW2Bytes = kOAtoms * static_cast<int>(kTileBytes);
  static constexpr int kStage = kW1Bytes > kW2Bytes ? kW1Bytes : kW2Bytes;
  // Byte offsets: uq [atom][64 rows][128 B], two exchange tiles, the ring,
  // the small region
  static constexpr int kAct = kCb * kRows * 128;
  static constexpr int kW = kAct + 2 * static_cast<int>(kTileBytes);
  static constexpr int kFit = (kSmemLimit - kW - kSmall) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kRing = kW + kStages * kStage;
  static constexpr int kScales = kRing + 256;
  static constexpr int kBytes = kRing + kSmall + 1024;
  static_assert(C % 32 == 0 && C <= 384 && (4 * C) % kChunk == 0, "C");
  static_assert(kStages >= 2, "a chunk's two tiles must fit the ring");
  static_assert(sizeof(Ring<kStages>) <= 256, "the ring's barriers");
  static_assert(256 + ((1 + kGroups) * kRows + 1 + 2 * kConsumers / 32) * 4 <= kSmall,
                "the row scales");
};

// Byte offset of int8 element (row, col) in a [C/128 atoms][rows][128 B]
// region, swizzled as TMA's 128-byte swizzle places it.
__device__ __forceinline__ int sw8(int row, int col, int rows) {
  return (col / 128) * rows * 128 + row * 128 +
         ((((col % 128) / 16) ^ (row % 8)) << 4) + col % 16;
}

// The producer: pass 1's W1q tiles of every chunk, then pass 2's W1q and
// W2q tiles chunk by chunk, each as soon as its ring stage is free.
template <int C>
__device__ __forceinline__ void produce(uint8_t* sm, const CUtensorMap* tw1,
                                        const CUtensorMap* tw2) {
  using L = Fwd<C>;
  Ring<L::kStages>& ring = *reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing);
  for (int i = 0; i < 3 * L::kChunks; ++i) {
    const int k = i - L::kChunks;
    const bool w1 = k < 0 || k % 2 == 0;
    const int f0 = (k < 0 ? i : k / 2) * kChunk;
    const int st = ring.stage(i);
    uint8_t* dst = sm + L::kW + st * L::kStage;
    ring.wait_empty(i);
    mbar_arrive_expect_tx(&ring.full[st], w1 ? L::kW1Bytes : L::kW2Bytes);
    if (w1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int b = 0; b < L::kCb; ++b)
          tma_load_2d(dst + (hh * L::kCb + b) * kTileBytes, tw1, &ring.full[st],
                      128 * b, f0 + 64 * hh);
    } else {
#pragma unroll
      for (int at = 0; at < L::kOAtoms; ++at)
        tma_load_2d(dst + at * kTileBytes, tw2, &ring.full[st], f0, 64 * at);
    }
  }
}

// The int8 level rint(v / s), clipped to ±127, as rint(t) of t = v·inv,
// inv = 1/s rounded: t is within 2^-23 of v / s relatively (1.5e-5 at
// |v / s| <= 127.5) and fl(v / s) within 3.8e-6 of it, so the two round
// alike unless t lies within 4e-5 of a half-integer (near_half), where the
// caller takes quantize's IEEE division. Branch-free, so a batch of
// levels is scheduled together, with one rarely taken branch for the batch.
__device__ __forceinline__ int level(float t) {
  return static_cast<int>(fminf(fmaxf(rintf(t), -127.0f), 127.0f));
}
__device__ __forceinline__ uint32_t near_half(float t) {
  return fabsf(t - rintf(t)) > 0.49996f;
}

// The per-row int8 quantization of a warp's row v (lane's columns lane +
// 32j) whose absmax over the lanes is amax: the levels into row r of the
// swizzled region q ([C/128 atoms][64 rows][128 B]), the scale into *s_out.
// Levels without a division but where one lies near a half-integer.
template <int kV>
__device__ __forceinline__ void quant_row(const float (&v)[kV], float amax,
                                          uint8_t* q, float* s_out, int r,
                                          int lane) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(amax, 1e-8f) * kInv127, inv = __frcp_rn(s);
  int l[kV];
  uint32_t flags = 0;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const float t = v[j] * inv;
    l[j] = level(t);
    flags |= near_half(t) << j;
  }
  if (flags) {
#pragma unroll
    for (int j = 0; j < kV; ++j)
      if (flags >> j & 1) l[j] = quantize(v[j], s);
  }
#pragma unroll
  for (int j = 0; j < kV; ++j)
    reinterpret_cast<int8_t*>(q)[sw8(r, lane + 32 * j, kRows)] =
        static_cast<int8_t>(l[j]);
  if (lane == 0) *s_out = s;
}

// LayerNorm of the block's rows (two-pass fp32 statistics), u = û·lns +
// lnb with the plain version's roundings, quantized per row into the
// swizzled uq region with its scale in su (and, where mu is not null, the
// row's mean and 1/σ into mu and rstd). A warp takes 4 rows, all of them
// read before any is reduced; rows at or past N read as zeros (u = lnb:
// finite, never stored). uq's columns past C are never read (z takes C/32
// k32 steps).
template <int C, typename T>
__device__ __forceinline__ void ln_quant(uint8_t* uq, float* su,
                                         const T* __restrict__ h,
                                         const T* __restrict__ lns,
                                         const T* __restrict__ lnb, int r0,
                                         int N, float eps,
                                         float* mu_out = nullptr,
                                         float* rstd_out = nullptr) {
  constexpr int kPer = kRows / (kConsumers / 32), kV = C / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float v[kPer][kV];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = r0 + warp * kPer + i;
#pragma unroll
    for (int j = 0; j < kV; ++j)
      v[i][j] = row < N ? to_f(h[static_cast<size_t>(row) * C + lane + 32 * j]) : 0.0f;
  }
  float sc[kV], bi[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    sc[j] = to_f(lns[lane + 32 * j]);
    bi[j] = to_f(lnb[lane + 32 * j]);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = warp * kPer + i;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kV; ++j) sum += v[i][j];
    const float mu = warp_sum(sum) / C;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      v[i][j] -= mu;
      sq += v[i][j] * v[i][j];
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      v[i][j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j], rstd), sc[j]), bi[j]);
      amax = fmaxf(amax, fabsf(v[i][j]));
    }
    quant_row<kV>(v[i], amax, uq, su + r, r, lane);
    if (mu_out != nullptr && lane == 0) {
      mu_out[r] = mu;
      rstd_out[r] = rstd;
    }
  }
}

// The fp32 value of a z accumulator element: ((acc·su)·s1 + b1), the plain
// version's roundings (quant.py's rescale).
template <typename T>
__device__ __forceinline__ float z_value(int acc, float su, float s1, T b1) {
  return __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(acc), su), s1), to_f(b1));
}

// The largest |gelu(z)| over a row's z from two of them, so that pass 1
// evaluates GELU twice a row instead of once an element. On z < 0 the
// tanh-erf GELU (gelu.cuh) stays within its flat minimum's depth: |gelu|
// <= 0.16997 down to z = −4√2, where u clamps and gelu becomes z times a
// constant. So a row whose largest |gelu| is at least kFlat has it at its
// largest z (GELU grows with z there) or at its smallest (z beyond the
// clamp), and the two give it; a row below kFlat, whose every z lies
// where GELU is flat or small, takes the max over every element instead
// (exact_absmax, a rare branch).
constexpr float kFlat = 0.171f;

struct GeluAbsMax {
  float top = -INFINITY, lowest = INFINITY;
  __device__ __forceinline__ void add(float z) {
    top = fmaxf(top, z);
    lowest = fminf(lowest, z);
  }
  __device__ __forceinline__ float value() const {
    return fmaxf(top > 0.0f ? gelu(top) : 0.0f, fabsf(gelu(lowest)));
  }
};

// The row absmax of gelu(z) over every element, for each of the block's
// rows whose two candidates read below kFlat (smax: [4][64] warpgroup
// shares of the candidates' value), written over that row's shares: the
// block's every consumer thread, on every 512th column of z, recomputes
// z from uq and W1q with dp4a, the same exact int32 sums as the wgmmas,
// then the rescale of z_value. wmax: two [16] rows of warp maxima, used
// in turn.
template <int C, typename T>
__device__ __noinline__ void exact_absmax(const uint8_t* uqs, const float* su,
                                         float* smax, float* wmax,
                                         const int8_t* __restrict__ w1q,
                                         const float* __restrict__ w1s,
                                         const T* __restrict__ b1) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int done = 0;
  for (int row = 0; row < kRows; ++row) {
    float m = smax[row];
    for (int k = 1; k < kGroups; ++k) m = fmaxf(m, smax[k * kRows + row]);
    if (m >= kFlat) continue;
    float e = 0.0f;
    for (int f = threadIdx.x; f < 4 * C; f += kConsumers) {
      const int4* w = reinterpret_cast<const int4*>(w1q + static_cast<size_t>(f) * C);
      int acc = 0;
      for (int k = 0; k < C; k += 16) {
        const int4 u = *reinterpret_cast<const int4*>(uqs + sw8(row, k, kRows));
        const int4 v = w[k / 16];
        acc = __dp4a(u.x, v.x, acc);
        acc = __dp4a(u.y, v.y, acc);
        acc = __dp4a(u.z, v.z, acc);
        acc = __dp4a(u.w, v.w, acc);
      }
      e = fmaxf(e, fabsf(gelu(z_value(acc, su[row], w1s[f], b1[f]))));
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) e = fmaxf(e, __shfl_xor_sync(0xffffffffu, e, o));
    float* wm = wmax + (done++ % 2) * (kConsumers / 32);
    if (lane == 0) wm[warp] = e;
    named_barrier(1, kConsumers);
    if (threadIdx.x == 0) {
      e = wm[0];
      for (int w = 1; w < kConsumers / 32; ++w) e = fmaxf(e, wm[w]);
      smax[row] = e;
      for (int k = 1; k < kGroups; ++k) smax[k * kRows + row] = 0.0f;
    }
  }
  named_barrier(1, kConsumers);
}

template <int C, typename T>
__global__ void __launch_bounds__(kBlockThreads, 1)
convnext_tail_fwd_q8_kernel(const __grid_constant__ CUtensorMap tw1,
                            const __grid_constant__ CUtensorMap tw2,
                            const T* __restrict__ h, const T* __restrict__ x,
                            const T* __restrict__ lns,
                            const T* __restrict__ lnb,
                            const int8_t* __restrict__ w1q,
                            const float* __restrict__ w1s,
                            const T* __restrict__ b1,
                            const float* __restrict__ w2s,
                            const T* __restrict__ b2,
                            const T* __restrict__ gamma, T* __restrict__ y,
                            int N, float eps) {
  using L = Fwd<C>;
  uint8_t* sm = &aligned_smem<uint8_t>();
  Ring<L::kStages>& ring = *reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing);
  float* su = reinterpret_cast<float*>(sm + L::kScales);  // [64]: u's scales
  float* smax = su + kRows;                               // [4][64]
  volatile int* flat = reinterpret_cast<int*>(smax + kGroups * kRows);  // a row below kFlat
  float* wmax = smax + kGroups * kRows + 1;               // [2][16]
  const int r0 = blockIdx.x * kRows;
  if (threadIdx.x == 0) {
    ring.init(1, kConsumers / 32);
    mbar_init_fence();
    *flat = 0;
  }
  __syncthreads();
  if (threadIdx.x == kConsumers) produce<C>(sm, &tw1, &tw2);
  if (threadIdx.x >= kConsumers) return;

  ln_quant<C, T>(sm, su, h, lns, lnb, r0, N, eps);
  fence_proxy_async();
  named_barrier(1, kConsumers);

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int lrow = warp * 16 + g;  // block row of row half 0
  const float su_r[2] = {su[lrow], su[lrow + 8]};
  const uint32_t uq = smem_u32(sm), w_base = smem_u32(sm + L::kW);
  auto tile = [&](int load) { return w_base + ring.stage(load) * L::kStage; };
  // z = uq·W1qᵀ, this warpgroup's 32 columns of the chunk whose W1q tile is
  // at w1: C/32 wgmmas m64n32k32, waited
  auto z_slice = [&](int (&z)[16], uint32_t w1) {
    const uint32_t u = opaque(uq);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < L::kKSteps; ++ks)
      wgmma_ss_s8_n32(
          z, desc_k(u + (ks / 4) * kRows * 128 + (ks % 4) * 32),
          desc_k(w1 + ((wg / 2) * L::kCb + ks / 4) * kTileBytes + (wg % 2) * 4096 +
                 (ks % 4) * 32),
          ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(z);
  };
  // the fp32 value of element e of this warpgroup's z in chunk j
  auto value = [&](const int (&z)[16], int e, int j) {
    const int f = j * kChunk + wg * 32 + (e / 4) * 8 + 2 * t + e % 2;
    return z_value(z[e], su_r[(e / 2) % 2], w1s[f], b1[f]);
  };

  // Pass 1: the row absmax of a = gelu(z) over all 4C columns.
  GeluAbsMax cand[2];
  for (int j = 0; j < L::kChunks; ++j) {
    ring.wait_full(j);
    int z[16];
    z_slice(z, tile(j));
    ring.release(j);
#pragma unroll
    for (int e = 0; e < 16; ++e) cand[(e / 2) % 2].add(value(z, e, j));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = cand[r].value();
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    if (t == 0) smax[wg * kRows + lrow + 8 * r] = m;
  }
  named_barrier(1, kConsumers);
  float sa[2], inv[2];
  auto row_scales = [&] {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = smax[lrow + 8 * r];
#pragma unroll
      for (int k = 1; k < kGroups; ++k) m = fmaxf(m, smax[k * kRows + lrow + 8 * r]);
      sa[r] = fmaxf(m, 1e-8f) * kInv127;
      inv[r] = __frcp_rn(sa[r]);
      if (m < kFlat) *flat = 1;
    }
  };
  row_scales();
  named_barrier(1, kConsumers);
  if (*flat) {  // rare: a row where GELU is flat
    exact_absmax<C, T>(sm, su, smax, wmax, w1q, w1s, b1);
    row_scales();
  }

  // Pass 2: recompute z, quantize a with its row scale into exchange tile
  // j % 2 (this warpgroup's 32 columns: k32 step wg), o += aq·W2qᵀ for the
  // warpgroup's pieces from the whole tile. A warpgroup rewrites a tile
  // only after the barrier of chunk j + 1, which the others pass after the
  // products of chunk j that read it.
  int o[L::kOwn][16];
#pragma unroll
  for (int i = 0; i < L::kOwn; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) o[i][e] = 0;
  for (int j = 0; j < L::kChunks; ++j) {
    const int i1 = L::kChunks + 2 * j, i2 = i1 + 1;
    ring.wait_full(i1);
    int z[16];
    z_slice(z, tile(i1));
    ring.release(i1);
    // every level at once, then the IEEE quotient where one lies near a
    // half-integer
    int q[16];
    uint32_t flags = 0;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float ts = gelu(value(z, e, j)) * inv[(e / 2) % 2];
      q[e] = level(ts);
      flags |= near_half(ts) << e;
    }
    if (flags) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (flags >> e & 1) q[e] = quantize(gelu(value(z, e, j)), sa[(e / 2) % 2]);
    }
    uint8_t* act = sm + L::kAct + (j & 1) * kTileBytes;
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      const uint16_t pair = static_cast<uint16_t>((q[e] & 0xff) | (q[e + 1] & 0xff) << 8);
      *reinterpret_cast<uint16_t*>(
          act + sw8(lrow + 8 * ((e / 2) % 2), wg * 32 + (e / 4) * 8 + 2 * t, kRows)) = pair;
    }
    fence_proxy_async();
    named_barrier(1, kConsumers);
    ring.wait_full(i2);
    const uint32_t a = smem_u32(act), w2 = tile(i2);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < L::kOwn; ++i) {
      const int p = wg + kGroups * i;
      if (p >= L::kPieces) continue;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_s8_n32(o[i], desc_k(a + 32 * ks),
                        desc_k(w2 + (p / 2) * kTileBytes + (p % 2) * 4096 + 32 * ks), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < L::kOwn; ++i) fence_regs(o[i]);
    ring.release(i2);
  }

  // y = x + γ·((o·sa)·s2 + b2), rows below N; each piece's x read at once.
#pragma unroll
  for (int i = 0; i < L::kOwn; ++i) {
    const int p = wg + kGroups * i;
    if (p >= L::kPieces) continue;
    float2 xv[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int row = r0 + lrow + 8 * r;
        xv[r][nt] = row < N ? load2(x + static_cast<size_t>(row) * C + p * 32 + nt * 8 + 2 * t)
                            : make_float2(0.0f, 0.0f);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + lrow + 8 * r;
      if (row >= N) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = p * 32 + nt * 8 + 2 * t;
        float out[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float ov = __fadd_rn(
              __fmul_rn(__fmul_rn(static_cast<float>(o[i][4 * nt + 2 * r + c]), sa[r]),
                        w2s[col + c]),
              to_f(b2[col + c]));
          out[c] = __fadd_rn(c ? xv[r][nt].y : xv[r][nt].x,
                             __fmul_rn(to_f(gamma[col + c]), ov));
        }
        store2(y + static_cast<size_t>(row) * C + col, out[0], out[1]);
      }
    }
  }
}

}  // namespace fwd

// ---- K12b on the same machinery: five int8 products, two passes ---------

namespace bwd {

using namespace vit::hopper;
using fwd::kChunk;
using fwd::kConsumers;
using fwd::kGroups;
using fwd::kRows;
using fwd::kSmemLimit;

constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kSmall = 6144;  // the ring's barriers, then the row vectors

// The backward's tiling at width C: 64 rows a block; warpgroup wg takes
// columns 32·wg .. 32·wg + 31 of each chunk's z and da (so dz) and the
// 32-column pieces wg, wg + 4, ... of du; dzq passes through a shared
// exchange tile. The ring streams units of kCb 64-row boxes: a chunk's
// W1q and W2ᵀq tiles (its 128 rows of 4C, all of C) are two units each,
// its W1ᵀq tile (all C rows, its 128 columns of 4C) two more. At C 384
// six units fit beside uq, doq and the exchange tiles (two whole chunk
// tiles would be all), so the next units load while a chunk's are read.
template <int C>
struct Bwd {
  static constexpr int kCb = (C + 127) / 128;    // 128-byte atoms of a row of C
  static constexpr int kKSteps = C / 32;         // k32 steps of z and da
  static constexpr int kPieces = C / 32;         // 32-column pieces of du
  static constexpr int kOwn = (kPieces + kGroups - 1) / kGroups;
  static constexpr int kBoxes = (C + 63) / 64;   // 64-row boxes of W1ᵀq
  static constexpr int kChunks = 4 * C / kChunk;
  static constexpr int kUnit = kCb * static_cast<int>(kTileBytes);
  // Byte offsets: uq and doq [atom][64 rows][128 B], two exchange tiles,
  // the ring, the small region
  static constexpr int kAct = kCb * kRows * 128;
  static constexpr int kExch = 2 * kAct;
  static constexpr int kW = kExch + 2 * static_cast<int>(kTileBytes);
  static constexpr int kFit = (kSmemLimit - kW - kSmall) / kUnit;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kRing = kW + kStages * kUnit;
  static constexpr int kScales = kRing + 256;
  static constexpr int kBytes = kRing + kSmall + 1024;
  static_assert(C % 32 == 0 && C <= 384 && (4 * C) % kChunk == 0, "C");
  static_assert(kBoxes <= 2 * kCb, "a W1ᵀq tile in two units");
  static_assert(kStages >= 4, "a chunk's W1q and W2ᵀq units in the ring");
  static_assert(sizeof(Ring<kStages>) <= 256, "the ring's barriers");
  static_assert(256 + (4 + 3 * kGroups) * kRows * 4 <= kSmall, "row vectors");
};

// The producer: each chunk's W1q and W2ᵀq units in pass 1, then its W1ᵀq
// units in pass 2, each as soon as its stage is free. A
// W1q or W2ᵀq unit is a 64-row half of the chunk's tile (kCb boxes of 128
// columns of C, zeros past C); a W1ᵀq unit kCb of the tile's 64-row boxes
// of C (the second holds one at C 192).
template <int C>
__device__ __forceinline__ void produce(uint8_t* sm, const CUtensorMap* tw1,
                                        const CUtensorMap* tw2t,
                                        const CUtensorMap* tw1t) {
  using L = Bwd<C>;
  Ring<L::kStages>& ring = *reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing);
  int i = 0;
  for (int pass = 0; pass < 2; ++pass)
    for (int j = 0; j < L::kChunks; ++j)
      for (int w = 2 * pass; w < 2 + pass; ++w)
        for (int u = 0; u < 2; ++u, ++i) {
          const int st = ring.stage(i);
          uint8_t* dst = sm + L::kW + st * L::kUnit;
          ring.wait_empty(i);
          if (w < 2) {
            mbar_arrive_expect_tx(&ring.full[st], L::kUnit);
            for (int b = 0; b < L::kCb; ++b)
              tma_load_2d(dst + b * kTileBytes, w ? tw2t : tw1, &ring.full[st],
                          128 * b, j * kChunk + 64 * u);
          } else {
            const int b0 = u * L::kCb;
            const int n = L::kBoxes - b0 < L::kCb ? L::kBoxes - b0 : L::kCb;
            mbar_arrive_expect_tx(&ring.full[st], n * kTileBytes);
            for (int b = 0; b < n; ++b)
              tma_load_2d(dst + b * kTileBytes, tw1t, &ring.full[st],
                          j * kChunk, 64 * (b0 + b));
          }
        }
}

// do = γ⊙dy of the block's rows in fp32 (the plain version's product),
// quantized per row into the swizzled doq region with its scale in sd, as
// ln_quant quantizes u; rows at or past N read as zeros (every level 0).
template <int C, typename T>
__device__ __forceinline__ void do_quant(uint8_t* doq, float* sd,
                                         const T* __restrict__ dy,
                                         const T* __restrict__ gamma, int r0,
                                         int N) {
  constexpr int kPer = kRows / (kConsumers / 32), kV = C / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float gm[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) gm[j] = to_f(gamma[lane + 32 * j]);
  float v[kPer][kV];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = r0 + warp * kPer + i;
#pragma unroll
    for (int j = 0; j < kV; ++j)
      v[i][j] = row < N ? __fmul_rn(to_f(dy[static_cast<size_t>(row) * C + lane + 32 * j]),
                                    gm[j])
                        : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < kV; ++j) amax = fmaxf(amax, fabsf(v[i][j]));
    const int r = warp * kPer + i;
    fwd::quant_row<kV>(v[i], amax, doq, sd + r, r, lane);
  }
}

// The consumers: uq and doq, then one loop over the chunks twice. Pass 1
// (it < kChunks) forms dz, keeps each row's largest |dz| and stores dz in
// the scratch; pass 2 reads it back (the same values, so the scale and the
// levels agree), takes its levels with the row scale, passes dzq through
// exchange tile j % 2 and adds the warpgroup's pieces of du = dzq·W1ᵀq. A
// warpgroup rewrites an exchange tile only after the barrier of chunk
// j + 1, which the others pass after the products of chunk j that read
// it. Then the LayerNorm backward, its two row sums combined over the
// warpgroups in shared memory.
template <int C, typename T>
__device__ __forceinline__ void consume(uint8_t* sm, const T* __restrict__ h,
                                        const T* __restrict__ dy,
                                        const T* __restrict__ lns,
                                        const T* __restrict__ lnb,
                                        const float* __restrict__ w1s,
                                        const float* __restrict__ w2ts,
                                        const float* __restrict__ w1ts,
                                        const T* __restrict__ b1,
                                        const T* __restrict__ gamma,
                                        T* __restrict__ dh,
                                        float4* __restrict__ dzs, int N,
                                        float eps) {
  using L = Bwd<C>;
  Ring<L::kStages>& ring = *reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing);
  float* su = reinterpret_cast<float*>(sm + L::kScales);  // [64] u's scales
  float* sd = su + kRows;                                 // [64] do's
  float* smu = sd + kRows;                                // [64] means
  float* srstd = smu + kRows;                             // [64] 1/σ
  float* smax = srstd + kRows;                            // [4][64] |dz| maxima
  float* ssum1 = smax + kGroups * kRows;                  // [4][64] Σ dû
  float* ssum2 = ssum1 + kGroups * kRows;                 // [4][64] Σ dû·û
  const int r0 = blockIdx.x * kRows;
  fwd::ln_quant<C, T>(sm, su, h, lns, lnb, r0, N, eps, smu, srstd);
  do_quant<C, T>(sm + L::kAct, sd, dy, gamma, r0, N);
  fence_proxy_async();
  named_barrier(1, kConsumers);

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int lrow = warp * 16 + g;  // block row of row half 0
  const float su_r[2] = {su[lrow], su[lrow + 8]};
  const float sd_r[2] = {sd[lrow], sd[lrow + 8]};
  const uint32_t w_base = smem_u32(sm + L::kW);
  auto unit = [&](int load) { return w_base + ring.stage(load) * L::kUnit; };
  // acc (+)= A·Wᵀ over C: this warpgroup's 32 columns of a chunk, A the
  // [atom][64][128 B] region at a, W's 64-row half wg / 2 in the unit at w
  auto over_c = [&](int (&acc)[16], uint32_t a, uint32_t w) {
#pragma unroll
    for (int ks = 0; ks < L::kKSteps; ++ks)
      wgmma_ss_s8_n32(acc, desc_k(a + (ks / 4) * kRows * 128 + (ks % 4) * 32),
                      desc_k(w + (wg % 2) * 4096 + (ks / 4) * kTileBytes +
                             (ks % 4) * 32),
                      ks > 0);
  };

  // dz of this warpgroup's 32 columns of chunk j, from its W1q and W2ᵀq
  // units at loads i0 .. i0 + 3: z = uq·W1qᵀ and da = doq·W2ᵀqᵀ, then
  // dz = ((da·sd)·s2ᵀ)⊙gelu′((z·su)·s1 + b1) with the plain version's
  // roundings; element e at row lrow + 8·(e / 2 % 2)
  auto form_dz = [&](float (&dz)[16], int j, int i0) {
    int z[16], d[16];
    ring.wait_full(i0);
    ring.wait_full(i0 + 1);
    wgmma_fence();
    over_c(z, opaque(smem_u32(sm)), unit(i0 + wg / 2));
    wgmma_commit();
    ring.wait_full(i0 + 2);
    ring.wait_full(i0 + 3);
    over_c(d, opaque(smem_u32(sm + L::kAct)), unit(i0 + 2 + wg / 2));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(z);
    fence_regs(d);
#pragma unroll
    for (int k = 0; k < 4; ++k) ring.release(i0 + k);
#pragma unroll
    for (int j8 = 0; j8 < 4; ++j8) {
      const int f = j * kChunk + wg * 32 + 8 * j8 + 2 * t;
      const float2 sz = *reinterpret_cast<const float2*>(w1s + f);
      const float2 sa = *reinterpret_cast<const float2*>(w2ts + f);
      const float2 bz = load2(b1 + f);
#pragma unroll
      for (int e = 4 * j8; e < 4 * j8 + 4; ++e) {
        const int r = (e / 2) % 2, c = e % 2;
        const float zf = fwd::z_value(z[e], su_r[r], c ? sz.y : sz.x, c ? bz.y : bz.x);
        const float da =
            __fmul_rn(__fmul_rn(static_cast<float>(d[e]), sd_r[r]), c ? sa.y : sa.x);
        dz[e] = __fmul_rn(da, gelu_grad(zf));
      }
    }
  };

  float amax[2] = {0.0f, 0.0f}, sg[2] = {0.0f, 0.0f}, inv[2] = {0.0f, 0.0f};
  int du[L::kOwn][16];
#pragma unroll
  for (int i = 0; i < L::kOwn; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) du[i][e] = 0;
#pragma unroll 1
  for (int it = 0; it < 2 * L::kChunks; ++it) {
    const bool pass2 = it >= L::kChunks;
    const int j = pass2 ? it - L::kChunks : it;
    const int i0 = pass2 ? 4 * L::kChunks + 2 * j : 4 * j;
    // this thread's 16 dz of chunk j in the scratch: its own 64 bytes,
    // written in pass 1 and read back in pass 2
    float4* mine = dzs + ((static_cast<size_t>(blockIdx.x) * L::kChunks + j) *
                          kConsumers + threadIdx.x) * 4;
    if (it == L::kChunks) {  // dz's row scales from pass 1's maxima
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = amax[r];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (t == 0) smax[wg * kRows + lrow + 8 * r] = m;
      }
      named_barrier(1, kConsumers);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = smax[lrow + 8 * r];
#pragma unroll
        for (int k = 1; k < kGroups; ++k) m = fmaxf(m, smax[k * kRows + lrow + 8 * r]);
        sg[r] = fmaxf(m, 1e-8f) * kInv127;
        inv[r] = __frcp_rn(sg[r]);
      }
    }
    float dz[16];
    if (pass2) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 v = __ldcs(mine + k);
        dz[4 * k] = v.x;
        dz[4 * k + 1] = v.y;
        dz[4 * k + 2] = v.z;
        dz[4 * k + 3] = v.w;
      }
    } else {
      form_dz(dz, j, i0);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        mine[k] = make_float4(dz[4 * k], dz[4 * k + 1], dz[4 * k + 2], dz[4 * k + 3]);
    }
    if (!pass2) {
#pragma unroll
      for (int e = 0; e < 16; ++e) amax[(e / 2) % 2] = fmaxf(amax[(e / 2) % 2], fabsf(dz[e]));
      continue;
    }
    // every level at once, then the IEEE quotient where one lies near a
    // half-integer
    int q[16];
    uint32_t flags = 0;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float ts = dz[e] * inv[(e / 2) % 2];
      q[e] = fwd::level(ts);
      flags |= fwd::near_half(ts) << e;
    }
    if (flags) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (flags >> e & 1) q[e] = quantize(dz[e], sg[(e / 2) % 2]);
    }
    uint8_t* xt = sm + L::kExch + (j & 1) * kTileBytes;
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      const uint16_t pair = static_cast<uint16_t>((q[e] & 0xff) | (q[e + 1] & 0xff) << 8);
      *reinterpret_cast<uint16_t*>(
          xt + fwd::sw8(lrow + 8 * ((e / 2) % 2), wg * 32 + (e / 4) * 8 + 2 * t, kRows)) = pair;
    }
    fence_proxy_async();
    named_barrier(1, kConsumers);
    // du += dzq·W1ᵀq: piece p is W1ᵀq's rows 32p .. 32p + 31, box p / 2
    ring.wait_full(i0);
    ring.wait_full(i0 + 1);
    const uint32_t a = smem_u32(xt);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < L::kOwn; ++i) {
      const int p = wg + kGroups * i;
      if (p >= L::kPieces) continue;
      const int b = p / 2;
      const uint32_t w = unit(i0 + b / L::kCb) + (b % L::kCb) * kTileBytes + (p % 2) * 4096;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_s8_n32(du[i], desc_k(a + 32 * ks), desc_k(w + 32 * ks), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < L::kOwn; ++i) fence_regs(du[i]);
    ring.release(i0);
    ring.release(i0 + 1);
  }

  // The LayerNorm backward with dû = ((du·sg)·s1ᵀ)·lns and û = (h − μ)·
  // rstd: dh = rstd·(dû − mean(dû) − û·mean(dû·û)), rows below N.
  float mu[2], rs[2], s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mu[r] = smu[lrow + 8 * r];
    rs[r] = srstd[lrow + 8 * r];
  }
  auto dhat = [&](int i, int e, int col) {
    return __fmul_rn(
        __fmul_rn(__fmul_rn(static_cast<float>(du[i][e]), sg[(e / 2) % 2]), w1ts[col]),
        to_f(lns[col]));
  };
#pragma unroll
  for (int i = 0; i < L::kOwn; ++i) {
    const int p = wg + kGroups * i;
    if (p >= L::kPieces) continue;
#pragma unroll
    for (int j8 = 0; j8 < 4; ++j8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + lrow + 8 * r, col = p * 32 + 8 * j8 + 2 * t;
        const float2 hv = row < N ? load2(h + static_cast<size_t>(row) * C + col)
                                  : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dv = dhat(i, 4 * j8 + 2 * r + c, col + c);
          const float uh = __fmul_rn(__fsub_rn(c ? hv.y : hv.x, mu[r]), rs[r]);
          s1[r] += dv;
          s2[r] += dv * uh;
        }
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o < 4; o *= 2) {
      s1[r] += __shfl_xor_sync(0xffffffffu, s1[r], o);
      s2[r] += __shfl_xor_sync(0xffffffffu, s2[r], o);
    }
    if (t == 0) {
      ssum1[wg * kRows + lrow + 8 * r] = s1[r];
      ssum2[wg * kRows + lrow + 8 * r] = s2[r];
    }
  }
  named_barrier(1, kConsumers);
  float c1[2], c2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float a1 = ssum1[lrow + 8 * r], a2 = ssum2[lrow + 8 * r];
#pragma unroll
    for (int k = 1; k < kGroups; ++k) {
      a1 += ssum1[k * kRows + lrow + 8 * r];
      a2 += ssum2[k * kRows + lrow + 8 * r];
    }
    c1[r] = a1 / C;
    c2[r] = a2 / C;
  }
#pragma unroll
  for (int i = 0; i < L::kOwn; ++i) {
    const int p = wg + kGroups * i;
    if (p >= L::kPieces) continue;
#pragma unroll
    for (int j8 = 0; j8 < 4; ++j8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + lrow + 8 * r, col = p * 32 + 8 * j8 + 2 * t;
        if (row >= N) continue;
        const size_t at = static_cast<size_t>(row) * C + col;
        const float2 hv = load2(h + at);
        float out[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dv = dhat(i, 4 * j8 + 2 * r + c, col + c);
          const float uh = __fmul_rn(__fsub_rn(c ? hv.y : hv.x, mu[r]), rs[r]);
          out[c] = __fmul_rn(rs[r], __fsub_rn(__fsub_rn(dv, c1[r]), __fmul_rn(uh, c2[r])));
        }
        store2(dh + at, out[0], out[1]);
      }
  }
}

// K12b. The roles split once: the producer warpgroup gives registers up
// and one of its threads streams the weights; the consumer warpgroups take
// 112 registers a thread, for du (48 of them at C 384) beside z and da.
template <int C, typename T>
__global__ void __launch_bounds__(kThreads, 1)
convnext_tail_bwd_q8_kernel(const __grid_constant__ CUtensorMap tw1,
                            const __grid_constant__ CUtensorMap tw2t,
                            const __grid_constant__ CUtensorMap tw1t,
                            const T* __restrict__ h, const T* __restrict__ dy,
                            const T* __restrict__ lns,
                            const T* __restrict__ lnb,
                            const float* __restrict__ w1s,
                            const float* __restrict__ w2ts,
                            const float* __restrict__ w1ts,
                            const T* __restrict__ b1,
                            const T* __restrict__ gamma, T* __restrict__ dh,
                            float4* __restrict__ dzs, int N, float eps) {
  using L = Bwd<C>;
  uint8_t* sm = &aligned_smem<uint8_t>();
  if (threadIdx.x == 0) {
    reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing)->init(1, kConsumers / 32);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) produce<C>(sm, &tw1, &tw2t, &tw1t);
  } else {
    setmaxnreg_inc<112>();
    consume<C, T>(sm, h, dy, lns, lnb, w1s, w2ts, w1ts, b1, gamma, dh,
                           dzs, N, eps);
  }
}

}  // namespace bwd

template <int C, typename T>
int launch_fwd(const void* h, const void* x, const void* lns, const void* lnb,
               const void* w1q, const void* w1s, const void* b1, const void* w2q,
               const void* w2s, const void* b2, const void* gamma, void* y,
               int N, float eps, cudaStream_t stream) {
  using L = fwd::Fwd<C>;
  CUtensorMap tw1, tw2;
  int err = hopper::byte_matrix_map(&tw1, w1q, 4 * C, C);
  if (!err) err = hopper::byte_matrix_map(&tw2, w2q, C, 4 * C);
  if (err) return err;
  err = static_cast<int>(cudaFuncSetAttribute(
      fwd::convnext_tail_fwd_q8_kernel<C, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes));
  if (err) return err;
  fwd::convnext_tail_fwd_q8_kernel<C, T>
      <<<(N + fwd::kRows - 1) / fwd::kRows, fwd::kBlockThreads, L::kBytes, stream>>>(
          tw1, tw2, static_cast<const T*>(h), static_cast<const T*>(x),
          static_cast<const T*>(lns), static_cast<const T*>(lnb),
          static_cast<const int8_t*>(w1q), static_cast<const float*>(w1s),
          static_cast<const T*>(b1), static_cast<const float*>(w2s),
          static_cast<const T*>(b2),
          static_cast<const T*>(gamma), static_cast<T*>(y), N, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int C, typename T>
int launch_bwd(const void* h, const void* dy, const void* lns, const void* lnb,
               const void* w1q, const void* w1s, const void* w2tq,
               const void* w2ts, const void* w1tq, const void* w1ts,
               const void* b1, const void* gamma, void* dh, void* dz, int N,
               float eps, cudaStream_t stream) {
  using L = bwd::Bwd<C>;
  if (dz == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tw1, tw2t, tw1t;
  int err = hopper::byte_matrix_map(&tw1, w1q, 4 * C, C);
  if (!err) err = hopper::byte_matrix_map(&tw2t, w2tq, 4 * C, C);
  if (!err) err = hopper::byte_matrix_map(&tw1t, w1tq, C, 4 * C);
  if (err) return err;
  err = static_cast<int>(cudaFuncSetAttribute(
      bwd::convnext_tail_bwd_q8_kernel<C, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes));
  if (err) return err;
  bwd::convnext_tail_bwd_q8_kernel<C, T>
      <<<(N + fwd::kRows - 1) / fwd::kRows, bwd::kThreads, L::kBytes, stream>>>(
          tw1, tw2t, tw1t, static_cast<const T*>(h), static_cast<const T*>(dy),
          static_cast<const T*>(lns), static_cast<const T*>(lnb),
          static_cast<const float*>(w1s), static_cast<const float*>(w2ts),
          static_cast<const float*>(w1ts), static_cast<const T*>(b1),
          static_cast<const T*>(gamma), static_cast<T*>(dh),
          static_cast<float4*>(dz), N, eps);
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
           const void* b1, const void* gamma, void* dh, void* dz, int N,
           int C, float eps, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return launch_bwd<96, T>(h, dy, lns, lnb, w1q, w1s, w2tq, w2ts, w1tq, w1ts, b1, gamma, dh, dz, N, eps, st);
    case 192: return launch_bwd<192, T>(h, dy, lns, lnb, w1q, w1s, w2tq, w2ts, w1tq, w1ts, b1, gamma, dh, dz, N, eps, st);
    case 384: return launch_bwd<384, T>(h, dy, lns, lnb, w1q, w1s, w2tq, w2ts, w1tq, w1ts, b1, gamma, dh, dz, N, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K12a's dynamic shared memory at width C, bytes, or 0 for another C (for
// the build report).
extern "C" int convnext_tail_fwd_q8_smem(int C) {
  switch (C) {
    case 96: return fwd::Fwd<96>::kBytes;
    case 192: return fwd::Fwd<192>::kBytes;
    case 384: return fwd::Fwd<384>::kBytes;
    default: return 0;
  }
}

// K12b's dynamic shared memory at width C, bytes, or 0 for another C.
extern "C" int convnext_tail_bwd_q8_smem(int C) {
  switch (C) {
    case 96: return bwd::Bwd<96>::kBytes;
    case 192: return bwd::Bwd<192>::kBytes;
    case 384: return bwd::Bwd<384>::kBytes;
    default: return 0;
  }
}

// h, x, y: (N, C) bf16; lns, lnb, b2, gamma: (C,) bf16; b1: (4C,) bf16;
// w1q: (4C, C) int8 with scales w1s (4C,) fp32; w2q: (C, 4C) int8 with
// w2s (C,) fp32. All contiguous and 16-byte aligned. C in {96, 192, 384}. Returns
// cudaGetLastError() after the launch, the error of building a tensor map,
// or cudaErrorInvalidValue for another C.
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
// (4C,), w1tq (C, 4C) / w1ts (C,); dz fp32 scratch of ceil(N / 64)·64·4C
// values. All contiguous and 16-byte aligned. C in {96, 192, 384}. Returns
// as convnext_tail_fwd_q8 (cudaErrorInvalidValue for a null dz).
extern "C" int convnext_tail_bwd_q8(const void* h, const void* dy, const void* lns,
                                    const void* lnb, const void* w1q,
                                    const void* w1s, const void* w2tq,
                                    const void* w2ts, const void* w1tq,
                                    const void* w1ts, const void* b1,
                                    const void* gamma, void* dh, void* dz,
                                    int N, int C, float eps, void* stream) {
  return bwd_q8<bf16>(h, dy, lns, lnb, w1q, w1s, w2tq, w2ts, w1tq, w1ts, b1,
                      gamma, dh, dz, N, C, eps, stream);
}

// The fp32-row form: h, dy, dh and lns, lnb, b1, gamma fp32; the int8
// operands as for convnext_tail_bwd_q8.
extern "C" int convnext_tail_bwd_q8_f32(const void* h, const void* dy,
                                        const void* lns, const void* lnb,
                                        const void* w1q, const void* w1s,
                                        const void* w2tq, const void* w2ts,
                                        const void* w1tq, const void* w1ts,
                                        const void* b1, const void* gamma,
                                        void* dh, void* dz, int N, int C,
                                        float eps, void* stream) {
  return bwd_q8<float>(h, dy, lns, lnb, w1q, w1s, w2tq, w2ts, w1tq, w1ts, b1,
                       gamma, dh, dz, N, C, eps, stream);
}
