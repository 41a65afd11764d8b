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
// the second recomputes them with the same instructions, quantizes with the
// now known scale and accumulates the second product. The first product is
// recomputed, at the int8 rate: 3 products forward and 5 backward where the
// TPU kernel does 2 and 3. The scales of u and do (absmax over C) are known
// up front.
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
// K12b keeps its first design: every product mma.sync m16n8k32 from
// shared memory filled by synchronous 16-byte loads, a 64 x C int32
// accumulator in the registers of 8 warps (4 row groups x 2 column halves).
//
// What bounds them: 2·2·C·4C int8 operations per row forward (3 products
// backward) against 3·C·2 bytes of rows; the (N, 4C) intermediate never
// reaches device memory. At ConvNeXt-S's widths the rows' bytes bound K12a
// at C 96 and 192, its operations at C 384. Every block reads the int8
// weights from L2: W1q twice and W2q once (K12a), per 64 or 128 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"
#include "hopper.cuh"
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

// LayerNorm of the block's rows (two-pass fp32 statistics), u = û·lns +
// lnb with the plain version's roundings, quantized per row into the
// swizzled uq region with its scale in su. A warp takes 4 rows, all of
// them read before any is reduced; rows at or past N read as zeros (u =
// lnb: finite, never stored). uq's columns past C are never read (z takes
// C/32 k32 steps).
template <int C, typename T>
__device__ __forceinline__ void ln_quant(uint8_t* uq, float* su,
                                         const T* __restrict__ h,
                                         const T* __restrict__ lns,
                                         const T* __restrict__ lnb, int r0,
                                         int N, float eps) {
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
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = fmaxf(amax, 1e-8f) * kInv127, inv = __frcp_rn(s);
    int q[kV];
    uint32_t flags = 0;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const float t = v[i][j] * inv;
      q[j] = level(t);
      flags |= near_half(t) << j;
    }
    if (flags) {
#pragma unroll
      for (int j = 0; j < kV; ++j)
        if (flags >> j & 1) q[j] = quantize(v[i][j], s);
    }
#pragma unroll
    for (int j = 0; j < kV; ++j)
      reinterpret_cast<int8_t*>(uq)[sw8(r, lane + 32 * j, kRows)] =
          static_cast<int8_t>(q[j]);
    if (lane == 0) su[r] = s;
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
