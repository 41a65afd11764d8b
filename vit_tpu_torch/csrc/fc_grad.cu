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
// is deterministic, with no atomics. wgmma and TMA are later work (the fp32
// form below has them; its kernel is templated on the number of parts, so
// that a one-part instantiation can take this kernel's place).
//
// The fp32 form (fc_grad_f32), for fp32 g and x, where the Pallas kernel
// sums its fp32 operands' products at full precision: the same dW and db,
// dW as the TPU's Precision.HIGHEST takes it, six bf16 products of three
// bf16 parts of each operand (hopper.cuh's split products), on wgmma. Both
// operands are read MN-major, as they lie in memory: N, the reduction, is
// the row index of g and of x, so gᵀ and x reach wgmma through the
// transpose bits (wgmma_ss_mn128) and no transposed copy is made. A block
// of four warpgroups owns a 128 × 128 dW tile over its split of N:
//   - one thread of the converter warpgroups TMA-loads each 32-row atom's
//     fp32 tiles of g and x (4 boxes of 32 columns each) into a 4-stage
//     ring, and the two converter warpgroups split them into three bf16
//     parts (x = x0 + x1 + x2 exactly) in swizzled part tiles, two buffers
//     deep, fence.proxy.async before the consumers' products read them;
//   - the two consumer warpgroups take 64 dW rows each, m64n128k16, each
//     atom's six products in a fresh accumulator added to the tile's sum in
//     registers (a sum chained in one accumulator loses low bits at each
//     product, hopper.cuh:mma_rb_parts_into);
//   - the blocks of the first F_in column sum db from the fp32 g tiles in
//     the converters' registers, never from the parts, in a fixed order.
// Split in the kernel, the parts never reach device memory. Built on an
// H100 and not kept (PERF.md §6): a pre-split pass (472 MB of parts
// written at fc2, 1.5× the fp32 tiles' bytes read from L2), one converter
// warpgroup (clock64 counters showed the consumers waiting on its split),
// one atom's products kept in flight (spilled under setmaxnreg), gᵀ's
// fragments split in the consumers' registers (A from registers, x alone
// through the converter) and a ring in place of the converters' barrier:
// all slower. The block's shared-memory traffic (TMA in, the split's
// reads and writes, the products' operand reads: 256 KB an atom) is the
// likely limit.
// The same fixed-order split partials as the bf16 kernel; the caller
// chooses the splits so that the 1-block-an-SM grid fills whole waves.
// Bound: 12·N·F_out·F_in FLOP at 989/6 TFLOP/s (0.586 ms at fc2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
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

// ---- the fp32 form: split bf16 products on wgmma --------------------------

namespace split {

using namespace vit::hopper;

constexpr int kAtom = 32;                    // rows of N an atom
constexpr int kConsumers = 256;              // two warpgroups, 64 dW rows each
constexpr int kConverters = 256;             // two warpgroups
constexpr int kThreads = kConsumers + kConverters;
constexpr int kBox = kAtom * 128;            // an atom's 128-byte-wide box
constexpr int kF32Stage = 2 * 4 * kBox;      // g's, then x's 128 fp32 columns
constexpr int kF32Stages = 4;

// The shared memory: a ring of fp32 stages (each 4 TMA boxes of 32 columns
// of g, then of x), two buffers of bf16 parts ([operand g, x][part][64-col
// atom][32 rows][128 B], the 128-byte swizzle), the barriers.
template <int kParts>
struct Plan {
  static constexpr int kPart = 2 * kBox;           // one part of 128 columns
  static constexpr int kOperand = kParts * kPart;
  static constexpr int kBuf = 2 * kOperand;
  static constexpr int kBufs = kF32Stages * kF32Stage;  // offset of the buffers
  static constexpr int kBars = kBufs + 2 * kBuf;
  static constexpr int kBytes = kBars + 256 + 1024;
};

struct Bars {
  uint64_t f32[kF32Stages];  // an fp32 stage landed (TMA bytes)
  uint64_t full[2];          // a parts buffer written (every converter thread)
  uint64_t empty[2];         // a parts buffer read (8 consumer warps)
};

// An atom's fp32 boxes: g's columns m0 .. m0 + 127 and x's c0 .. c0 + 127
// of rows n0 .. n0 + 31 (zeros past N), into stage st.
__device__ __forceinline__ void load_atom(uint8_t* sm, Bars& bars,
                                          const CUtensorMap* tg,
                                          const CUtensorMap* tx, int st,
                                          int m0, int c0, int n0) {
  uint8_t* dst = sm + st * kF32Stage;
  mbar_arrive_expect_tx(&bars.f32[st], kF32Stage);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    tma_load_2d(dst + b * kBox, tg, &bars.f32[st], m0 + 32 * b, n0);
    tma_load_2d(dst + (4 + b) * kBox, tx, &bars.f32[st], c0 + 32 * b, n0);
  }
}

// The converter warpgroups: each atom's fp32 tiles from the ring into
// kParts bf16 parts in buffer a % 2 (x = x0 + x1 + x2 exactly, as
// hopper.cuh:put_a splits), as soon as the consumers are done with that
// buffer's last atom. Thread ct takes 4 columns (4·(ct % 32) ..) of the
// rows ct / 32 + 8k of both operands; its thread 0 loads stage a % 4
// again for atom a + 4 once every converter has read it. The blocks of the
// first F_in column also sum db from the fp32 g in registers: each thread
// its 4 columns over its rows in order, then the eight threads of a column
// in order.
template <int kParts>
__device__ __forceinline__ void convert(uint8_t* sm, Bars& bars,
                                        const CUtensorMap* tg,
                                        const CUtensorMap* tx, int m0, int c0,
                                        int n_begin, int atoms, bool with_db,
                                        float* db) {
  using P = Plan<kParts>;
  constexpr int kSets = kConverters / 32;  // row sets: rows ≡ set (mod kSets)
  const int ct = threadIdx.x - kConsumers, cc = ct % 32, rr0 = ct / 32;
  if (ct == 0)
    for (int a = 0; a < atoms && a < kF32Stages; ++a)
      load_atom(sm, bars, tg, tx, a, m0, c0, n_begin + kAtom * a);
  float dbacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int col = 4 * cc;
  const int src_off = (cc / 8) * kBox, dst_off = (col / 64) * kBox + (col % 8) * 2;
  for (int a = 0; a < atoms; ++a) {
    const int st = a % kF32Stages, buf = a % 2;
    mbar_wait(&bars.f32[st], (a / kF32Stages) & 1);
    if (a >= 2) mbar_wait(&bars.empty[buf], ((a - 2) / 2) & 1);
    const uint8_t* src = sm + st * kF32Stage;
    uint8_t* dst = sm + P::kBufs + buf * P::kBuf;
#pragma unroll
    for (int op = 0; op < 2; ++op)
#pragma unroll
      for (int k = 0; k < kAtom / kSets; ++k) {
        const int rr = rr0 + kSets * k;
        const float4 f = *reinterpret_cast<const float4*>(
            src + op * 4 * kBox + src_off + rr * 128 + (((cc % 8) ^ (rr % 8)) << 4));
        float v[4] = {f.x, f.y, f.z, f.w};
        if (op == 0 && with_db)
#pragma unroll
          for (int i = 0; i < 4; ++i) dbacc[i] += v[i];
        uint8_t* o = dst + op * P::kOperand + dst_off + rr * 128 +
                     ((((col % 64) / 8) ^ (rr % 8)) << 4);
        store_parts<kParts>(v, reinterpret_cast<bf16*>(o), P::kPart / 2);
      }
    fence_proxy_async();
    mbar_arrive(&bars.full[buf]);
    named_barrier(2, kConverters);  // every converter is done with stage st
    if (ct == 0 && a + kF32Stages < atoms)
      load_atom(sm, bars, tg, tx, st, m0, c0, n_begin + kAtom * (a + kF32Stages));
  }
  if (with_db) {  // the fp32 stages are free: the row sets of a column
    float* s = reinterpret_cast<float*>(sm);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[rr0 * 128 + col + i] = dbacc[i];
    named_barrier(2, kConverters);
    if (ct < 128) {
      float v = s[ct];
#pragma unroll
      for (int k = 1; k < kSets; ++k) v += s[k * 128 + ct];
      db[m0 + ct] = v;
    }
  }
}

// A consumer warpgroup: dW rows m0 + 64·wg .. + 63, all 128 columns, over
// the block's atoms: each atom's kParts-part product (six bf16 products,
// small terms first: hopper.cuh's split_a/split_b) in a fresh accumulator,
// then added to the sum in registers; then the tile into out.
template <int kParts>
__device__ __forceinline__ void consume(uint8_t* sm, Bars& bars, float* out,
                                        int Fi, int m0, int c0, int atoms) {
  using P = Plan<kParts>;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  const uint32_t bufs = smem_u32(sm + P::kBufs);
  for (int a = 0; a < atoms; ++a) {
    const int buf = a % 2;
    mbar_wait(&bars.full[buf], (a / 2) & 1);
    const uint32_t gp = opaque(bufs + buf * P::kBuf) + wg * kBox;  // gᵀ's 64 rows
    const uint32_t xp = opaque(bufs + buf * P::kBuf) + P::kOperand;
    float f[64];
    wgmma_fence();
#pragma unroll
    for (int tm = kFirstTerm<kParts>; tm < 6; ++tm)
#pragma unroll
      for (int ks = 0; ks < kAtom / 16; ++ks)
        wgmma_ss_mn128(f, desc_mn(gp + split_a(tm) * P::kPart + 2048 * ks),
                       desc_mn2(xp + split_b(tm) * P::kPart + 2048 * ks, kBox),
                       tm > kFirstTerm<kParts> || ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(f);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&bars.empty[buf]);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = __fadd_rn(acc[e], f[e]);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * wg + 16 * warp + g + 8 * r;
      const int col = c0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * Fi + col) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
}

// K10's fp32 form on g (tg) and x (tx): a block a 128 x 128 dW tile
// (blockIdx.x the F_in tile, .y the F_out tile) over split blockIdx.z of
// N. Writes the split's dW partial (dw + split·Fo·Fi) and, from the first
// F_in column, its db partial (db + split·Fo).
template <int kParts>
__global__ void __launch_bounds__(kThreads, 1)
fc_grad_split_kernel(const __grid_constant__ CUtensorMap tg,
                     const __grid_constant__ CUtensorMap tx,
                     float* __restrict__ dw, float* __restrict__ db, int N,
                     int Fo, int Fi, int rows_per_split) {
  uint8_t* sm = &aligned_smem<uint8_t>();
  Bars& bars = *reinterpret_cast<Bars*>(sm + Plan<kParts>::kBars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kF32Stages; ++s) mbar_init(&bars.f32[s], 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&bars.full[b], kConverters);
      mbar_init(&bars.empty[b], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int c0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int n_begin = blockIdx.z * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  const int atoms = n_end > n_begin ? (n_end - n_begin + kAtom - 1) / kAtom : 0;
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<88>();
    convert<kParts>(sm, bars, &tg, &tx, m0, c0, n_begin, atoms, blockIdx.x == 0,
                    db + static_cast<size_t>(blockIdx.z) * Fo);
  } else {
    setmaxnreg_inc<168>();
    consume<kParts>(sm, bars, dw + static_cast<size_t>(blockIdx.z) * Fo * Fi, Fi,
                    m0, c0, atoms);
  }
}

}  // namespace split

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

// The fp32 form: g (N, Fo), x (N, Fi) fp32, contiguous, 16-byte aligned;
// the rest as for fc_grad, rows_per_split a multiple of 32. Returns
// cudaGetLastError() after the launches or the error of building a tensor
// map.
extern "C" int fc_grad_f32(const void* g, const void* x, void* dw, void* db,
                           void* part, void* part_db, int N, int Fo, int Fi,
                           int splits, void* stream) {
  if (Fo % kTile || Fi % kTile || Fo <= 0 || Fi <= 0 || splits < 1 ||
      (splits > 1 && (part == nullptr || part_db == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  using P = split::Plan<3>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tg, tx;
  int e = hopper::matrix_map(&tg, g, N, Fo, 4, split::kAtom);
  if (!e) e = hopper::matrix_map(&tx, x, N, Fi, 4, split::kAtom);
  if (!e)
    e = static_cast<int>(cudaFuncSetAttribute(
        split::fc_grad_split_kernel<3>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes));
  if (e) return e;
  const int atoms = (N + split::kAtom - 1) / split::kAtom;
  const int rows_per_split = ((atoms + splits - 1) / splits) * split::kAtom;
  float* dw_out = splits > 1 ? static_cast<float*>(part) : static_cast<float*>(dw);
  float* db_out = splits > 1 ? static_cast<float*>(part_db) : static_cast<float*>(db);
  split::fc_grad_split_kernel<3>
      <<<dim3(Fi / kTile, Fo / kTile, splits), split::kThreads, P::kBytes, st>>>(
          tg, tx, dw_out, db_out, N, Fo, Fi, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  e = sum_splits(static_cast<const float*>(part), static_cast<float*>(dw),
                 static_cast<long long>(Fo) * Fi, splits, st);
  if (e) return e;
  return sum_splits(static_cast<const float*>(part_db), static_cast<float*>(db),
                    Fo, splits, st);
}

// K10's fp32 form's dynamic shared memory, bytes (for the build report).
extern "C" int fc_grad_f32_smem() { return split::Plan<3>::kBytes; }
