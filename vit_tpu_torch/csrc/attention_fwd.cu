// K6, unpacked attention forward, and K1, its packed form, for Hopper
// (sm_90a).
//
// K6 replaces the Pallas kernel vit_tpu/kernels/attention.py:_fa_kernel
// (:76), launched by _flash_attention_fwd_impl (:172) behind flash_attention
// (:1294). K1 (kBias, the entry attention_packed_fwd) replaces
// _fa_packed_kernel (:623), launched by _packed_fwd_impl (:790) behind
// flash_attention_packed (:1269). Same math: o = softmax(mask(q kᵀ / √d)) v
// over q, k, v of (B, H, S, d) bf16, d 64 (every preset's heads) or 32 (the
// MAE decoder's 16 heads × 512). Scores are q·kᵀ in fp32 times 1/√d: at d 64
// 1/8, exact (a power of two: the same values as the products of bf16 q/8);
// at d 32 fp32(1/√32), the fp32 product rounded, as the Pallas kernel
// multiplies when the scale is no power of two (:680-690). The row max m
// and the row sum l are fp32; p = exp(s - m) is
// rounded to bf16 UNNORMALISED for the PV product, which accumulates in
// fp32, and the result is divided by l and rounded to bf16 once
// (:110-137). exp is the MUFU's ex2 of (s - m)·log2(e) formed in one FMA
// (hopper.cuh:exp2_approx: a few 1e-6 relative from expf). The causal mask
// compares global rows and columns (col <= row) and key padding is col < S,
// as the Pallas kernel's (:110-116) with its q-block offset.
//
// Each of q, k, v and the output is addressed through its own (batch, head,
// row) strides in elements, with unit stride along head_dim, so the head
// views of a packed (B, S, 3·H·64) projection and an output laid out
// (B, S, H, 64) need no copies: q, k and v are read through 4-D TMA tensor
// maps (64, S, H, B) at those strides, which fill rows past S with zeros.
// With m_out/l_out non-null it also writes m and l, fp32, as two contiguous
// (B, H, S) arrays: the residuals the backward (attention_bwd.cu) rebuilds p
// from, where the TPU's K7/K8 recompute them.
//
// K1 reads the UNBIASED packed projection qkv_nb (B, S, 3D), columns
// (three h d), through the same maps: q, k and v are its head views at
// strides (S·3D, 64, 3D) from column offsets 0, D and 2D, and the output
// (B, S, D) is a strided out. The (3D,) bias is added in bf16 as the Pallas
// kernel adds it (:670-676), bf16(x + b), in shared memory: when a q, k or
// v tile's load completes, the consumers rewrite it in place
// (attention_tile.cuh:add_head_bias), fence the writes to the async proxy and meet
// at a named barrier before any wgmma reads it. Rows past S stay TMA's
// zeros. A K or V stage is shared by both warpgroups, so all 256 consumers
// bias it together; each warpgroup biases its own q rows. The Pallas
// kernel's bf16(bf16(x + b)·1/8) equals the fp32 accumulator's 1/8 below
// (a power of two). A copy of qkv with the bias added would be another
// B·S·3D round trip, which the fused bias avoids. On the H100 K1 takes
// 12-21% longer than K6 on a biased copy's views, mostly for the barrier
// a tile; biasing the ring's tiles in the producer warp instead, ahead of
// the products, took 1.5-1.6x K6's time (one warp's 32 lanes fall behind).
//
// Dropout (kDropout, with a seed vector), as :118-137 and :699-715: p is
// multiplied by the mask D of csrc/dropout.cuh after l has summed it and
// before its bf16 cast (row the global query, column the global key, stride
// S, stream b·H + h + offset); the saved (m, l) are the unmasked ones.
//
// Head widths (kD, csrc/attention_tile.cuh): a 64-wide head's tiles have
// 128-byte rows under the 128-byte swizzle; a 32-wide head's have 64-byte
// rows under TMA's 64-byte swizzle, read by descriptors of that layout.
// Q·Kᵀ takes kD/16 k16 steps, P·V is m64nkDk16 (m64n32k16 at 32, kD/2
// accumulator registers), and the fp32 form's part arrays are 3·kD wide.
// The dropout stream stays the global b·H + h at either width (the Pallas
// kernel's (pid_b·bb + bi)·n_heads + h2·hb + j, hb = 128/d heads a lane
// block).
//
// Design (csrc/hopper.cuh has the primitives). One block per (128-row q
// tile, head, batch): two consumer warpgroups of 64 q rows each and one
// producer warp. The producer loads the q tile once and streams 64-key
// tiles through a ring of kStages shared-memory stages by TMA, each stage
// signalled full by the transaction count of an mbarrier and handed back
// empty by one arrival from each consumer warp. Two passes over the keys:
// the first loads k alone and takes the exact row max, so that p is
// rounded to bf16 against the row max where the Pallas kernel rounds it;
// the second loads k and v, forms p, sums l and accumulates P·V. Products
// are wgmma m64n64k16: s = Q·Kᵀ with both operands K-major in shared
// memory, o += P·V with P packed from the score accumulator straight into
// A-operand registers and V read MN-major through the transpose bit, so no
// transposed copy of any tile exists. Masks are compared only on the
// diagonal tile and the ragged last tile. Under the causal mask a q tile
// stops at its own last key (a warpgroup skips its wholly masked tile),
// and the q tiles are launched heaviest first so that the last wave holds
// the light ones. Two blocks share an SM (at most 112 registers a thread,
// 2 x 84 KB of shared memory), so that one block's loads and waits overlap
// the other's products: on the H100 that beat one block with the next
// tile's scores issued ahead (wgmma in flight during the softmax).
//
// What bounds it: per (batch, head) the three products (q·kᵀ twice, P·V)
// cost 6·S²·64 FLOP, halved under the causal mask, against 4·S·64·2 bytes
// of q, k, v and output: far above the H100's bf16 ridge (≈ 295 FLOP per
// byte) at S = 1024, so the tensor cores, the MUFU's exp (16 a clock per
// SM) and the latency of the products' chains bound it.
//
// The fp32 form (kParts = 3, the entry attention_f32_fwd) replaces the same
// two Pallas kernels on fp32 operands, where they take every product at
// Precision.HIGHEST (:95, :646), for K1 and K6 alike. The TPU's HIGHEST is
// six bf16 passes; so is this form, as the fp32 backward's
// (attention_bwd.cu): attention_bwd.cu's split_parts_kernel writes q, k
// and v (the packed layout's bias added in fp32) as three bf16 parts
// x = x0 + x1 + x2 each, exactly, into (B, H, S, 3·64) arrays that TMA
// reads as ordinary 64-wide swizzled tiles (a 192-wide tensor map, part p
// at column 64p), and s = Q·Kᵀ and P·V are each the six wgmma products
// A_i·B_j, i + j <= 2, small terms first (attention_tile.cuh:head_abt,
// head_rb). Its math is the plain fp32 version's, with no bf16 cast:
// m exact over s/8, p = expf(s/8 − m) (the expression the fp32 backward
// rebuilds p with), l = Σ p, p split into three bf16 A fragments in
// registers after the dropout mask (hopper.cuh:put_a), o = Σ (D∘p)·v
// divided by l once, in fp32, and stored in fp32. Three rounding points
// are kept as the plain version keeps them:
//   - both passes take s with the same code from the same bytes, so pass
//     2's scores are pass 1's to the bit and no p exceeds 1;
//   - each key tile's P·V is taken in a fresh accumulator and added to o in
//     registers, rounded to nearest (attention_tile.cuh:head_rb_into): summed
//     over all tiles in one wgmma accumulator, the fp32 backward's means
//     stood several times higher and grew with the tiles summed;
//   - p is never rounded to bf16: its three parts carry it whole.
// Three-part tiles take three times the shared memory: the q tile alone is
// 48 KB and a K + V ring stage 48 KB, so this form runs one block an SM
// with a three-stage ring (198,656 bytes), and its consumer thread holds o,
// the tile's accumulator, s and P's parts (32 + 32 + 32 + 48 registers):
// ptxas gives it the 168 registers that nine warps allow and spills 56-60
// bytes (H100, CUDA 12.8). Its products cost six times the bf16 form's:
// 36·S²·64 FLOP per (batch, head) at 989 TFLOP/s, halved under the causal
// mask; one block an SM waits on each product, so on the H100 it runs at a
// quarter of that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"
#include "dropout.cuh"
#include "hopper.cuh"

namespace {

using namespace vit;
using namespace vit::hopper;
using namespace vit::attn;

constexpr int kBlockQ = 128;  // q rows per block: two warpgroups of 64
constexpr int kKeys = 64;     // keys per ring stage
constexpr int kConsumers = 256;
constexpr int kBlockThreads = kConsumers + 32;  // + the producer warp

// kParts = 1: bf16 operands, four ring stages, two blocks an SM, a bf16
// output; 3: fp32 operands as three bf16 parts, three stages, one block an
// SM, an fp32 output. The same at both head widths: at kD 32 the bf16
// block's 40 KB of tiles would let more blocks share an SM, but its
// registers (s, o and P: 32 + 16 + 16 a thread) hold it to two.
template <int kParts>
constexpr int kStagesOf = kParts == 1 ? 4 : 3;
template <int kParts>
constexpr int kBlocksPerSm = kParts == 1 ? 2 : 1;
template <int kParts>
using OutT = std::conditional_t<kParts == 1, bf16, float>;

template <int kParts, int kD>
struct alignas(1024) FwdSmem {
  static constexpr int kStages = kStagesOf<kParts>;
  bf16 q[kParts][kBlockQ * kD];
  bf16 k[kStages][kParts][kKeys * kD];
  bf16 v[kStages][kParts][kKeys * kD];
  Ring<kStages> ring;
  uint64_t q_full;
  alignas(16) bf16 bias[3][kD];  // kBias: this head's q, k and v bias
};

// -inf where a score of one warpgroup's 64 rows and one 64-key tile
// starting at k0 is masked (called on the diagonal and ragged tiles only).
__device__ __forceinline__ void mask_edge(float (&s)[32], int k0, int row0,
                                          int S, int causal, int t) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int col = k0 + (e / 4) * 8 + 2 * t + (e & 1);
    const int row = row0 + ((e / 2) & 1) * 8;
    if (col >= S || (causal && col > row)) s[e] = -INFINITY;
  }
}

// What a block works on: a 128-row q tile of head (b, h), and n_kv key
// tiles. Loads 0 .. n_kv - 1 bring the k tiles of pass 1, loads n_kv ..
// 2·n_kv - 1 the k and v tiles of pass 2. Each tile comes in kParts parts,
// part p at column kD·p of its tensor map.
struct Work {
  int q0, h, b, n_kv;
};

template <int kParts, int kD>
__device__ __forceinline__ void produce(FwdSmem<kParts, kD>& sm,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, Work w) {
  constexpr uint32_t kTile = Head<kD>::kTileBytes;
  auto& ring = sm.ring;
  mbar_arrive_expect_tx(&sm.q_full, 2 * kParts * kTile);
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    tma_load_4d(sm.q[p], tq, &sm.q_full, kD * p, w.q0, w.h, w.b);
    tma_load_4d(sm.q[p] + kKeys * kD, tq, &sm.q_full, kD * p, w.q0 + kKeys,
                w.h, w.b);
  }
  for (int i = 0; i < 2 * w.n_kv; ++i) {
    const int st = ring.stage(i), k0 = (i % w.n_kv) * kKeys;
    const bool pass2 = i >= w.n_kv;
    ring.wait_empty(i);
    mbar_arrive_expect_tx(&ring.full[st], (pass2 + 1) * kParts * kTile);
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      tma_load_4d(sm.k[st][p], tk, &ring.full[st], kD * p, k0, w.h, w.b);
    if (pass2) {
#pragma unroll
      for (int p = 0; p < kParts; ++p)
        tma_load_4d(sm.v[st][p], tv, &ring.full[st], kD * p, k0, w.h, w.b);
    }
  }
}

template <bool kDropout, bool kBias, int kParts, int kD>
__device__ __forceinline__ void consume(FwdSmem<kParts, kD>& sm, Work w,
                                        OutT<kParts>* out, Strides so,
                                        float* m_out, float* l_out,
                                        Dropout drop, int S, int H,
                                        int causal) {
  static_assert(kParts == 1 || !kBias, "the fp32 form's parts carry the bias");
  using Hd = Head<kD>;
  constexpr uint32_t kTile = Hd::kTileBytes;
  constexpr uint32_t kStageBytes = kParts * kTile;
  constexpr uint32_t kQPartBytes = kBlockQ * Hd::kRowBytes;
  auto& ring = sm.ring;
  const int n_kv = w.n_kv;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = w.q0 + wg * 64;          // this warpgroup's first row
  const int row0 = r0 + warp * 16 + g;    // this thread's rows: row0, row0 + 8
  // Key tiles past this warpgroup's diagonal are wholly masked.
  const int my_kv = causal ? min(n_kv, r0 / kKeys + 1) : n_kv;
  const uint32_t q_tile = smem_u32(sm.q[0] + wg * 64 * kD);
  const uint32_t k_base = smem_u32(sm.k[0][0]);
  const uint32_t v_base = smem_u32(sm.v[0][0]);
  // Scores are taken as q·kᵀ unscaled: the scale is applied inside the max
  // (monotone) and the exponent. Masks are compared on the diagonal and the
  // ragged last tile only. Both passes call this, so their scores are the
  // same bits. The fp32 form zeroes s first, so that the last tile's scores
  // are dead (the wgmma asm reads its accumulator) while P·V holds its
  // parts and the tile's accumulator.
  float s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.0f;
  auto scores = [&](int i, int k0) {
    if constexpr (kParts > 1) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.0f;
    }
    wgmma_fence();
    head_abt<kD, kParts>(s, q_tile, kQPartBytes,
                        k_base + ring.stage(i) * kStageBytes, kTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if ((causal && k0 == r0) || k0 + kKeys > S)
      mask_edge(s, k0, row0, S, causal, t);
  };
  // kBias: the K (and in pass 2 the V) tile of load i, biased by all 256
  // consumers before either warpgroup's products read it.
  auto bias_kv = [&](int i, int k0, bool with_v) {
    add_head_bias<kConsumers, kD>(sm.k[ring.stage(i)][0], sm.bias[1],
                                  S - k0, threadIdx.x);
    if (with_v)
      add_head_bias<kConsumers, kD>(sm.v[ring.stage(i)][0], sm.bias[2],
                                    S - k0, threadIdx.x);
    fence_proxy_async();
    named_barrier(3, kConsumers);
  };
  mbar_wait(&sm.q_full, 0);
  if constexpr (kBias) {
    add_head_bias<128, kD>(sm.q[0] + wg * 64 * kD, sm.bias[0], S - r0,
                           threadIdx.x % 128);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
  }

  // Pass 1: the exact row max over every unmasked key.
  float m[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < n_kv; ++j) {
    ring.wait_full(j);
    if constexpr (kBias) bias_kv(j, j * kKeys, false);
    if (j < my_kv) {
      scores(j, j * kKeys);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        m[(e / 2) & 1] = fmaxf(m[(e / 2) & 1], s[e]);
    }
    ring.release(j);
  }
  // A row is spread over the 4 threads of a group. Column 0 is valid for
  // every row, so m is finite and no exp below sees (-inf) - (-inf). The
  // scaled max is the max of the scaled scores (rounding is monotone).
  float ml[2];  // the shift inside the exponent: m·log2(e), or m (fp32)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    m[r] = __fmul_rn(m[r], Hd::kScale);
    ml[r] = kParts == 1 ? m[r] * kLog2e : m[r];
  }

  // Pass 2: p = exp(s - m) in fp32, summed unrounded into l, and P
  // (unnormalised, after the dropout mask; bf16, or its three bf16 parts)
  // times V accumulated in fp32.
  DropoutStream drs{};
  if constexpr (kDropout) drs = dropout_stream(drop, w.b * H + w.h);
  float o[Hd::kAcc];
#pragma unroll
  for (int e = 0; e < Hd::kAcc; ++e) o[e] = 0.0f;
  float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums
  for (int j = 0; j < n_kv; ++j) {
    const int i = n_kv + j;
    ring.wait_full(i);
    if constexpr (kBias) bias_kv(i, j * kKeys, true);
    if (j < my_kv) {
      const int k0 = j * kKeys;
      scores(i, k0);
      // P in the A-operand layout: key step ks covers score tiles 2ks and
      // 2ks + 1.
      uint32_t pf[kParts][4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float p[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if constexpr (kParts == 1)
            p[c] = exp2_approx(exp2_arg<kD>(s[4 * nt + c], ml[c >> 1]));
          else
            p[c] = exp_f32<kD>(s[4 * nt + c], ml[c >> 1]);
        }
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
        if constexpr (kDropout) {
          const int col = k0 + nt * 8 + 2 * t;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            p[c] *= dropout_at(drs, row0 + (c >> 1) * 8, col + (c & 1), S,
                               causal);
        }
        put_a<kParts>(pf, nt / 2, (nt % 2) * 2 + 0, p[0], p[1]);
        put_a<kParts>(pf, nt / 2, (nt % 2) * 2 + 1, p[2], p[3]);
      }
      wgmma_fence();
      head_rb_into<kD, kParts, 4>(
          o, pf, v_base + ring.stage(i) * kStageBytes, kTile);
      fence_regs(pf);
    }
    ring.release(i);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  OutT<kParts>* ob = out + offset(so, w.b, w.h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= S) continue;
    OutT<kParts>* orow = ob + static_cast<size_t>(row) * so.s;
#pragma unroll
    for (int nt = 0; nt < Hd::kNt; ++nt) {
      const float lo = o[4 * nt + 2 * r] / l[r];
      const float hi = o[4 * nt + 2 * r + 1] / l[r];
      if constexpr (kParts == 1)
        *reinterpret_cast<uint32_t*>(orow + nt * 8 + 2 * t) =
            pack_bf16x2(lo, hi);
      else
        *reinterpret_cast<float2*>(orow + nt * 8 + 2 * t) =
            make_float2(lo, hi);
    }
    if (m_out != nullptr && t == 0) {
      const size_t i = (static_cast<size_t>(w.b) * H + w.h) * S + row;
      m_out[i] = m[r];
      l_out[i] = l[r];
    }
  }
}

template <bool kDropout, bool kBias, int kParts, int kD>
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSm<kParts>)
attention_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const bf16* __restrict__ bias,
                     OutT<kParts>* __restrict__ out, Strides so,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     Dropout drop, int S, int H, int causal) {
  auto& sm = aligned_smem<FwdSmem<kParts, kD>>();
  Work w;
  w.q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kBlockQ;
  w.h = blockIdx.y;
  w.b = blockIdx.z;
  w.n_kv = ((causal ? min(S, w.q0 + kBlockQ) : S) + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    sm.ring.init(1, kConsumers / 32);
    mbar_init_fence();
  }
  if constexpr (kBias) load_head_bias<kD>(sm.bias, bias, w.h, H);
  __syncthreads();
  if (threadIdx.x >= kConsumers) {  // the producer warp: one thread
    if (threadIdx.x == kConsumers) produce(sm, &tq, &tk, &tv, w);
  } else {
    consume<kDropout, kBias, kParts, kD>(sm, w, out, so, m_out, l_out, drop,
                                         S, H, causal);
  }
}

template <int kParts, int kD>
constexpr int kSmemBytes =
    static_cast<int>(sizeof(FwdSmem<kParts, kD>)) + 1024;

// The tensor maps and the launch of attention_fwd_kernel<kDropout, kBias,
// kParts, kD>: K6 with bias null, K1 with its (3·H·kD,) bf16 bias; q, k, v
// bf16 (kParts 1, width kD) or part arrays (kParts 3, width 3·kD, no bias)
// at strides[0..8], out OutT<kParts> at strides[9..11].
template <int kParts, int kD>
int launch(const void* q, const void* k, const void* v, int width,
           const bf16* bias, void* out, void* m, void* l, const void* seed,
           const long long* strides, int B, int S, int H, int causal,
           unsigned int threshold, float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  CUtensorMap tq, tk, tv;
  int err = head_map(&tq, q, strides + 0, B, H, S, width, kD);
  if (!err) err = head_map(&tk, k, strides + 3, B, H, S, width, kD);
  if (!err) err = head_map(&tv, v, strides + 6, B, H, S, width, kD);
  if (err) return err;
  const Strides so{strides[9], strides[10], strides[11]};
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  const Dropout drop{static_cast<const int*>(seed), threshold, scale};
  using Kernel = decltype(&attention_fwd_kernel<false, false, kParts, kD>);
  Kernel kernel;
  if constexpr (kParts == 1) {
    const Kernel kernels[2][2] = {
        {&attention_fwd_kernel<false, false, 1, kD>,
         &attention_fwd_kernel<false, true, 1, kD>},
        {&attention_fwd_kernel<true, false, 1, kD>,
         &attention_fwd_kernel<true, true, 1, kD>}};
    kernel = kernels[seed != nullptr][bias != nullptr];
  } else {
    kernel = seed != nullptr ? &attention_fwd_kernel<true, false, kParts, kD>
                             : &attention_fwd_kernel<false, false, kParts, kD>;
  }
  constexpr int kSmem = kSmemBytes<kParts, kD>;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem));
  if (err) return err;
  kernel<<<grid, kBlockThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, bias, static_cast<OutT<kParts>*>(out), so,
      static_cast<float*>(m), static_cast<float*>(l), drop, S, H, causal);
  return static_cast<int>(cudaGetLastError());
}

// launch<kParts, kD> at a head width d the caller gives: 32 or 64, else
// cudaErrorInvalidValue (the Python wrappers refuse other widths first).
template <int kParts, typename... Args>
int launch_d(int d, Args... args) {
  if (d == 64) return launch<kParts, 64>(args...);
  if (d == 32) return launch<kParts, 32>(args...);
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of the K6 and K1 kernels at head width d, bf16
// (fp32 0) or the fp32 form (fp32 1), bytes (for the build report).
extern "C" int attention_fwd_smem(int fp32, int d) {
  if (d == 32) return fp32 ? kSmemBytes<3, 32> : kSmemBytes<1, 32>;
  return fp32 ? kSmemBytes<3, 64> : kSmemBytes<1, 64>;
}

// q, k, v, out: (B, H, S, d) bf16, d 32 or 64, at the element strides
// strides[0..2] (q), [3..5] (k), [6..8] (v), [9..11] (out), each (batch,
// head, row), multiples of 8 with 16-byte aligned bases; m, l: (B, H, S)
// fp32, contiguous, or both null for no stats; seed: (2,) int32 [seed,
// offset] on the device for dropout with `threshold` and `scale`
// (csrc/dropout.cuh), or null for none. Returns cudaGetLastError() after the
// launch, or the error of building a tensor map.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* out, void* m, void* l, const void* seed,
                             const long long* strides, int B, int S, int H,
                             int d, int causal, unsigned int threshold,
                             float scale, void* stream) {
  return launch_d<1>(d, q, k, v, d, static_cast<const bf16*>(nullptr), out, m,
                     l, seed, strides, B, S, H, causal, threshold, scale,
                     stream);
}

// K1. qkv: (B, S, 3·H·d) bf16, contiguous, 16-byte aligned; bias: (3·H·d,)
// bf16, 16-byte aligned; out: (B, S, H·d) bf16, contiguous; m, l, seed,
// threshold and scale as attention_fwd's. Returns as attention_fwd.
extern "C" int attention_packed_fwd(const void* qkv, const void* bias,
                                    void* out, void* m, void* l,
                                    const void* seed, int B, int S, int H,
                                    int d, int causal, unsigned int threshold,
                                    float scale, void* stream) {
  const long long D = static_cast<long long>(H) * d;
  // (batch, head, row) strides of q, k, v (the packed (B, S, 3D)) and out
  // (B, S, D)
  const long long packed[3] = {S * 3 * D, d, 3 * D}, rows[3] = {S * D, d, D};
  long long strides[12];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j)
      strides[3 * i + j] = i == 3 ? rows[j] : packed[j];
  const bf16* x = static_cast<const bf16*>(qkv);
  return launch_d<1>(d, static_cast<const void*>(x),
                     static_cast<const void*>(x + D),
                     static_cast<const void*>(x + 2 * D), d,
                     static_cast<const bf16*>(bias), out, m, l, seed,
                     static_cast<const long long*>(strides), B, S, H, causal,
                     threshold, scale, stream);
}

// The fp32 form (K1, K6 on fp32 operands). parts: (3, B, H, S, 3, d) bf16,
// contiguous, the three bf16 parts of q, k and v (the packed layout's bias
// added) as attention_f32_split writes them; out: (B, H, S, d) fp32 at the
// element strides out_strides[0..2] (batch, head, row), multiples of 2; m,
// l, seed, threshold and scale as attention_fwd's. Returns as
// attention_fwd.
extern "C" int attention_f32_fwd(const void* parts, void* out, void* m,
                                 void* l, const void* seed,
                                 const long long* out_strides, int B, int S,
                                 int H, int d, int causal,
                                 unsigned int threshold, float scale,
                                 void* stream) {
  // The part arrays' (batch, head, row) strides, then the output's own
  const long long width = 3LL * d;
  const long long split[3] = {static_cast<long long>(H) * S * width,
                              static_cast<long long>(S) * width, width};
  long long strides[12];
  for (int i = 0; i < 12; ++i)
    strides[i] = i < 9 ? split[i % 3] : out_strides[i - 9];
  const size_t n = static_cast<size_t>(B) * H * S * width;
  const bf16* x = static_cast<const bf16*>(parts);
  return launch_d<3>(d, static_cast<const void*>(x),
                     static_cast<const void*>(x + n),
                     static_cast<const void*>(x + 2 * n),
                     static_cast<int>(width),
                     static_cast<const bf16*>(nullptr), out, m, l, seed,
                     static_cast<const long long*>(strides), B, S, H, causal,
                     threshold, scale, stream);
}
