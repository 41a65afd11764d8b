// K7/K8, unpacked attention backward, and K2, its packed form, for Hopper
// (sm_90a), on bf16 operands and, through fp32-accurate split products, on
// fp32 operands.
//
// K7/K8 replaces both Pallas backward kernels of the unpacked attention:
// vit_tpu/kernels/attention.py:_fa_bwd_kernel (:201, K7, launched by
// _flash_attention_bwd_impl :441 for S <= 768) and _fa_bwd_tiled_kernel
// (:284, K8, launched by _flash_attention_bwd_tiled_impl :395 for S > 768,
// VideoGPT's S = 1024). The TPU splits them at 768 only because one
// program's (S, S) planes must fit VMEM; here one pair of kernels over
// tiles takes every S. Inputs: q, k, v and the upstream gradient dO, each
// (B, H, S, 64) bf16 at its own (batch, head, row) element strides, read
// through 4-D TMA tensor maps (rows past S arrive as zeros), and K6's row
// statistics m and l, fp32 (B, H, S) contiguous. Outputs dq, dk, dv,
// (B, H, S, 64) bf16 at their own strides.
//
// The math of :244-277 (and :325-357), with p rebuilt from K6's saved
// statistics instead of recomputed:
//   ph = exp(s - m) unnormalised, linv = 1/l, s = q·kᵀ/8 masked;
//   dv = bf16(ph)ᵀ · bf16(dO·linv);   dp = dO · vᵀ;   Δ = Σ_keys ph·dp;
//   ds = bf16(ph · ((dp - Δ·linv) · (linv/8)));
//   dq = ds · k,  dk = dsᵀ · q  (the unscaled q).
// Products are bf16 in, fp32 accumulate; ph, dp, Δ and ds stay fp32 until
// ds's cast, ds keeps the Pallas kernel's operation order with no FMA
// contraction, ph·((dp − Δ·linv)·(linv/8)) (its row products Δ·linv and
// linv/8 taken once per row), and each output is cast to bf16 once, as on
// the TPU (whose K8 sums fp32 per-q-block dk/dv partials in XLA before the
// cast, :416-418). s = q·kᵀ/8 in fp32 equals the products of bf16 q/8
// exactly; exp is K6's (hopper.cuh:exp2_approx of the log2(e)-scaled
// argument), so ph is the forward's p.
//
// K2 (kBias, the entry attention_packed_bwd) replaces _fa_packed_bwd_kernel
// (:824), launched by _packed_bwd_impl (:1072), with the same math (:888-952)
// over the UNBIASED packed projection qkv_nb (B, S, 3D) and its (3D,) bias:
// q, k and v are qkv_nb's head views (strides (S·3D, 64, 3D), column
// offsets 0, D, 2D), dO is (B, S, D), and dq, dk, dv are the strided views
// of dqkv (B, S, 3D). The bias is added in shared memory as K1 adds it
// (attention_fwd.cu, attention_tile.cuh:add_head_bias): every q, k and v tile is
// rewritten bf16(x + b) when its load completes, fenced to the async proxy
// and passed through a named barrier before a wgmma reads it (rows past S
// stay zero). K2 also returns the bias gradient (:986-1011, :1091): the
// fp32 column sums of dq, dk and dv before their bf16 cast. Each block sums
// its 128 rows (over a thread's two rows, the 8 row groups of a warp by
// shuffles, then the 8 consumer warps in order in shared memory) into its
// row of a partial array (B·⌈S/128⌉, 3D), and column_total_kernel adds the
// rows in order, so the gradient is the same from run to run.
//
// Dropout (kDropout, with the forward's seed vector), as :916-942: each pass
// hashes the mask D of csrc/dropout.cuh again (:251-274, :329-352); dp is
// multiplied by D before Δ and ds take it, dv takes bf16(D·ph), and the
// dk/dv kernel hashes the forward's (query, key) pair in its transposed tile.
//
// Blocks run in parallel with no carried state, while dq sums over keys and
// dk, dv over queries. So two kernels accumulate their outputs in registers,
// with no atomics and no partials, and the result is the same run to run:
//   1. dq kernel, one block per (128-row q tile, head, batch): Q and dO are
//      loaded once, K and V stream through the ring. Pass 1 computes
//      s = Q·Kᵀ and dp = dO·Vᵀ, both B operands K-major, sums Δ for its rows
//      and stores it, fp32 (B, H, S); pass 2 rebuilds ds into A-operand
//      registers and accumulates dq += dS·K with K read MN-major.
//   2. dk/dv kernel, one block per (128-key tile, head, batch), the
//      K/V-outer loop: K and V stay in shared memory as A operands, and the
//      q tiles stream through the ring with their row constants (m·log2(e),
//      1/l, Δ/l, 1/(8l)), which the producer warp reads ahead and writes
//      beside each tile. Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ leave phᵀ and dsᵀ in the
//      A-operand layout; each consumer warpgroup writes dol = bf16(dO·linv)
//      once per q tile into a buffer swizzled as TMA swizzles, and
//      dv += bf16(D·ph)ᵀ·dol, dk += dSᵀ·Q read dol and Q MN-major. No
//      transposed copy of any tile exists.
// Each block is two consumer warpgroups of 64 rows and one producer warp
// that keeps TMA loads in flight through a ring of stages, as K6's
// (attention_fwd.cu). Under the causal mask the dq kernel stops at its q
// tile's last key and the dk/dv kernel starts at its own key tile, wholly
// masked tiles are skipped and both kernels launch their heaviest tiles
// first. The elementwise work between the products is what the time goes
// to (a clock64 breakdown on the H100: ~55% of the dk/dv kernel, the
// products ~15%), so it is specialised: the masks are compared only on
// diagonal and ragged tiles (a second instantiation of each loop), and the
// row constants are read once per tile.
//
// K2's shapes are short (S 197-320): a block walks only 4-5 key or query
// tiles a pass, and the last 128-row tile is ragged.
//
// The fp32 form (kParts = 3, the entry attention_f32_bwd) replaces the same
// three Pallas kernels on fp32 operands, where they take every product at
// Precision.HIGHEST (:228, :310, :851), for K2, K7 and K8 alike (the packed
// layout passes its bias, the head views none). The TPU's HIGHEST is six
// bf16 passes; so is this form: split_parts_kernel writes each fp32 operand
// x (q, k and v with the bias added in fp32, and dO) as three bf16 parts
// x = x0 + x1 + x2, exactly, into (B, H, S, 3·64) arrays that TMA reads as
// ordinary 64-wide swizzled tiles (a 192-wide tensor map, part p at column
// 64p), and every product A·B is the six wgmma products A_i·B_j, i + j <= 2,
// into one fp32 accumulator (attention_tile.cuh:head_abt, head_rb), ds and
// D∘ph split into three bf16 A fragments in registers (hopper.cuh:put_a);
// each tile's dq, dk or dv product is taken in a fresh accumulator and added
// to the running sum in registers (attention_tile.cuh:head_rb_into).
// The math is the plain fp32 version's (kernels/attention.py:
// _attention_bwd_f32 at fp32: no bf16 cast anywhere): ph = expf(s/8 - m),
// Δ = Σ ph·dp (the same rounding point), ds in the same order, outputs
// stored in fp32. One product differs in where it rounds, not in what it
// sums: dv takes 1/l in its A operand, (D∘ph/l)ᵀ·dO, instead of dO/l in a
// dol tile, since three parts of a dol buffer (24 KB a warpgroup) do not fit
// beside K, V and a two-stage ring of three-part tiles (96 + 96 KB). The
// dk/dv kernel takes a q tile in two halves of 32 queries (wgmma m64n32 for
// sᵀ and dpᵀ, then 2 k16 steps of dv and of dk), forms dv's A parts, waits
// for that product, then forms dsᵀ's in the same registers: a consumer
// thread then holds dk, dv, a half's sᵀ and dpᵀ and one A operand's parts,
// about 120 registers, under the 168 that nine warps allow (a whole tile at
// once spilled, and ptxas serialised its wgmmas).
//
// Head widths: as the forward's (attention_fwd.cu, csrc/attention_tile.cuh),
// every kernel here is templated on kD, 64 or 32: 32-wide tiles take TMA's
// 64-byte swizzle, products over the head take kD/16 k16 steps, dq, dk and
// dv are m64nkDk16 accumulators, the bias gradient's partial rows hold
// 3·H·kD columns, and the fp32 form's part arrays are 3·kD wide. The scale
// enters ds as scale·linv, fp32(1/√32) at kD 32 as in the Pallas kernel
// (:939-942).
//
// What bounds it: the minimal backward is 5 products of 2·S²·64 FLOP per
// (batch, head), halved by the causal mask; this design spends 9 (q·kᵀ and
// dO·vᵀ three times each) for the freedom from atomics, 6 bf16 products
// each in the fp32 form. At S = 1024 that is far past the bf16 ridge
// against ~8·S·64·2 bytes of q, k, v, dO, dq, dk, dv, so the tensor cores,
// the MUFU's exp (three a score) and the fp32 elementwise work between the
// products bound it.

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

constexpr int kBlockRows = 128;  // q rows (dq) or keys (dk/dv) per block
constexpr int kRows = 64;        // rows per ring stage and per warpgroup
constexpr int kConsumers = 256;
constexpr int kBlockThreads = kConsumers + 32;  // + the producer warp
// Bytes from one part of a block's 128-row tile of kD-wide rows to the next
template <int kD>
constexpr uint32_t kBlockPartBytes = kBlockRows * Head<kD>::kRowBytes;

// kParts = 1: bf16 operands; 3: fp32 operands as three bf16 parts. Four
// ring stages of bf16 tiles, two of three-part tiles, and the outputs in
// the operands' type.
template <int kParts>
constexpr int kStagesOf = kParts == 1 ? 4 : 2;
template <int kParts>
using OutT = std::conditional_t<kParts == 1, bf16, float>;

template <int kParts, int kD>
struct alignas(1024) DqSmem {
  static constexpr int kStages = kStagesOf<kParts>;
  bf16 q[kParts][kBlockRows * kD];
  bf16 dout[kParts][kBlockRows * kD];
  bf16 k[kStages][kParts][kRows * kD];
  bf16 v[kStages][kParts][kRows * kD];
  Ring<kStages> ring;
  uint64_t qd_full;
  alignas(16) bf16 bias[3][kD];  // kBias (bf16): this head's q, k, v bias
};

struct NoDol {};

template <int kParts, int kD>
struct alignas(1024) DkvSmem {
  static constexpr int kStages = kStagesOf<kParts>;
  bf16 k[kParts][kBlockRows * kD];
  bf16 v[kParts][kBlockRows * kD];
  bf16 q[kStages][kParts][kRows * kD];
  bf16 dout[kStages][kParts][kRows * kD];
  // bf16(dO·linv), two per consumer warpgroup in turn: a warp writes one
  // only after every warp of its warpgroup has passed the barrier that
  // follows the write of the other, and so has waited for the products of
  // the tile before, the last to read it. The fp32 form has none.
  std::conditional_t<kParts == 1, bf16[2][2][kRows * kD], NoDol> dol;
  // Per q row of each stage: the shift of the exponent (m·log2(e) for
  // exp2_approx, m for the fp32 form's expf), 1/l, Δ/l and 1/(8l), the
  // constants of the exponent, of dol and of ds's two row products
  alignas(16) float ml[kStages][kRows], linv[kStages][kRows];
  float d_delta[kStages][kRows], d_linv[kStages][kRows];
  Ring<kStages> ring;
  uint64_t kv_full;
  alignas(16) bf16 bias[3][kD];  // kBias (bf16): this head's q, k, v bias
};

// dq, dk, dv: OutT<kParts> arrays at their element strides
struct Outputs {
  void* dq;
  void* dk;
  void* dv;
  Strides sdq, sdk, sdv;
};

// kBias (K2): the packed (3·H·kD,) bf16 bias (read by the bf16 form; the
// fp32 form's parts carry it) and the partial column sums of the bias
// gradient, (B·⌈S/128⌉, 3·H·kD) fp32: row b·⌈S/128⌉ + (a block's first
// row) / 128. A null `part` means no bias.
struct PackedBias {
  const bf16* bias;
  float* part;
};

// The fp32 column sums of the block's 128 x kD accumulator, whose thread
// holds d[4j + 2r + c] = D[16w + g + 8r][8j + 2t + c] for consumer warp w
// (0..7), into out[0..kD): a thread's two rows, then the 8 row groups of a
// warp (shuffles), then the 8 warps in order through `red` (8 x kD floats of
// shared memory no wgmma reads any more). Every consumer thread calls it.
template <int kD>
__device__ __forceinline__ void column_sums(const float (&acc)[kD / 2],
                                            float* red, float* out) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // every warp is done with `red` (another call's) and with its wgmmas
  named_barrier(3, kConsumers);
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = acc[4 * j + c] + acc[4 * j + 2 + c];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[warp * kD + 8 * j + 2 * t + c] = v;
    }
  }
  named_barrier(3, kConsumers);
  if (threadIdx.x < kD) {
    float v = red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kConsumers / 32; ++w) v += red[w * kD + threadIdx.x];
    out[threadIdx.x] = v;
  }
}

// Rows row0 and row0 + 8 of a warpgroup's 64 x kD accumulator to `dst`
// (row r at dst + r·stride), as bf16 or fp32, skipping rows at or past S.
template <int kD, typename T>
__device__ __forceinline__ void store_acc(const float (&acc)[kD / 2], T* dst,
                                          size_t stride, int row0, int S,
                                          int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= S) continue;
    T* p = dst + static_cast<size_t>(row) * stride;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      if constexpr (std::is_same_v<T, float>)
        *reinterpret_cast<float2*>(p + nt * 8 + 2 * t) =
            make_float2(acc[4 * nt + 2 * r], acc[4 * nt + 2 * r + 1]);
      else
        *reinterpret_cast<uint32_t*>(p + nt * 8 + 2 * t) =
            pack_bf16x2(acc[4 * nt + 2 * r], acc[4 * nt + 2 * r + 1]);
    }
  }
}

// The tensor maps of q, k, v and dO.
struct Maps {
  const CUtensorMap *q, *k, *v, *dout;
};

// ---- dq kernel --------------------------------------------------------------

// A dq block: a 128-row q tile of head (b, h) and n_kv key tiles. Loads
// 0 .. n_kv - 1 bring the k and v tiles of pass 1, loads n_kv .. 2·n_kv - 1
// those of pass 2. Each tile comes in kParts parts, part p at column kD·p of
// its tensor map.
struct DqWork {
  int q0, h, b, n_kv;
};

template <int kParts, int kD>
__device__ __forceinline__ void dq_produce(DqSmem<kParts, kD>& sm, Maps t,
                                           DqWork w) {
  constexpr uint32_t kTile = Head<kD>::kTileBytes;
  auto& ring = sm.ring;
  mbar_arrive_expect_tx(&sm.qd_full, 4 * kParts * kTile);
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      tma_load_4d(sm.q[p] + i * kRows * kD, t.q, &sm.qd_full, kD * p,
                  w.q0 + i * kRows, w.h, w.b);
      tma_load_4d(sm.dout[p] + i * kRows * kD, t.dout, &sm.qd_full, kD * p,
                  w.q0 + i * kRows, w.h, w.b);
    }
  }
  for (int i = 0; i < 2 * w.n_kv; ++i) {
    const int st = ring.stage(i), k0 = (i % w.n_kv) * kRows;
    ring.wait_empty(i);
    mbar_arrive_expect_tx(&ring.full[st], 2 * kParts * kTile);
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      tma_load_4d(sm.k[st][p], t.k, &ring.full[st], kD * p, k0, w.h, w.b);
      tma_load_4d(sm.v[st][p], t.v, &ring.full[st], kD * p, k0, w.h, w.b);
    }
  }
}

template <bool kDropout, bool kBias, int kParts, int kD>
__device__ __forceinline__ void dq_consume(DqSmem<kParts, kD>& sm, DqWork w,
                                           Outputs o, PackedBias pb,
                                           const float* m_in,
                                           const float* l_in,
                                           float* delta_out, Dropout drop,
                                           int S, int H, int causal) {
  // The fp32 form's parts carry the bias already
  constexpr bool kAddBias = kBias && kParts == 1;
  using Hd = Head<kD>;
  constexpr uint32_t kTile = Hd::kTileBytes;
  constexpr uint32_t kStageBytes = kParts * kTile;
  auto& ring = sm.ring;
  const int n_kv = w.n_kv;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = w.q0 + wg * kRows;       // this warpgroup's first row
  const int row0 = r0 + warp * 16 + g;    // this thread's rows: row0, row0 + 8
  const int my_kv = causal ? min(n_kv, r0 / kRows + 1) : n_kv;
  const uint32_t q_tile = smem_u32(sm.q[0] + wg * kRows * kD);
  const uint32_t do_tile = smem_u32(sm.dout[0] + wg * kRows * kD);
  const uint32_t k_base = smem_u32(sm.k[0][0]);
  const uint32_t v_base = smem_u32(sm.v[0][0]);
  // q·kᵀ and dp = dO·Vᵀ of load i, waited for.
  auto scores = [&](float (&s)[32], float (&dp)[32], int i) {
    wgmma_fence();
    head_abt<kD, kParts>(s, q_tile, kBlockPartBytes<kD>,
                        k_base + ring.stage(i) * kStageBytes, kTile);
    head_abt<kD, kParts>(dp, do_tile, kBlockPartBytes<kD>,
                        v_base + ring.stage(i) * kStageBytes, kTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
  };
  // kBias: the K and V tiles of load i, biased by all 256 consumers before
  // either warpgroup's products read them.
  auto bias_kv = [&](int i, int k0) {
    add_head_bias<kConsumers, kD>(sm.k[ring.stage(i)][0], sm.bias[1],
                                  S - k0, threadIdx.x);
    add_head_bias<kConsumers, kD>(sm.v[ring.stage(i)][0], sm.bias[2],
                                  S - k0, threadIdx.x);
    fence_proxy_async();
    named_barrier(3, kConsumers);
  };

  // Padded rows get m = 0, l = 1: their dO is zero, so dp, Δ and ds vanish
  // there and nothing non-finite is formed. ml is the shift inside the
  // exponent: m·log2(e) for exp2_approx, m for the fp32 form's expf.
  const size_t stat0 = (static_cast<size_t>(w.b) * H + w.h) * S;
  float ml[2], linv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if constexpr (kParts == 1)
      ml[r] = (row < S ? m_in[stat0 + row] : 0.0f) * kLog2e;
    else
      ml[r] = row < S ? m_in[stat0 + row] : 0.0f;
    linv[r] = row < S ? 1.0f / l_in[stat0 + row] : 1.0f;
  }
  DropoutStream drs{};
  if constexpr (kDropout) drs = dropout_stream(drop, w.b * H + w.h);
  // Score e of a tile from k0: its column and row, whether the masks drop
  // it (only ever true on an edge tile), and ph = exp(q·kᵀ/8 - m), 0 there.
  auto col_of = [&](int k0, int e) {
    return k0 + (e / 4) * 8 + 2 * t + (e & 1);
  };
  auto row_of = [&](int e) { return row0 + ((e / 2) & 1) * 8; };
  auto masked = [&](auto edge, int k0, int e) {
    if constexpr (!decltype(edge)::value) return false;
    const int col = col_of(k0, e);
    return col >= S || (causal && col > row_of(e));
  };
  auto ph_at = [&](float acc, int e) {
    if constexpr (kParts == 1)
      return exp2_approx(exp2_arg<kD>(acc, ml[(e / 2) & 1]));
    else
      return exp_f32<kD>(acc, ml[(e / 2) & 1]);
  };

  float s[32], dp[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.0f;
  mbar_wait(&sm.qd_full, 0);
  if constexpr (kAddBias) {
    add_head_bias<128, kD>(sm.q[0] + wg * kRows * kD, sm.bias[0], S - r0,
                           threadIdx.x % 128);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
  }

  // Pass 1: Δ = Σ_keys ph·(D·dp) for this thread's two rows.
  float delta[2] = {0.0f, 0.0f};
  auto delta_tile = [&](auto edge, int k0) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if (masked(edge, k0, e)) continue;
      float dpd = dp[e];
      if constexpr (kDropout)
        dpd *= dropout_keep(drs, row_of(e), col_of(k0, e), S);
      delta[(e / 2) & 1] += ph_at(s[e], e) * dpd;
    }
  };
  for (int j = 0; j < n_kv; ++j) {
    ring.wait_full(j);
    if constexpr (kAddBias) bias_kv(j, j * kRows);
    if (j < my_kv) scores(s, dp, j);
    ring.release(j);
    if (j >= my_kv) continue;
    const int k0 = j * kRows;
    if ((causal && k0 == r0) || k0 + kRows > S)
      delta_tile(std::true_type{}, k0);
    else
      delta_tile(std::false_type{}, k0);
  }
  // ds = ph·((dp - Δ·linv)·(scale·linv)) in the TPU kernel's order, with its
  // two products of row constants taken once: dΔ = Δ·linv and dl =
  // scale·linv.
  float d_delta[2], d_linv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    const int row = row0 + r * 8;
    if (t == 0 && row < S) delta_out[stat0 + row] = delta[r];
    d_delta[r] = __fmul_rn(delta[r], linv[r]);
    d_linv[r] = __fmul_rn(Hd::kScale, linv[r]);
  }

  // Pass 2: ds straight into A-operand registers (its bf16 parts), and
  // dq += dS·K with K read MN-major.
  float dq[Hd::kAcc];
  uint32_t dsf[kParts][4][4];
#pragma unroll
  for (int e = 0; e < Hd::kAcc; ++e) dq[e] = 0.0f;
  auto ds_tile = [&](auto edge, int k0) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = 4 * nt + c, r = c >> 1;
        const bool drop_e = masked(edge, k0, e);
        const float ph = drop_e ? 0.0f : ph_at(s[e], e);
        float dpd = dp[e];
        if constexpr (kDropout)
          if (!drop_e) dpd *= dropout_keep(drs, row_of(e), col_of(k0, e), S);
        ds[c] = __fmul_rn(
            ph, __fmul_rn(__fsub_rn(dpd, d_delta[r]), d_linv[r]));
      }
      put_a<kParts>(dsf, nt / 2, (nt % 2) * 2 + 0, ds[0], ds[1]);
      put_a<kParts>(dsf, nt / 2, (nt % 2) * 2 + 1, ds[2], ds[3]);
    }
  };
  for (int j = 0; j < n_kv; ++j) {
    const int i = n_kv + j;
    ring.wait_full(i);
    if constexpr (kAddBias) bias_kv(i, j * kRows);
    if (j < my_kv) {
      const int k0 = j * kRows;
      scores(s, dp, i);
      if ((causal && k0 == r0) || k0 + kRows > S)
        ds_tile(std::true_type{}, k0);
      else
        ds_tile(std::false_type{}, k0);
      wgmma_fence();
      head_rb_into<kD, kParts, 4>(
          dq, dsf, k_base + ring.stage(i) * kStageBytes, kTile);
      fence_regs(dsf);
    }
    ring.release(i);
  }

  store_acc<kD>(dq,
                static_cast<OutT<kParts>*>(o.dq) + offset(o.sdq, w.b, w.h),
                o.sdq.s, row0, S, t);
  if constexpr (kBias) {
    const size_t row = static_cast<size_t>(w.b) * gridDim.x + w.q0 / kBlockRows;
    column_sums<kD>(dq, reinterpret_cast<float*>(sm.dout),
                    pb.part + row * 3 * H * kD + w.h * kD);
  }
}

template <bool kDropout, bool kBias, int kParts, int kD>
__global__ void __launch_bounds__(kBlockThreads, 1)
unpacked_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, Outputs o,
                       PackedBias pb, const float* __restrict__ m_in,
                       const float* __restrict__ l_in,
                       float* __restrict__ delta_out, Dropout drop, int S,
                       int H, int causal) {
  auto& sm = aligned_smem<DqSmem<kParts, kD>>();
  DqWork w;
  w.q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kBlockRows;
  w.h = blockIdx.y;
  w.b = blockIdx.z;
  w.n_kv = ((causal ? min(S, w.q0 + kBlockRows) : S) + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    mbar_init(&sm.qd_full, 1);
    sm.ring.init(1, kConsumers / 32);
    mbar_init_fence();
  }
  if constexpr (kBias && kParts == 1)
    load_head_bias<kD>(sm.bias, pb.bias, w.h, H);
  __syncthreads();
  if (threadIdx.x >= kConsumers) {  // the producer warp: one thread
    if (threadIdx.x == kConsumers) dq_produce(sm, Maps{&tq, &tk, &tv, &tdo}, w);
  } else {
    dq_consume<kDropout, kBias, kParts, kD>(sm, w, o, pb, m_in, l_in,
                                            delta_out, drop, S, H, causal);
  }
}

// ---- dk/dv kernel -----------------------------------------------------------

// A dk/dv block: a 128-key tile of head (b, h) from k0; load j brings q
// tile q_begin + j, n_loads of them.
struct DkvWork {
  int k0, h, b, q_begin, n_loads;
};

// The producer warp: lane 0 issues the loads, every lane writes the
// constants of two of the tile's rows and arrives.
template <int kParts, int kD>
__device__ __forceinline__ void dkdv_produce(DkvSmem<kParts, kD>& sm, Maps t,
                                             DkvWork w, const float* m_in,
                                             const float* l_in,
                                             const float* delta_in, int S,
                                             int H) {
  constexpr uint32_t kTile = Head<kD>::kTileBytes;
  auto& ring = sm.ring;
  const int lane = threadIdx.x % 32;
  const size_t stat0 = (static_cast<size_t>(w.b) * H + w.h) * S;
  if (lane == 0) {
    mbar_arrive_expect_tx(&sm.kv_full, 4 * kParts * kTile);
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        tma_load_4d(sm.k[p] + i * kRows * kD, t.k, &sm.kv_full, kD * p,
                    w.k0 + i * kRows, w.h, w.b);
        tma_load_4d(sm.v[p] + i * kRows * kD, t.v, &sm.kv_full, kD * p,
                    w.k0 + i * kRows, w.h, w.b);
      }
    }
  }
  // The statistics of the next q tile are read from device memory while
  // the producer waits for its stage. Padded rows get m = 0, l = 1, Δ = 0.
  float m[2], l[2], delta[2];
  auto fetch = [&](int j) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = (w.q_begin + j) * kRows + lane + 32 * u;
      const bool valid = row < S;
      m[u] = valid ? m_in[stat0 + row] : 0.0f;
      l[u] = valid ? l_in[stat0 + row] : 1.0f;
      delta[u] = valid ? delta_in[stat0 + row] : 0.0f;
    }
  };
  fetch(0);
  for (int j = 0; j < w.n_loads; ++j) {
    const int st = ring.stage(j), q0 = (w.q_begin + j) * kRows;
    ring.wait_empty(j);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = lane + 32 * u;
      const float linv = 1.0f / l[u];
      sm.ml[st][r] = kParts == 1 ? m[u] * kLog2e : m[u];
      sm.linv[st][r] = linv;
      sm.d_delta[st][r] = __fmul_rn(delta[u], linv);
      sm.d_linv[st][r] = __fmul_rn(Head<kD>::kScale, linv);
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(&ring.full[st], 2 * kParts * kTile);
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        tma_load_4d(sm.q[st][p], t.q, &ring.full[st], kD * p, q0, w.h, w.b);
        tma_load_4d(sm.dout[st][p], t.dout, &ring.full[st], kD * p, q0, w.h,
                    w.b);
      }
    } else {
      mbar_arrive(&ring.full[st]);
    }
    if (j + 1 < w.n_loads) fetch(j + 1);
  }
}

template <bool kDropout, bool kBias, int kParts, int kD>
__device__ __forceinline__ void dkdv_consume(DkvSmem<kParts, kD>& sm,
                                             DkvWork w,
                                             Outputs o, PackedBias pb,
                                             Dropout drop, int S, int H,
                                             int causal) {
  constexpr bool kAddBias = kBias && kParts == 1;
  using Hd = Head<kD>;
  constexpr uint32_t kTile = Hd::kTileBytes;
  auto& ring = sm.ring;
  const int wg = threadIdx.x / 128;
  const int wt = threadIdx.x % 128;
  const int warp = wt / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kw = w.k0 + wg * kRows;      // this warpgroup's first key
  const int key0 = kw + warp * 16 + g;   // this thread's keys: key0, key0 + 8
  const uint32_t k_tile = smem_u32(sm.k[0] + wg * kRows * kD);
  const uint32_t v_tile = smem_u32(sm.v[0] + wg * kRows * kD);
  DropoutStream drs{};
  if constexpr (kDropout) drs = dropout_stream(drop, w.b * H + w.h);

  float st[32], dpt[32], dk[Hd::kAcc], dv[Hd::kAcc];
  uint32_t pf[1][4][4], dsf[1][4][4];  // bf16: phᵀ and dsᵀ A fragments
#pragma unroll
  for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < Hd::kAcc; ++e) dk[e] = dv[e] = 0.0f;
  mbar_wait(&sm.kv_full, 0);
  if constexpr (kAddBias) {
    add_head_bias<128, kD>(sm.k[0] + wg * kRows * kD, sm.bias[1], S - kw, wt);
    add_head_bias<128, kD>(sm.v[0] + wg * kRows * kD, sm.bias[2], S - kw, wt);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
  }

  // phᵀ, bf16(D·ph)ᵀ and dsᵀ of one (64-key, 64-query) tile into the A
  // operands pf and dsf: score e is key key0 + ((e / 2) & 1)·8 and query
  // q0 + (e / 4)·8 + 2t + (e & 1). Masks are compared on an edge tile only.
  auto elementwise = [&](auto edge, int q0, int stg) {
    const float* sMl = sm.ml[stg];
    const float* sDd = sm.d_delta[stg];
    const float* sDl = sm.d_linv[stg];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {  // queries q0 + nt·8 .. + 8
      const int qi = nt * 8 + 2 * t;
      const float2 mlq = *reinterpret_cast<const float2*>(sMl + qi);
      const float2 ddq = *reinterpret_cast<const float2*>(sDd + qi);
      const float2 dlq = *reinterpret_cast<const float2*>(sDl + qi);
      float pd[4], ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = 4 * nt + c;
        const int qrow = q0 + qi + (c & 1);
        const int key = key0 + (c >> 1) * 8;
        bool drop_e = false;
        if constexpr (decltype(edge)::value)
          drop_e = key >= S || qrow >= S || (causal && key > qrow);
        const float ph =
            drop_e ? 0.0f
                   : exp2_approx(exp2_arg<kD>(st[e], c & 1 ? mlq.y : mlq.x));
        pd[c] = ph;
        float dpd = dpt[e];
        if constexpr (kDropout) {
          if (!drop_e) {  // the forward's (query, key) pair, not (key, query)
            const float dm = dropout_keep(drs, qrow, key, S);
            pd[c] *= dm;
            dpd *= dm;
          }
        }
        // ds's order: ph·((dp - Δ·linv)·(linv/8))
        ds[c] = __fmul_rn(ph, __fmul_rn(__fsub_rn(dpd, c & 1 ? ddq.y : ddq.x),
                                        c & 1 ? dlq.y : dlq.x));
      }
      pf[0][nt / 2][(nt % 2) * 2 + 0] = pack_bf16x2(pd[0], pd[1]);
      pf[0][nt / 2][(nt % 2) * 2 + 1] = pack_bf16x2(pd[2], pd[3]);
      dsf[0][nt / 2][(nt % 2) * 2 + 0] = pack_bf16x2(ds[0], ds[1]);
      dsf[0][nt / 2][(nt % 2) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
    }
  };
  // The fp32 form, query columns 32·half .. + 32 of a tile at a time (the
  // products over 32 columns keep a thread's registers under the cap with
  // the three-part A fragments): from sᵀ (sh) and dpᵀ (dph) of those
  // columns, D·ph/l into sh and ds into dph, in place, then each as the
  // three bf16 parts of an A operand over 32 queries (2 k16 steps): dv +=
  // (D·ph/l)ᵀ·dO and dk += dsᵀ·Q. fp32 expf, the same masks, dropout and ds
  // as the bf16 elementwise above.
  auto half_tile = [&](auto edge, int q0, int stg, uint32_t q_st,
                       uint32_t do_st, int half) {
    constexpr uint32_t kHalf = 32 * Hd::kRowBytes;  // 32 rows of a tile
    const uint32_t qh = q_st + half * kHalf, doh = do_st + half * kHalf;
    float sh[16], dph[16];
    wgmma_fence();
    head_abt_n32<kD, kParts>(sh, k_tile, kBlockPartBytes<kD>, qh, kTile);
    head_abt_n32<kD, kParts>(dph, v_tile, kBlockPartBytes<kD>, doh, kTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sh);
    fence_regs(dph);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {  // queries q0 + 32·half + nt·8 .. + 8
      const int qi = 32 * half + nt * 8 + 2 * t;
      const float2 mq = *reinterpret_cast<const float2*>(sm.ml[stg] + qi);
      const float2 lq = *reinterpret_cast<const float2*>(sm.linv[stg] + qi);
      const float2 ddq = *reinterpret_cast<const float2*>(sm.d_delta[stg] + qi);
      const float2 dlq = *reinterpret_cast<const float2*>(sm.d_linv[stg] + qi);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = 4 * nt + c;
        const int qrow = q0 + qi + (c & 1);
        const int key = key0 + (c >> 1) * 8;
        bool drop_e = false;
        if constexpr (decltype(edge)::value)
          drop_e = key >= S || qrow >= S || (causal && key > qrow);
        const float ph =
            drop_e ? 0.0f : exp_f32<kD>(sh[e], c & 1 ? mq.y : mq.x);
        float pd = ph, dpd = dph[e];
        if constexpr (kDropout) {
          if (!drop_e) {  // the forward's (query, key) pair
            const float dm = dropout_keep(drs, qrow, key, S);
            pd *= dm;
            dpd *= dm;
          }
        }
        sh[e] = __fmul_rn(pd, c & 1 ? lq.y : lq.x);
        dph[e] = __fmul_rn(ph, __fmul_rn(__fsub_rn(dpd, c & 1 ? ddq.y : ddq.x),
                                         c & 1 ? dlq.y : dlq.x));
      }
    }
    uint32_t af[kParts][2][4];
    auto split = [&](const float (&x)[16]) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        put_a<kParts>(af, nt / 2, (nt % 2) * 2 + 0, x[4 * nt], x[4 * nt + 1]);
        put_a<kParts>(af, nt / 2, (nt % 2) * 2 + 1, x[4 * nt + 2],
                      x[4 * nt + 3]);
      }
    };
    split(sh);
    wgmma_fence();
    head_rb_into<kD, kParts, 2>(dv, af, doh, kTile);
    fence_regs(af);
    split(dph);
    wgmma_fence();
    head_rb_into<kD, kParts, 2>(dk, af, qh, kTile);
    fence_regs(af);
  };

  for (int j = 0; j < w.n_loads; ++j) {
    const int q0 = (w.q_begin + j) * kRows;
    const int stg = ring.stage(j);
    const uint32_t q_st = smem_u32(sm.q[stg][0]);
    const uint32_t do_st = smem_u32(sm.dout[stg][0]);
    ring.wait_full(j);
    // Under the causal mask a q tile wholly before this warpgroup's keys
    // sees none of them.
    const bool active = !causal || q0 + kRows > kw;
    bf16* dol = nullptr;
    if constexpr (kParts == 1) {
      dol = sm.dol[wg][j & 1];
      // kBias: both warpgroups bias the shared q tile, then meet (below) at
      // a barrier over all 256 consumers, which also covers the dol writes.
      if constexpr (kBias)
        add_head_bias<kConsumers, kD>(sm.q[stg][0], sm.bias[0], S - q0,
                                      threadIdx.x);
      if (active) {
        // dol = bf16(dO·linv) into this warpgroup's buffer, 16-byte chunks
        // at the positions TMA's swizzle gives them (chunk c of row r at
        // byte r·2kD + swizzled_chunk(r, c)·16), as in the dO tile it is
        // read from.
        const uint8_t* src = reinterpret_cast<const uint8_t*>(sm.dout[stg][0]);
        uint8_t* dst = reinterpret_cast<uint8_t*>(dol);
        constexpr int kC = Hd::kChunks;
#pragma unroll
        for (int c = 0; c < kC / 2; ++c) {
          const int chunk = wt + 128 * c;
          const int r = chunk / kC;
          const int at = r * Hd::kRowBytes +
                         swizzled_chunk<kD>(r, chunk % kC) * 16;
          const uint4 raw = *reinterpret_cast<const uint4*>(src + at);
          const bf16* x = reinterpret_cast<const bf16*>(&raw);
          const float li = sm.linv[stg][r];
          uint4 packed;
          bf16* y = reinterpret_cast<bf16*>(&packed);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            y[u] = __float2bfloat16(__bfloat162float(x[u]) * li);
          *reinterpret_cast<uint4*>(dst + at) = packed;
        }
      }
      if constexpr (kBias) {
        fence_proxy_async();
        named_barrier(3, kConsumers);
      }
    }
    if (active) {
      if constexpr (kParts == 1) {
        if constexpr (!kBias) {
          fence_proxy_async();
          named_barrier(1 + wg, 128);
        }
        wgmma_fence();
        head_abt<kD, 1>(st, k_tile, 0, q_st, 0);
        head_abt<kD, 1>(dpt, v_tile, 0, do_st, 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        if ((causal && q0 == kw) || q0 + kRows > S || kw + kRows > S)
          elementwise(std::true_type{}, q0, stg);
        else
          elementwise(std::false_type{}, q0, stg);
        wgmma_fence();
        head_rb<kD, 1, 4>(dv, pf, smem_u32(dol), 0);
        head_rb<kD, 1, 4>(dk, dsf, q_st, 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pf);
        fence_regs(dsf);
      } else {
        const bool edge =
            (causal && q0 == kw) || q0 + kRows > S || kw + kRows > S;
        for (int half = 0; half < 2; ++half) {
          if (edge)
            half_tile(std::true_type{}, q0, stg, q_st, do_st, half);
          else
            half_tile(std::false_type{}, q0, stg, q_st, do_st, half);
        }
      }
    }
    ring.release(j);
  }

  store_acc<kD>(dk,
                static_cast<OutT<kParts>*>(o.dk) + offset(o.sdk, w.b, w.h),
                o.sdk.s, key0, S, t);
  store_acc<kD>(dv,
                static_cast<OutT<kParts>*>(o.dv) + offset(o.sdv, w.b, w.h),
                o.sdv.s, key0, S, t);
  if constexpr (kBias) {
    const int D = H * kD;
    float* prow = pb.part +
                  (static_cast<size_t>(w.b) * gridDim.x + w.k0 / kBlockRows) *
                      3 * D + w.h * kD;
    // shared memory no wgmma reads any more: dol, or the fp32 form's ring
    float* red;
    if constexpr (kParts == 1)
      red = reinterpret_cast<float*>(sm.dol);
    else
      red = reinterpret_cast<float*>(sm.q);
    column_sums<kD>(dk, red, prow + D);
    column_sums<kD>(dv, red, prow + 2 * D);
  }
}

template <bool kDropout, bool kBias, int kParts, int kD>
__global__ void __launch_bounds__(kBlockThreads, 1)
unpacked_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, Outputs o,
                         PackedBias pb, const float* __restrict__ m_in,
                         const float* __restrict__ l_in,
                         const float* __restrict__ delta_in, Dropout drop,
                         int S, int H, int causal) {
  auto& sm = aligned_smem<DkvSmem<kParts, kD>>();
  DkvWork w;
  w.k0 = blockIdx.x * kBlockRows;  // the heaviest key tiles first
  w.h = blockIdx.y;
  w.b = blockIdx.z;
  // Under the causal mask queries before k0 see none of these keys.
  w.q_begin = causal ? w.k0 / kRows : 0;
  w.n_loads = (S + kRows - 1) / kRows - w.q_begin;
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    sm.ring.init(32, kConsumers / 32);
    mbar_init_fence();
  }
  if constexpr (kBias && kParts == 1)
    load_head_bias<kD>(sm.bias, pb.bias, w.h, H);
  __syncthreads();
  if (threadIdx.x >= kConsumers) {  // the producer warp
    dkdv_produce(sm, Maps{&tq, &tk, &tv, &tdo}, w, m_in, l_in, delta_in, S,
                 H);
  } else {
    dkdv_consume<kDropout, kBias, kParts, kD>(sm, w, o, pb, drop, S, H,
                                              causal);
  }
}

// out[c] = Σ_r part[r][c], rows in order: the same sum in every run.
__global__ void column_total_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int rows,
                                    int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float acc = 0.0f;
  for (int r = 0; r < rows; ++r) acc += part[static_cast<size_t>(r) * cols + c];
  out[c] = acc;
}

// dbias (3·H·d,) from the partial rows of a packed backward.
int column_total(const void* part, void* dbias, int B, int S, int H, int d,
                 cudaStream_t st) {
  const int cols = 3 * H * d;
  const int part_rows = B * ((S + kBlockRows - 1) / kBlockRows);
  column_total_kernel<<<(cols + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), part_rows,
      cols);
  return static_cast<int>(cudaGetLastError());
}

// ---- the fp32 form's pre-split ---------------------------------------------

// One fp32 operand of the pre-split: (B, H, S, kD) at its element strides,
// and each head's kD bias values at bias + h·kD (or null).
struct SplitSrc {
  const float* p;
  Strides st;
  const float* bias;
};

struct SplitSrcs {
  SplitSrc op[4];  // q, k, v, dO
};

// Operand blockIdx.y of q, k, v (each with its bias) and dO (the forward's
// pre-split has none) as its three bf16 parts: out[op] is (B, H, S, 3, kD),
// part p of element (b, h, s, c) at [b][h][s][p][c], with x = x0 + x1 + x2
// exactly (x0 = bf16(x), x1 = bf16(x − x0), x2 = bf16(x − x0 − x1)). A
// thread converts four neighbouring elements: 16-byte loads, 8-byte stores.
// Bound by its bytes: 4 read and 6 written an element.
template <int kD>
__global__ void split_parts_kernel(SplitSrcs srcs, bf16* __restrict__ out,
                                   int B, int H, int S) {
  constexpr int kPer = kD / 4;  // threads a row
  const int op = blockIdx.y;
  const SplitSrc src = op == 0 ? srcs.op[0]
                       : op == 1 ? srcs.op[1]
                       : op == 2 ? srcs.op[2]
                                 : srcs.op[3];
  const size_t rows = static_cast<size_t>(B) * H * S;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * kPer) return;
  const size_t row = i / kPer;
  const int c = 4 * static_cast<int>(i % kPer);
  const int s = static_cast<int>(row % S);
  const int h = static_cast<int>((row / S) % H);
  const int b = static_cast<int>(row / (static_cast<size_t>(S) * H));
  float4 x = *reinterpret_cast<const float4*>(
      src.p + offset(src.st, b, h) + static_cast<size_t>(s) * src.st.s + c);
  if (src.bias != nullptr) {
    const float4 bb = *reinterpret_cast<const float4*>(src.bias + h * kD + c);
    x.x = __fadd_rn(x.x, bb.x);
    x.y = __fadd_rn(x.y, bb.y);
    x.z = __fadd_rn(x.z, bb.z);
    x.w = __fadd_rn(x.w, bb.w);
  }
  bf16* dst = out + (op * rows + row) * (3 * kD) + c;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    *reinterpret_cast<uint2*>(dst + kD * p) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
    x.x = __fsub_rn(x.x, __low2float(lo));
    x.y = __fsub_rn(x.y, __high2float(lo));
    x.z = __fsub_rn(x.z, __low2float(hi));
    x.w = __fsub_rn(x.w, __high2float(hi));
  }
}

// q, k, v and dout (or null: the forward's pre-split) fp32 at strides[0..8]
// and [9..11] with the bias parts bq, bk, bv (or null) → parts (4, B, H, S,
// 3, d) bf16, or (3, ...) without dout; d 32 or 64.
int split_parts(const void* q, const void* k, const void* v, const void* bq,
                const void* bk, const void* bv, const void* dout, void* parts,
                const long long* strides, int B, int S, int H, int d,
                cudaStream_t st) {
  if (d != 32 && d != 64) return cudaErrorInvalidValue;
  SplitSrcs srcs{};
  const void* ps[4] = {q, k, v, dout};
  const void* bs[4] = {bq, bk, bv, nullptr};
  const int ops = dout != nullptr ? 4 : 3;
  for (int i = 0; i < ops; ++i)
    srcs.op[i] = {static_cast<const float*>(ps[i]),
                  {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]},
                  static_cast<const float*>(bs[i])};
  const size_t threads = static_cast<size_t>(B) * H * S * (d / 4);
  const dim3 grid(static_cast<unsigned>((threads + 255) / 256), ops);
  if (d == 64)
    split_parts_kernel<64><<<grid, 256, 0, st>>>(
        srcs, static_cast<bf16*>(parts), B, H, S);
  else
    split_parts_kernel<32><<<grid, 256, 0, st>>>(
        srcs, static_cast<bf16*>(parts), B, H, S);
  return static_cast<int>(cudaGetLastError());
}

template <int kParts, int kD>
constexpr int kDqSmemBytes =
    static_cast<int>(sizeof(DqSmem<kParts, kD>)) + 1024;
template <int kParts, int kD>
constexpr int kDkvSmemBytes =
    static_cast<int>(sizeof(DkvSmem<kParts, kD>)) + 1024;

// The tensor maps and the launches of the dq and dk/dv kernels <kDropout,
// kBias, kParts, kD>: K7/K8 with pb.part null, K2 with its bias and partial
// sums. q, k, v, dout: bf16 (kParts 1, width kD) or part arrays (kParts 3,
// width 3·kD) at strides[0..11]; dq, dk, dv: OutT<kParts> at
// strides[12..20].
template <int kParts, int kD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           int width, const void* m, const void* l, void* dq, void* dk,
           void* dv, void* delta, PackedBias pb, const void* seed,
           const long long* strides, int B, int S, int H, int causal,
           unsigned int threshold, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  int err = head_map(&tq, q, strides + 0, B, H, S, width, kD);
  if (!err) err = head_map(&tk, k, strides + 3, B, H, S, width, kD);
  if (!err) err = head_map(&tv, v, strides + 6, B, H, S, width, kD);
  if (!err) err = head_map(&tdo, dout, strides + 9, B, H, S, width, kD);
  if (err) return err;
  const Outputs o{dq, dk, dv,
                  {strides[12], strides[13], strides[14]},
                  {strides[15], strides[16], strides[17]},
                  {strides[18], strides[19], strides[20]}};
  const dim3 grid((S + kBlockRows - 1) / kBlockRows, H, B);
  const Dropout drop{static_cast<const int*>(seed), threshold, scale};
  const int dr = seed != nullptr, bi = pb.part != nullptr;
  using DqKernel = decltype(&unpacked_bwd_dq_kernel<false, false, kParts, kD>);
  using DkvKernel =
      decltype(&unpacked_bwd_dkdv_kernel<false, false, kParts, kD>);
  const DqKernel dq_kernels[2][2] = {
      {&unpacked_bwd_dq_kernel<false, false, kParts, kD>,
       &unpacked_bwd_dq_kernel<false, true, kParts, kD>},
      {&unpacked_bwd_dq_kernel<true, false, kParts, kD>,
       &unpacked_bwd_dq_kernel<true, true, kParts, kD>}};
  const DkvKernel dkdv_kernels[2][2] = {
      {&unpacked_bwd_dkdv_kernel<false, false, kParts, kD>,
       &unpacked_bwd_dkdv_kernel<false, true, kParts, kD>},
      {&unpacked_bwd_dkdv_kernel<true, false, kParts, kD>,
       &unpacked_bwd_dkdv_kernel<true, true, kParts, kD>}};
  const DqKernel dq_kernel = dq_kernels[dr][bi];
  const DkvKernel dkdv_kernel = dkdv_kernels[dr][bi];
  constexpr int kDqSmem = kDqSmemBytes<kParts, kD>;
  constexpr int kDkvSmem = kDkvSmemBytes<kParts, kD>;
  err = static_cast<int>(cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem));
  if (!err)
    err = static_cast<int>(cudaFuncSetAttribute(
        dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem));
  if (err) return err;
  dq_kernel<<<grid, kBlockThreads, kDqSmem, st>>>(
      tq, tk, tv, tdo, o, pb, static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<float*>(delta), drop, S, H,
      causal);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dkdv_kernel<<<grid, kBlockThreads, kDkvSmem, st>>>(
      tq, tk, tv, tdo, o, pb, static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(delta), drop, S,
      H, causal);
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

// Dynamic shared memory of the dq (dkdv 0) and dk/dv (dkdv 1) kernels at
// head width d, bf16 (fp32 0) or the fp32 form (fp32 1), bytes (for the
// build report).
extern "C" int attention_bwd_smem(int dkdv, int fp32, int d) {
  if (d == 32) {
    if (fp32) return dkdv ? kDkvSmemBytes<3, 32> : kDqSmemBytes<3, 32>;
    return dkdv ? kDkvSmemBytes<1, 32> : kDqSmemBytes<1, 32>;
  }
  if (fp32) return dkdv ? kDkvSmemBytes<3, 64> : kDqSmemBytes<3, 64>;
  return dkdv ? kDkvSmemBytes<1, 64> : kDqSmemBytes<1, 64>;
}

// Rows of q (dq kernel) or keys (dk/dv kernel) per block: K2's partial
// column sums have B·⌈S / this⌉ rows.
extern "C" int attention_bwd_block_rows() { return kBlockRows; }

// q, k, v, dout, dq, dk, dv: (B, H, S, d) bf16, d 32 or 64, at the element
// strides strides[3i .. 3i+2] (batch, head, row) for i = 0..6 in that
// order, each a multiple of 8, bases 16-byte aligned; m, l: (B, H, S) fp32
// from attention_fwd; delta: (B, H, S) fp32 workspace. All contiguous except
// where strided. seed: the forward's (2,) int32 [seed, offset] with its
// `threshold` and `scale`, or null for no dropout. Returns the first error
// of building the tensor maps or of the two launches (cudaGetLastError()).
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* m, const void* l,
                             void* dq, void* dk, void* dv, void* delta,
                             const void* seed, const long long* strides, int B,
                             int S, int H, int d, int causal,
                             unsigned int threshold, float scale,
                             void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  return launch_d<1>(d, q, k, v, dout, d, m, l, dq, dk, dv, delta,
                     PackedBias{}, seed, strides, B, S, H, causal, threshold,
                     scale, static_cast<cudaStream_t>(stream));
}

// K2. qkv: (B, S, 3·H·d) bf16; bias: (3·H·d,) bf16; dout: (B, S, H·d)
// bf16; m, l: (B, H, S) fp32 from attention_packed_fwd; dqkv: (B, S, 3·H·d)
// bf16; dbias: (3·H·d,) fp32. Workspace: delta (B, H, S) fp32 and part
// (B·⌈S/attention_bwd_block_rows()⌉, 3·H·d) fp32. All contiguous and
// 16-byte aligned. seed, threshold and scale as attention_bwd's. Returns
// the first error of the maps or the three launches.
extern "C" int attention_packed_bwd(const void* qkv, const void* bias,
                                    const void* dout, const void* m,
                                    const void* l, void* dqkv, void* dbias,
                                    void* delta, void* part, const void* seed,
                                    int B, int S, int H, int d, int causal,
                                    unsigned int threshold, float scale,
                                    void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long D = static_cast<long long>(H) * d;
  // (batch, head, row) strides of q, k, v, dO, dq, dk, dv: dO's of (B, S,
  // D), the others' of the packed (B, S, 3D)
  const long long packed[3] = {S * 3 * D, d, 3 * D}, rows[3] = {S * D, d, D};
  long long strides[21];
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j)
      strides[3 * i + j] = i == 3 ? rows[j] : packed[j];
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* dx = static_cast<bf16*>(dqkv);
  const PackedBias pb{static_cast<const bf16*>(bias),
                      static_cast<float*>(part)};
  const int err = launch_d<1>(
      d, static_cast<const void*>(x), static_cast<const void*>(x + D),
      static_cast<const void*>(x + 2 * D), dout, d, m, l,
      static_cast<void*>(dx), static_cast<void*>(dx + D),
      static_cast<void*>(dx + 2 * D), delta, pb, seed,
      static_cast<const long long*>(strides), B, S, H, causal, threshold,
      scale, st);
  if (err) return err;
  return column_total(part, dbias, B, S, H, d, st);
}

// The fp32 forms' pre-split: the backward runs it first (this entry checks
// and times it), the forward's caller before attention_f32_fwd, with dout
// null. q, k, v, dout (B, H, S, d) fp32 at the element strides
// strides[0..11] as attention_f32_bwd's (strides[0..8] without dout), bq,
// bk, bv each head's bias at b + h·d or null → parts (4, B, H, S, 3, d)
// bf16, contiguous, or (3, B, H, S, 3, d) without dout.
extern "C" int attention_f32_split(const void* q, const void* k,
                                   const void* v, const void* bq,
                                   const void* bk, const void* bv,
                                   const void* dout, void* parts,
                                   const long long* strides, int B, int S,
                                   int H, int d, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  return split_parts(q, k, v, bq, bk, bv, dout, parts, strides, B, S, H, d,
                     static_cast<cudaStream_t>(stream));
}

// The fp32 form (K2, K7/K8 on fp32 operands). q, k, v, dout, dq, dk, dv:
// (B, H, S, d) fp32, d 32 or 64, at the element strides strides[3i ..
// 3i+2] (batch, head, row) for i = 0..6 in that order, each a multiple of
// 4, bases 16-byte aligned; bq, bk, bv: each head's d bias values of the
// packed layout at b + h·d (added to q, k and v), or null; m, l: the
// forward's (B, H, S) fp32; delta: (B, H, S) fp32 workspace; parts: (4, B,
// H, S, 3, d) bf16 workspace. With part (B·⌈S/attention_bwd_block_rows()⌉,
// 3·H·d) fp32 workspace and dbias (3·H·d,) fp32 non-null, also the bias
// gradient: the column sums of dq, dk and dv at columns h·d, D + h·d and
// 2D + h·d. seed as attention_bwd's. Returns the first error of the four
// launches and the maps.
extern "C" int attention_f32_bwd(const void* q, const void* k, const void* v,
                                 const void* bq, const void* bk, const void* bv,
                                 const void* dout, const void* m, const void* l,
                                 void* dq, void* dk, void* dv, void* delta,
                                 void* parts, void* part, void* dbias,
                                 const void* seed, const long long* strides,
                                 int B, int S, int H, int d, int causal,
                                 unsigned int threshold, float scale,
                                 void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = split_parts(q, k, v, bq, bk, bv, dout, parts, strides, B, S, H, d,
                        st);
  if (err) return err;
  // The part arrays' (batch, head, row) strides, then the outputs' own
  const long long width = 3LL * d;
  const long long split[3] = {static_cast<long long>(H) * S * width,
                              static_cast<long long>(S) * width, width};
  long long all[21];
  for (int i = 0; i < 21; ++i) all[i] = i < 12 ? split[i % 3] : strides[i];
  const size_t n = static_cast<size_t>(B) * H * S * width;
  const bf16* x = static_cast<const bf16*>(parts);
  const PackedBias pb{nullptr,
                      dbias != nullptr ? static_cast<float*>(part) : nullptr};
  err = launch_d<3>(
      d, static_cast<const void*>(x), static_cast<const void*>(x + n),
      static_cast<const void*>(x + 2 * n), static_cast<const void*>(x + 3 * n),
      static_cast<int>(width), m, l, dq, dk, dv, delta, pb, seed,
      static_cast<const long long*>(all), B, S, H, causal, threshold, scale,
      st);
  if (err || pb.part == nullptr) return err;
  return column_total(part, dbias, B, S, H, d, st);
}
