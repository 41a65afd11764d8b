// K1: packed-QKV attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel vit_tpu/kernels/attention.py:_fa_packed_kernel
// (:623), launched by _packed_fwd_impl (:790) behind flash_attention_packed
// (:1269). Same math: softmax(q kᵀ / √d) v straight off the UNBIASED packed
// projection qkv_nb (B, S, 3D) bf16, columns laid out (three h d), with the
// (3D,) bias added in bf16 as each tile is read (:672-676). 1/√d = 1/8 is
// folded into q (exact: a power of two). Scores and the softmax are fp32; p is
// rounded to bf16 UNNORMALISED for the PV product, which accumulates in fp32,
// and the result is divided by the row sum l at the end (:699-715).
// Key padding (any S) and the causal mask follow :648-654.
//
// With m_out/l_out non-null it also writes the row max m and the row sum l,
// fp32, as two (B, H, S) arrays: the residuals K2 (attention_packed_bwd.cu)
// rebuilds p from (:731-744, without the TPU's 8-lane-replicated layout). The
// two-pass design has both exactly at the end, so the stats cost one store per
// row and nothing when they are not asked for.
//
// Dropout (kDropout, with a seed vector): after l has summed p = exp(s - m),
// each p is multiplied by the mask D of csrc/dropout.cuh, before its bf16
// cast, as :699-715 does (row the global query, column the global key, stride
// S, stream b·H + h + offset). Entries the key padding or the causal mask
// already zeroed skip the hash. The saved (m, l) are the unmasked ones.
//
// Not the TPU's blocking: one block per (64-row q tile, head, batch) of four
// warps, each warp owning 16 q rows, looping over 64-row K/V tiles, so any S
// works; the TPU kernel holds the whole (S, S) score plane instead. The loop
// runs twice: pass 1 computes q kᵀ only, for the exact row max m; pass 2
// recomputes q kᵀ and forms p = exp(s - m), l and P·V. An online softmax
// (running max, rescaled accumulator) would save the second q kᵀ but rounds p
// to bf16 relative to a running max, not the row max: with TiTok-B's random
// weights that alone flipped 1.8% of the served codes against the plain
// version, where this kernel keeps the TPU kernel's rounding points.
//
// What bounds it: per (batch, head) the two products cost 4·S²·64 FLOP (6·S²·64
// with the recomputed q kᵀ) against 4·S·64·2 bytes of q, k, v and output,
// ≈ S/2 FLOP per byte: 160 at S = 320, near the H100's bf16 ridge, so the
// tensor-core issue rate and the fp32 softmax between the products bound it
// once K/V tiles sit in L2. The design keeps the products on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate), keeps scores and P in
// registers (the score accumulator layout is reused as the A operand of PV
// without a shared-memory round trip), and stores V transposed in shared
// memory so every fragment load is one conflict-free 32-bit read. wgmma, TMA
// and a multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "dropout.cuh"

namespace {

using namespace vit;

template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
attention_packed_fwd_kernel(const bf16* __restrict__ qkv,
                            const bf16* __restrict__ bias,
                            bf16* __restrict__ out, float* __restrict__ m_out,
                            float* __restrict__ l_out, Dropout drop, int S,
                            int H, int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kPitch];
  __shared__ __align__(16) bf16 sK[kTile * kPitch];
  __shared__ __align__(16) bf16 sVt[kHeadDim * kPitch];  // [d][kv]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * kHeadDim;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * S * row_stride;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread within the group

  load_tile<false>(sQ, base + q0 * row_stride + h * kHeadDim,
                   bias + h * kHeadDim, S - q0, row_stride, 0.125f);
  __syncthreads();

  // This warp's 16 q rows as A fragments, one per 16-wide step of head_dim.
  uint32_t qf[kHeadDim / 16][4];
  load_a_rows(qf, sQ + warp * 16 * kPitch, g, t);

  // Each thread holds rows row0 and row0 + 8 of the warp's 16.
  const int row0 = q0 + warp * 16 + g;
  const int kv_end = causal ? min(S, q0 + kTile) : S;

  // Pass 1: the exact row max over every key, as the TPU kernel's full-row
  // softmax has it, so that p is rounded to bf16 at the same points.
  float m[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous K tile
    load_tile<false>(sK, base + k0 * row_stride + D + h * kHeadDim,
                     bias + D + h * kHeadDim, S - k0, row_stride, 1.0f);
    __syncthreads();
    float s[kTile / 8][4];
    scores(s, qf, sK, k0, row0, S, causal, g, t);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      m[0] = fmaxf(m[0], fmaxf(s[nt][0], s[nt][1]));
      m[1] = fmaxf(m[1], fmaxf(s[nt][2], s[nt][3]));
    }
  }
  // A row is spread over the 4 threads of a group. Column 0 is valid for
  // every row, so m is finite and no exp below sees (-inf) - (-inf).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }

  // Pass 2: p = exp(s - m) in fp32, summed unrounded into l, and P (bf16,
  // unnormalised, after the dropout mask) times V accumulated in fp32.
  DropoutStream drs{};
  if constexpr (kDropout) drs = dropout_stream(drop, b * H + h);
  float o[kHeadDim / 8][4];
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
  float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<false>(sK, base + k0 * row_stride + D + h * kHeadDim,
                     bias + D + h * kHeadDim, S - k0, row_stride, 1.0f);
    load_tile<true>(sVt, base + k0 * row_stride + 2 * D + h * kHeadDim,
                    bias + 2 * D + h * kHeadDim, S - k0, row_stride, 1.0f);
    __syncthreads();
    float s[kTile / 8][4];
    scores(s, qf, sK, k0, row0, S, causal, g, t);

    // P goes to bf16 directly in the A-fragment layout: key step j covers
    // score tiles 2j and 2j + 1.
    uint32_t pf[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float p0 = expf(s[nt][0] - m[0]);
      float p1 = expf(s[nt][1] - m[0]);
      float p2 = expf(s[nt][2] - m[1]);
      float p3 = expf(s[nt][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      if constexpr (kDropout) {
        const int col = k0 + nt * 8 + 2 * t;
        p0 *= dropout_at(drs, row0, col, S, causal);
        p1 *= dropout_at(drs, row0, col + 1, S, causal);
        p2 *= dropout_at(drs, row0 + 8, col, S, causal);
        p3 *= dropout_at(drs, row0 + 8, col + 1, S, causal);
      }
      pf[nt / 2][(nt % 2) * 2 + 0] = pack_bf16x2(p0, p1);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16x2(p2, p3);
    }

    // o += P v: B fragments are (key, d) pairs read from the transposed V.
#pragma unroll
    for (int nt = 0; nt < kHeadDim / 8; ++nt)
      mma_row<kTile / 16>(o[nt], pf, sVt, kPitch, nt * 8, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= S) continue;
    bf16* orow = out + (static_cast<size_t>(b) * S + row) * D + h * kHeadDim;
#pragma unroll
    for (int nt = 0; nt < kHeadDim / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + 2 * t) =
          pack_bf16x2(o[nt][2 * r] / l[r], o[nt][2 * r + 1] / l[r]);
    }
    if (m_out != nullptr && t == 0) {
      const size_t i = (static_cast<size_t>(b) * H + h) * S + row;
      m_out[i] = m[r];
      l_out[i] = l[r];
    }
  }
}

}  // namespace

// qkv: (B, S, 3·H·64) bf16, contiguous, 16-byte aligned; bias: (3·H·64,) bf16;
// out: (B, S, H·64) bf16; m, l: (B, H, S) fp32, or both null for no stats;
// seed: (2,) int32 [seed, offset] on the device for dropout with `threshold`
// and `scale` (csrc/dropout.cuh), or null for none. Returns
// cudaGetLastError() after the launch.
extern "C" int attention_packed_fwd(const void* qkv, const void* bias, void* out,
                                    void* m, void* l, const void* seed, int B,
                                    int S, int H, int causal,
                                    unsigned int threshold, float scale,
                                    void* stream) {
  if (B == 0 || S == 0) return 0;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  const Dropout drop{static_cast<const int*>(seed), threshold, scale};
  auto kernel = seed != nullptr ? &attention_packed_fwd_kernel<true>
                                : &attention_packed_fwd_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), static_cast<float*>(m), static_cast<float*>(l),
      drop, S, H, causal);
  return static_cast<int>(cudaGetLastError());
}
