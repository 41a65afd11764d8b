// K6: unpacked attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel vit_tpu/kernels/attention.py:_fa_kernel (:76),
// launched by _flash_attention_fwd_impl (:172) behind flash_attention
// (:1294). Same math: o = softmax(mask(q kᵀ / √d)) v over q, k, v of
// (B, H, S, 64) bf16. 1/√d = 1/8 is folded into q in bf16 (exact: a power of
// two). Scores, the row max m and the row sum l are fp32; p = exp(s - m) is
// rounded to bf16 UNNORMALISED for the PV product, which accumulates in fp32,
// and the result is divided by l and rounded to bf16 (:110-137). The causal
// mask compares global rows and columns (col <= row) and key padding is
// col < S, as the Pallas kernel's (:110-116) with its q-block offset.
//
// Each of q, k, v and the output is addressed through its own (batch, head,
// row) strides in elements, with unit stride along head_dim, so the head
// views of a packed (B, S, 3·H·64) projection and an output laid out
// (B, S, H, 64) need no copies. With m_out/l_out non-null it also writes m and
// l, fp32, as two contiguous (B, H, S) arrays: the residuals the backward
// (attention_bwd.cu) rebuilds p from, where the TPU's K7/K8 recompute them.
//
// Dropout (kDropout, with a seed vector), as K1's and :118-137: p is
// multiplied by the mask D of csrc/dropout.cuh after l has summed it and
// before its bf16 cast (row the global query, column the global key, stride
// S, stream b·H + h + offset); the saved (m, l) are the unmasked ones.
//
// The design is K1's (attention_packed_fwd.cu), not the TPU's blocking: one
// block per (64-row q tile, head, batch) of four warps, each warp owning 16 q
// rows, looping over 64-row K/V tiles, so any S works (the TPU kernel pads S
// to a multiple of its 512-row q block and holds all of K and V in VMEM). Two
// passes over K: the first for the exact row max, so that p is rounded to
// bf16 against the row max where the Pallas kernel rounds it; the second for
// p, l and P·V. Under the causal mask a q tile stops at its own last key, so
// the wholly masked key tiles are never read.
//
// What bounds it: per (batch, head) the two products cost 4·S²·64 FLOP
// (halved under the causal mask; 6·S²·64 with the recomputed q kᵀ) against
// 4·S·64·2 bytes of q, k, v and output, ≈ S/2 FLOP per byte: 512 at S = 1024,
// above the H100's bf16 ridge (≈ 295), so the tensor-core issue rate and the
// fp32 softmax between the products bound it. Products run on the tensor
// cores (mma.sync m16n8k16, bf16 in, fp32 accumulate), scores and P stay in
// registers, and V is stored transposed in shared memory so every fragment
// load is one 32-bit read. wgmma, TMA and a multi-stage pipeline are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "dropout.cuh"

namespace {

using namespace vit;

template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     Dropout drop, Strides sq, Strides sk, Strides sv,
                     Strides so, int S, int H, int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kPitch];
  __shared__ __align__(16) bf16 sK[kTile * kPitch];
  __shared__ __align__(16) bf16 sVt[kHeadDim * kPitch];  // [d][kv]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = q + offset(sq, b, h);
  const bf16* kb = k + offset(sk, b, h);
  const bf16* vb = v + offset(sv, b, h);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread within the group

  load_tile<false, false>(sQ, qb + q0 * sq.s, nullptr, S - q0, sq.s, kScale);
  __syncthreads();

  // This warp's 16 q rows as A fragments, one per 16-wide step of head_dim.
  uint32_t qf[kHeadDim / 16][4];
  load_a_rows(qf, sQ + warp * 16 * kPitch, g, t);

  // Each thread holds rows row0 and row0 + 8 of the warp's 16.
  const int row0 = q0 + warp * 16 + g;
  const int kv_end = causal ? min(S, q0 + kTile) : S;

  // Pass 1: the exact row max over every unmasked key.
  float m[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous K tile
    load_tile<false, false>(sK, kb + k0 * sk.s, nullptr, S - k0, sk.s, 1.0f);
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
    load_tile<false, false>(sK, kb + k0 * sk.s, nullptr, S - k0, sk.s, 1.0f);
    load_tile<true, false>(sVt, vb + k0 * sv.s, nullptr, S - k0, sv.s, 1.0f);
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
  bf16* ob = out + offset(so, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= S) continue;
    bf16* orow = ob + static_cast<size_t>(row) * so.s;
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

// q, k, v, out: (B, H, S, 64) bf16 at the element strides
// strides[0..2] (q), [3..5] (k), [6..8] (v), [9..11] (out), each (batch,
// head, row), multiples of 8 with 16-byte aligned bases; m, l: (B, H, S)
// fp32, contiguous, or both null for no stats; seed: (2,) int32 [seed,
// offset] on the device for dropout with `threshold` and `scale`
// (csrc/dropout.cuh), or null for none. Returns cudaGetLastError() after the
// launch.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* out, void* m, void* l, const void* seed,
                             const long long* strides, int B, int S, int H,
                             int causal, unsigned int threshold, float scale,
                             void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  const Dropout drop{static_cast<const int*>(seed), threshold, scale};
  auto kernel = seed != nullptr ? &attention_fwd_kernel<true>
                                : &attention_fwd_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(m), static_cast<float*>(l), drop, sq, sk, sv, so, S,
      H, causal);
  return static_cast<int>(cudaGetLastError());
}
