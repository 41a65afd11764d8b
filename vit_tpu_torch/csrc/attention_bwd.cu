// K7/K8: unpacked attention backward for Hopper (sm_90a).
//
// Replaces both Pallas backward kernels of the unpacked attention:
// vit_tpu/kernels/attention.py:_fa_bwd_kernel (:201, K7, launched by
// _flash_attention_bwd_impl :441 for S <= 768) and _fa_bwd_tiled_kernel
// (:284, K8, launched by _flash_attention_bwd_tiled_impl :395 for S > 768,
// VideoGPT's S = 1024). The TPU splits them at 768 only because one
// program's (S, S) planes must fit VMEM; here one pair of kernels over 64-row
// tiles takes every S. Inputs: q, k, v and the upstream gradient dO, each
// (B, H, S, 64) bf16 at its own (batch, head, row) element strides, and K6's
// row statistics m and l, fp32 (B, H, S) contiguous. Outputs dq, dk, dv,
// (B, H, S, 64) bf16 at their own strides.
//
// The math of :244-277 (and :325-357), with p rebuilt from K6's saved
// statistics instead of recomputed:
//   ph = exp(s - m) unnormalised, linv = 1/l, s = (q/8)·kᵀ masked;
//   dv = bf16(ph)ᵀ · bf16(dO·linv);   dp = dO · vᵀ;   Δ = Σ_keys ph·dp;
//   ds = bf16(ph · ((dp - Δ·linv) · (linv/8)));
//   dq = ds · k,  dk = dsᵀ · q  (the unscaled q).
// Products are bf16 in, fp32 accumulate; ph, dp, Δ and ds stay fp32 until
// ds's cast, and each output is cast to bf16 once, as on the TPU (whose K8
// sums fp32 per-q-block dk/dv partials in XLA before the cast, :416-418).
//
// Blocks run in parallel with no carried state, while dq sums over keys and
// dk, dv over queries. So, as K2 (attention_packed_bwd.cu) does, two kernels
// accumulate their outputs in registers, with no atomics and no partials:
//   1. dq kernel, one block per (q tile, head, batch): pass 1 over the keys
//      sums Δ for its rows and stores it, fp32 (B, H, S); pass 2 rebuilds ds
//      and accumulates dq = ds · k.
//   2. dk/dv kernel, one block per (key tile, head, batch), the K/V-outer
//      loop: over the q tiles it rebuilds sᵀ = k·qᵀ and dpᵀ = v·dOᵀ, so that
//      phᵀ and dsᵀ come out of the accumulators in the A-fragment layout of
//      dv += phᵀ·dol and dk += dsᵀ·q.
// Under the causal mask the dq kernel stops at its q tile's last key and the
// dk/dv kernel starts at its own key tile, so wholly masked tiles are skipped.
//
// What bounds it: the minimal backward is 5 products of 2·S²·64 FLOP per
// (batch, head), halved by the causal mask; this design spends 9 (q·kᵀ and
// dO·vᵀ three times each) for the freedom from atomics and from a
// sequence-sized shared memory. At S = 1024 that is far past the bf16 ridge
// against ~8·S·64·2 bytes of q, k, v, dO, dq, dk, dv, so the tensor-core
// issue rate and the fp32 elementwise work between the products bound it.
// mma.sync m16n8k16 as in K1; wgmma, TMA and one fused pass are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using namespace vit;

struct Operands {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
};

__global__ void __launch_bounds__(kThreads)
unpacked_bwd_dq_kernel(Operands a, const float* __restrict__ m_in,
                       const float* __restrict__ l_in,
                       float* __restrict__ delta_out, int S, int H,
                       int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kPitch];     // q / 8
  __shared__ __align__(16) bf16 sDO[kTile * kPitch];    // dO
  __shared__ __align__(16) bf16 sK[kTile * kPitch];     // k, [key][d]
  __shared__ __align__(16) bf16 sKt[kHeadDim * kPitch]; // k, [d][key]
  __shared__ __align__(16) bf16 sV[kTile * kPitch];     // v, [key][d]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = a.q + offset(a.sq, b, h);
  const bf16* kb = a.k + offset(a.sk, b, h);
  const bf16* vb = a.v + offset(a.sv, b, h);
  const bf16* dob = a.dout + offset(a.sdo, b, h);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  load_tile<false, false>(sQ, qb + q0 * a.sq.s, nullptr, S - q0, a.sq.s,
                          kScale);
  load_tile<false, false>(sDO, dob + q0 * a.sdo.s, nullptr, S - q0, a.sdo.s,
                          1.0f);
  __syncthreads();
  uint32_t qf[kHeadDim / 16][4], dof[kHeadDim / 16][4];
  load_a_rows(qf, sQ + warp * 16 * kPitch, g, t);
  load_a_rows(dof, sDO + warp * 16 * kPitch, g, t);

  // Rows row0 and row0 + 8. Padded rows get m = 0, l = 1: their dO is zero,
  // so dp, Δ and ds vanish there and nothing non-finite is formed.
  const int row0 = q0 + warp * 16 + g;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;
  float mr[2], linv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    mr[r] = row < S ? m_in[stat0 + row] : 0.0f;
    linv[r] = row < S ? 1.0f / l_in[stat0 + row] : 1.0f;
  }
  const int kv_end = causal ? min(S, q0 + kTile) : S;

  // Pass 1: Δ = Σ_keys ph·dp for this thread's two rows.
  float delta[2] = {0.0f, 0.0f};
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    load_tile<false, false>(sK, kb + k0 * a.sk.s, nullptr, S - k0, a.sk.s,
                            1.0f);
    load_tile<false, false>(sV, vb + k0 * a.sv.s, nullptr, S - k0, a.sv.s,
                            1.0f);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_row<kHeadDim / 16>(s, qf, sK, kPitch, nt * 8, g, t);
      mma_row<kHeadDim / 16>(dp, dof, sV, kPitch, nt * 8, g, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (col >= S || (causal && col > row)) continue;
        delta[e >> 1] += expf(s[e] - mr[e >> 1]) * dp[e];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    const int row = row0 + r * 8;
    if (t == 0 && row < S) delta_out[stat0 + row] = delta[r];
  }

  // Pass 2: ds for 16 keys at a time, straight into A fragments, and
  // dq += ds · k with k read from its transposed copy.
  float dq[kHeadDim / 8][4];
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt)
    dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.0f;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    load_tile<false, false>(sK, kb + k0 * a.sk.s, nullptr, S - k0, a.sk.s,
                            1.0f);
    load_tile<true, false>(sKt, kb + k0 * a.sk.s, nullptr, S - k0, a.sk.s,
                           1.0f);
    load_tile<false, false>(sV, vb + k0 * a.sv.s, nullptr, S - k0, a.sv.s,
                            1.0f);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t dsf[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * ks + half;
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_row<kHeadDim / 16>(s, qf, sK, kPitch, nt * 8, g, t);
        mma_row<kHeadDim / 16>(dp, dof, sV, kPitch, nt * 8, g, t);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          const int r = e >> 1;
          const bool masked = col >= S || (causal && col > row0 + r * 8);
          const float ph = masked ? 0.0f : expf(s[e] - mr[r]);
          ds[e] = dscore(ph, dp[e], delta[r], linv[r]);
        }
        dsf[half * 2 + 0] = pack_bf16x2(ds[0], ds[1]);
        dsf[half * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
      }
#pragma unroll
      for (int nd = 0; nd < kHeadDim / 8; ++nd) {
        const bf16* kr = sKt + (nd * 8 + g) * kPitch + ks * 16 + 2 * t;
        mma_16816(dq[nd], dsf, ld32(kr), ld32(kr + 8));
      }
    }
  }

  store_rows(dq, a.dq + offset(a.sdq, b, h), a.sdq.s, row0, S, t);
}

__global__ void __launch_bounds__(kThreads)
unpacked_bwd_dkdv_kernel(Operands a, const float* __restrict__ m_in,
                         const float* __restrict__ l_in,
                         const float* __restrict__ delta_in, int S, int H,
                         int causal) {
  __shared__ __align__(16) bf16 sA[kTile * kPitch];       // k, then q / 8
  __shared__ __align__(16) bf16 sB[kTile * kPitch];       // v, then dO
  __shared__ __align__(16) bf16 sQt[kHeadDim * kPitch];   // q, [d][q]
  __shared__ __align__(16) bf16 sDOLt[kHeadDim * kPitch]; // bf16(dO·linv), [d][q]
  __shared__ float sM[kTile], sLinv[kTile], sDelta[kTile];

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = a.q + offset(a.sq, b, h);
  const bf16* kb = a.k + offset(a.sk, b, h);
  const bf16* vb = a.v + offset(a.sv, b, h);
  const bf16* dob = a.dout + offset(a.sdo, b, h);
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  // This warp's 16 keys of k and v as A fragments, kept for the whole loop.
  load_tile<false, false>(sA, kb + k0 * a.sk.s, nullptr, S - k0, a.sk.s, 1.0f);
  load_tile<false, false>(sB, vb + k0 * a.sv.s, nullptr, S - k0, a.sv.s, 1.0f);
  __syncthreads();
  uint32_t kf[kHeadDim / 16][4], vf[kHeadDim / 16][4];
  load_a_rows(kf, sA + warp * 16 * kPitch, g, t);
  load_a_rows(vf, sB + warp * 16 * kPitch, g, t);
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  float dk[kHeadDim / 8][4], dv[kHeadDim / 8][4];
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt) {
    dk[nt][0] = dk[nt][1] = dk[nt][2] = dk[nt][3] = 0.0f;
    dv[nt][0] = dv[nt][1] = dv[nt][2] = dv[nt][3] = 0.0f;
  }

  // Under the causal mask queries before k0 see none of these keys.
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += kTile) {
    __syncthreads();  // every warp is done with the previous tiles
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int row = q0 + i;
      const bool valid = row < S;
      sM[i] = valid ? m_in[stat0 + row] : 0.0f;
      sLinv[i] = valid ? 1.0f / l_in[stat0 + row] : 1.0f;
      sDelta[i] = valid ? delta_in[stat0 + row] : 0.0f;
    }
    __syncthreads();
    load_tile<false, false>(sA, qb + q0 * a.sq.s, nullptr, S - q0, a.sq.s,
                            kScale);
    load_tile<true, false>(sQt, qb + q0 * a.sq.s, nullptr, S - q0, a.sq.s,
                           1.0f);
    load_tile<false, false>(sB, dob + q0 * a.sdo.s, nullptr, S - q0, a.sdo.s,
                            1.0f);
    load_tile<true, false, true>(sDOLt, dob + q0 * a.sdo.s, nullptr, S - q0,
                                 a.sdo.s, 1.0f, sLinv);
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t pf[4], dsf[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * ks + half;  // queries q0 + nt·8 .. + 8
        float st[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dpt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_row<kHeadDim / 16>(st, kf, sA, kPitch, nt * 8, g, t);
        mma_row<kHeadDim / 16>(dpt, vf, sB, kPitch, nt * 8, g, t);
        float ph[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + 2 * t + (e & 1);
          const int qrow = q0 + qi;
          const int key = key0 + (e >> 1) * 8;
          const bool masked = key >= S || qrow >= S || (causal && key > qrow);
          ph[e] = masked ? 0.0f : expf(st[e] - sM[qi]);
          ds[e] = dscore(ph[e], dpt[e], sDelta[qi], sLinv[qi]);
        }
        pf[half * 2 + 0] = pack_bf16x2(ph[0], ph[1]);
        pf[half * 2 + 1] = pack_bf16x2(ph[2], ph[3]);
        dsf[half * 2 + 0] = pack_bf16x2(ds[0], ds[1]);
        dsf[half * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
      }
#pragma unroll
      for (int nd = 0; nd < kHeadDim / 8; ++nd) {
        const bf16* vr = sDOLt + (nd * 8 + g) * kPitch + ks * 16 + 2 * t;
        mma_16816(dv[nd], pf, ld32(vr), ld32(vr + 8));
        const bf16* qr = sQt + (nd * 8 + g) * kPitch + ks * 16 + 2 * t;
        mma_16816(dk[nd], dsf, ld32(qr), ld32(qr + 8));
      }
    }
  }

  store_rows(dk, a.dk + offset(a.sdk, b, h), a.sdk.s, key0, S, t);
  store_rows(dv, a.dv + offset(a.sdv, b, h), a.sdv.s, key0, S, t);
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (B, H, S, 64) bf16 at the element strides
// strides[3i .. 3i+2] (batch, head, row) for i = 0..6 in that order, each a
// multiple of 8, bases 16-byte aligned; m, l: (B, H, S) fp32 from
// attention_fwd; delta: (B, H, S) fp32 workspace. All contiguous except
// where strided. Returns the first cudaGetLastError() of the two launches.
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* m, const void* l,
                             void* dq, void* dk, void* dv, void* delta,
                             const long long* strides, int B, int S, int H,
                             int causal, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Operands a{static_cast<const bf16*>(q),    static_cast<const bf16*>(k),
             static_cast<const bf16*>(v),    static_cast<const bf16*>(dout),
             static_cast<bf16*>(dq),         static_cast<bf16*>(dk),
             static_cast<bf16*>(dv),
             {strides[0], strides[1], strides[2]},
             {strides[3], strides[4], strides[5]},
             {strides[6], strides[7], strides[8]},
             {strides[9], strides[10], strides[11]},
             {strides[12], strides[13], strides[14]},
             {strides[15], strides[16], strides[17]},
             {strides[18], strides[19], strides[20]}};
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  unpacked_bwd_dq_kernel<<<grid, kThreads, 0, st>>>(
      a, static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<float*>(delta), S, H, causal);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  unpacked_bwd_dkdv_kernel<<<grid, kThreads, 0, st>>>(
      a, static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), S, H, causal);
  return static_cast<int>(cudaGetLastError());
}
