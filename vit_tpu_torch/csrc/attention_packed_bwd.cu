// K2: packed-QKV attention backward for Hopper (sm_90a).
//
// Replaces the Pallas kernel vit_tpu/kernels/attention.py:_fa_packed_bwd_kernel
// (:824), launched by _packed_bwd_impl (:1072). Inputs: the unbiased packed
// projection qkv_nb (B, S, 3D) bf16, the (3D,) bias (bf16, added as each tile
// is read), the upstream gradient dO (B, S, D) bf16 and K1's row statistics m
// and l, fp32 (B, H, S). Outputs: dqkv (B, S, 3D) bf16, written straight into
// the packed layout, and the bias gradient (3D,) fp32, the column sums of the
// fp32 dq, dk and dv before their bf16 cast (:986-1011, :1091).
//
// The math of :888-952, with p rebuilt from the saved statistics:
//   ph = exp(s - m) unnormalised, linv = 1/l, s = (q/8)·kᵀ;
//   dv = bf16(ph)ᵀ · bf16(dO·linv);   dp = dO · vᵀ;   Δ = Σ_keys ph·dp;
//   ds = bf16(ph · ((dp - Δ·linv) · (linv/8)));
//   dq = ds · k,  dk = dsᵀ · q  (the unscaled q).
// Products are bf16 in, fp32 accumulate; ph, dp, Δ and ds are fp32 until ds's
// cast, as on the TPU.
//
// Dropout (kDropout, with the forward's seed vector): each pass that needs
// the mask D of csrc/dropout.cuh hashes it again (:916-942): dp is multiplied
// by D before Δ sums it and before ds takes it, and dv takes bf16(D·ph). The
// dk/dv kernel walks key tiles with the queries inside, so its score tile is
// transposed, but it hashes (row = query, column = key), the forward's pair.
//
// The Hopper problem: blocks run in parallel with no carried state, and dq
// sums over keys while dk and dv sum over queries. The TPU kernel holds the
// whole sequence of one head pair in VMEM; here that would not fit for S up
// to 768. So the work splits into two kernels over 64-row tiles, each
// accumulating its own output in registers, with no atomics:
//   1. dq kernel, one block per (q tile, head, batch): pass 1 over the keys
//      sums Δ for its rows (and stores it, fp32 (B, H, S)); pass 2 rebuilds ds
//      and accumulates dq = ds · k.
//   2. dk/dv kernel, one block per (key tile, head, batch): loops over the q
//      tiles, rebuilding sᵀ = k·qᵀ and dpᵀ = v·dOᵀ in the transposed
//      orientation, so that phᵀ and dsᵀ come out of the accumulators directly
//      in the A-fragment layout of dv += phᵀ·dol and dk += dsᵀ·q.
// Each block writes the column sums of its fp32 tile into a per-tile partial
// row (B·nT, 3D); a third small kernel sums the partials in a fixed order, so
// the bias gradient is the same from run to run.
//
// What bounds it: the minimal backward is 5 products of 2·S²·64 FLOP per
// (batch, head); this design spends 9 (q·kᵀ three times, dO·vᵀ three times)
// for the freedom from atomics and from a sequence-sized shared memory: at
// S = 320 that is ~0.12 GFLOP per (batch, head) against ~0.3 MB of q, k, v,
// dO and dqkv, far past the bf16 ridge, so the tensor-core issue rate and
// the fp32 elementwise work between the products bound it. mma.sync m16n8k16 as in K1;
// wgmma, TMA and a fused single-pass dk/dv/dq are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "dropout.cuh"

namespace {

using namespace vit;

// Column sums of a warp's 16 x 64 fp32 accumulator (rows g and g + 8 of each
// thread), reduced over the four warps in shared memory and written to
// out[0..64). Every thread of the block must call it.
__device__ __forceinline__ void column_sums(const float (&acc)[kHeadDim / 8][4],
                                            float (*red)[kHeadDim], float* out,
                                            int warp, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = acc[nt][j] + acc[nt][2 + j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[warp][nt * 8 + 2 * t + j] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < kHeadDim) {
    const int c = threadIdx.x;
    out[c] = ((red[0][c] + red[1][c]) + red[2][c]) + red[3][c];
  }
  __syncthreads();
}

template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const bf16* __restrict__ qkv,
                        const bf16* __restrict__ bias,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ m_in,
                        const float* __restrict__ l_in,
                        bf16* __restrict__ dqkv, float* __restrict__ delta_out,
                        float* __restrict__ part, Dropout drop, int S, int H,
                        int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kPitch];     // q / 8
  __shared__ __align__(16) bf16 sDO[kTile * kPitch];    // dO
  __shared__ __align__(16) bf16 sK[kTile * kPitch];     // k, [key][d]
  __shared__ __align__(16) bf16 sKt[kHeadDim * kPitch]; // k, [d][key]
  __shared__ __align__(16) bf16 sV[kTile * kPitch];     // v, [key][d]
  __shared__ float red[4][kHeadDim];

  const int n_tiles = gridDim.x;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * kHeadDim;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * S * row_stride;
  const bf16* dbase = dout + static_cast<size_t>(b) * S * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  load_tile<false>(sQ, base + q0 * row_stride + h * kHeadDim,
                   bias + h * kHeadDim, S - q0, row_stride, kScale);
  load_tile<false, false>(sDO,
                          dbase + static_cast<size_t>(q0) * D + h * kHeadDim,
                          nullptr, S - q0, D, 1.0f);
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
  DropoutStream drs{};
  if constexpr (kDropout) drs = dropout_stream(drop, b * H + h);

  // Pass 1: Δ = Σ_keys ph·(D·dp) for this thread's two rows.
  float delta[2] = {0.0f, 0.0f};
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    load_tile<false>(sK, base + k0 * row_stride + D + h * kHeadDim,
                     bias + D + h * kHeadDim, S - k0, row_stride, 1.0f);
    load_tile<false>(sV, base + k0 * row_stride + 2 * D + h * kHeadDim,
                     bias + 2 * D + h * kHeadDim, S - k0, row_stride, 1.0f);
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
        float dpd = dp[e];
        if constexpr (kDropout) dpd *= dropout_keep(drs, row, col, S);
        delta[e >> 1] += expf(s[e] - mr[e >> 1]) * dpd;
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
    load_tile<false>(sK, base + k0 * row_stride + D + h * kHeadDim,
                     bias + D + h * kHeadDim, S - k0, row_stride, 1.0f);
    load_tile<true>(sKt, base + k0 * row_stride + D + h * kHeadDim,
                    bias + D + h * kHeadDim, S - k0, row_stride, 1.0f);
    load_tile<false>(sV, base + k0 * row_stride + 2 * D + h * kHeadDim,
                     bias + 2 * D + h * kHeadDim, S - k0, row_stride, 1.0f);
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
          float dpd = dp[e];
          if constexpr (kDropout)
            if (!masked) dpd *= dropout_keep(drs, row0 + r * 8, col, S);
          ds[e] = dscore(ph, dpd, delta[r], linv[r]);
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

  store_rows(dq, dqkv + static_cast<size_t>(b) * S * row_stride + h * kHeadDim,
             row_stride, row0, S, t);
  column_sums(dq, red,
              part + (static_cast<size_t>(b) * n_tiles + blockIdx.x) *
                         row_stride + h * kHeadDim,
              warp, lane);
}

template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const bf16* __restrict__ qkv,
                          const bf16* __restrict__ bias,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ m_in,
                          const float* __restrict__ l_in,
                          const float* __restrict__ delta_in,
                          bf16* __restrict__ dqkv, float* __restrict__ part,
                          Dropout drop, int S, int H, int causal) {
  __shared__ __align__(16) bf16 sA[kTile * kPitch];       // k, then q / 8
  __shared__ __align__(16) bf16 sB[kTile * kPitch];       // v, then dO
  __shared__ __align__(16) bf16 sQt[kHeadDim * kPitch];   // q, [d][q]
  __shared__ __align__(16) bf16 sDOLt[kHeadDim * kPitch]; // bf16(dO·linv), [d][q]
  __shared__ float sM[kTile], sLinv[kTile], sDelta[kTile];
  __shared__ float red[4][kHeadDim];

  const int n_tiles = gridDim.x;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * kHeadDim;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * S * row_stride;
  const bf16* dbase = dout + static_cast<size_t>(b) * S * D;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  // This warp's 16 keys of k and v as A fragments, kept for the whole loop.
  load_tile<false>(sA, base + k0 * row_stride + D + h * kHeadDim,
                   bias + D + h * kHeadDim, S - k0, row_stride, 1.0f);
  load_tile<false>(sB, base + k0 * row_stride + 2 * D + h * kHeadDim,
                   bias + 2 * D + h * kHeadDim, S - k0, row_stride, 1.0f);
  __syncthreads();
  uint32_t kf[kHeadDim / 16][4], vf[kHeadDim / 16][4];
  load_a_rows(kf, sA + warp * 16 * kPitch, g, t);
  load_a_rows(vf, sB + warp * 16 * kPitch, g, t);
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  DropoutStream drs{};
  if constexpr (kDropout) drs = dropout_stream(drop, b * H + h);

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
    load_tile<false>(sA, base + q0 * row_stride + h * kHeadDim,
                     bias + h * kHeadDim, S - q0, row_stride, kScale);
    load_tile<true>(sQt, base + q0 * row_stride + h * kHeadDim,
                    bias + h * kHeadDim, S - q0, row_stride, 1.0f);
    load_tile<false, false>(
        sB, dbase + static_cast<size_t>(q0) * D + h * kHeadDim, nullptr,
        S - q0, D, 1.0f);
    load_tile<true, false, true>(
        sDOLt, dbase + static_cast<size_t>(q0) * D + h * kHeadDim, nullptr,
        S - q0, D, 1.0f, sLinv);
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
        float ph[4], pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + 2 * t + (e & 1);
          const int q = q0 + qi;
          const int key = key0 + (e >> 1) * 8;
          const bool masked = key >= S || q >= S || (causal && key > q);
          ph[e] = masked ? 0.0f : expf(st[e] - sM[qi]);
          pd[e] = ph[e];
          float dpd = dpt[e];
          if constexpr (kDropout) {
            if (!masked) {  // the forward's (query, key) pair, not (key, query)
              const float dm = dropout_keep(drs, q, key, S);
              pd[e] *= dm;
              dpd *= dm;
            }
          }
          ds[e] = dscore(ph[e], dpd, sDelta[qi], sLinv[qi]);
        }
        pf[half * 2 + 0] = pack_bf16x2(pd[0], pd[1]);
        pf[half * 2 + 1] = pack_bf16x2(pd[2], pd[3]);
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

  bf16* out = dqkv + static_cast<size_t>(b) * S * row_stride + h * kHeadDim;
  store_rows(dk, out + D, row_stride, key0, S, t);
  store_rows(dv, out + 2 * D, row_stride, key0, S, t);
  float* prow = part + (static_cast<size_t>(b) * n_tiles + blockIdx.x) *
                           row_stride + h * kHeadDim;
  column_sums(dk, red, prow + D, warp, lane);
  column_sums(dv, red, prow + 2 * D, warp, lane);
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

}  // namespace

// qkv: (B, S, 3·H·64) bf16; bias: (3·H·64,) bf16; dout: (B, S, H·64) bf16;
// m, l: (B, H, S) fp32 from attention_packed_fwd; dqkv: (B, S, 3·H·64) bf16;
// dbias: (3·H·64,) fp32. Workspace: delta (B, H, S) fp32 and part
// (B·⌈S/64⌉, 3·H·64) fp32. All contiguous and 16-byte aligned. seed: the
// forward's (2,) int32 [seed, offset] with its `threshold` and `scale`, or
// null for no dropout. Returns the first cudaGetLastError() of the three
// launches.
extern "C" int attention_packed_bwd(const void* qkv, const void* bias,
                                    const void* dout, const void* m,
                                    const void* l, void* dqkv, void* dbias,
                                    void* delta, void* part, const void* seed,
                                    int B, int S, int H, int causal,
                                    unsigned int threshold, float scale,
                                    void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (S + kTile - 1) / kTile;
  const dim3 grid(n_tiles, H, B);
  const Dropout drop{static_cast<const int*>(seed), threshold, scale};
  auto dq_kernel = seed != nullptr ? &attention_bwd_dq_kernel<true>
                                   : &attention_bwd_dq_kernel<false>;
  auto dkdv_kernel = seed != nullptr ? &attention_bwd_dkdv_kernel<true>
                                     : &attention_bwd_dkdv_kernel<false>;
  dq_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<bf16*>(dqkv),
      static_cast<float*>(delta), static_cast<float*>(part), drop, S, H,
      causal);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dkdv_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(delta),
      static_cast<bf16*>(dqkv), static_cast<float*>(part), drop, S, H,
      causal);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int cols = 3 * H * kHeadDim;
  column_total_kernel<<<(cols + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), B * n_tiles,
      cols);
  return static_cast<int>(cudaGetLastError());
}
