// The fp32 forms of the attention kernels, K1, K2, K6 and K7/K8, for Hopper
// (sm_90a).
//
// Replace the Pallas kernels of vit_tpu/kernels/attention.py when they run
// on fp32 operands, where they take their products at Precision.HIGHEST
// (:95, :228, :310, :646, :851): _fa_packed_kernel (:623, launched by
// _packed_fwd_impl :790) and _fa_kernel (:76, launched by
// _flash_attention_fwd_impl :172) forward; _fa_packed_bwd_kernel (:824,
// launched by _packed_bwd_impl :1072), _fa_bwd_kernel (:201, launched at
// :441) and _fa_bwd_tiled_kernel (:284, launched at :395) backward. The math
// is the bf16 kernels' (attention_packed_fwd.cu, attention_bwd.cu) without
// their bf16 casts:
//   forward:  s = (q kᵀ)/8; m = max s; p = exp(s − m); l = Σ p;
//             o = (D∘p)·v / l, with the saved (m, l) the unmasked ones;
//   backward: ph = exp(s − m); dv = (D∘ph)ᵀ·(dO/l); dp = D∘(dO·vᵀ);
//             Δ = Σ ph·dp; ds = ph·((dp − Δ/l)·(1/(8l))); dq = ds·k, dk = dsᵀ·q.
// D is the dropout mask of csrc/dropout.cuh, hashed from (query, key) in
// every pass, so the fp32 forms drop exactly the bf16 forms' elements. The
// 1/8 multiplies the fp32 product q·k, which is q/8 · k to the bit (a power
// of two commutes with every rounding of the sum).
//
// One kernel of each kind serves both layouts: every operand is a
// (B, H, S, 64) fp32 array addressed by its own (batch, head, row) strides,
// with an optional (64-per-head) bias added as a tile is read. The packed
// projection (B, S, 3D) of K1/K2 is three such arrays, q at column 0, k at
// D and v at 2D, strides (S·3D, 64, 3D), with the (3D,) bias in three
// parts; K6-K8's head views pass no bias. m and l are contiguous (B, H, S)
// fp32 in both layouts, written by the forward where the backward reads
// them. With a bias, the backward also writes the bias gradient: each block
// adds the columns of its fp32 dq (dk, dv) tile into a partial row of a
// (B·⌈S/64⌉, 3D) scratch, and a third kernel adds those rows in order, so
// the sum is the same in every run.
//
// Design: a block of 256 threads per (64-row tile, head, batch), the tile
// products in the register-blocked SIMT form of simt_f32.cuh (each thread 4
// rows x 4 columns of a 64 x 64 tile), every tile in shared memory at pitch
// 65. Forward, one block per q tile: pass 1 over the key tiles for the
// exact row max, pass 2 for p (written to shared memory), l and P·V, as the
// bf16 kernels do (66.6 KB of shared memory: q, k, v, p). Backward: a dq
// kernel per q tile (pass 1 sums Δ and stores it, pass 2 forms ds and
// dq += ds·k; 83.2 KB) and a dk/dv kernel per key tile that walks the q
// tiles with phᵀ and dsᵀ formed in the transposed orientation (116.5 KB),
// so nothing needs atomics. Under the causal mask a q tile stops at its own
// last key and a key tile starts at its own first query.
//
// What bounds them: the products, 4·S²·64 FLOP per (batch, head) forward
// (6 with the recomputed q·kᵀ) and 10 backward (18 as computed), against
// 4·S·64·4 bytes of q, k, v and output: S/4 FLOP per byte, far above the
// fp32 ridge (≈ 20), so the CUDA cores' FMA rate, here at one shared-memory
// load per two FMAs, is the ceiling. A larger register block per thread,
// vectorised shared loads and a one-pass online softmax are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "dropout.cuh"
#include "simt_f32.cuh"

namespace {

using namespace vit;

constexpr int kP = kHeadDim + 1;          // 65: pitch of every fp32 tile
constexpr int kTileFloats = kTile * kP;
constexpr int kTM = kTile / kSimtSide;    // 4 rows of a tile per thread
constexpr int kTN = kHeadDim / kSimtSide; // 4 columns (keys or d) per thread

// Rows [0, 64) of one head's (·, 64) operand at g, rows `stride` elements
// apart, into sm (pitch kP), plus the head's bias (64 values) when given;
// rows at or past `valid` become zeros.
__device__ __forceinline__ void load_head_tile(float* sm, const float* g,
                                               long long stride,
                                               const float* bias, int valid) {
  for (int i = threadIdx.x; i < kTile * kHeadDim; i += kSimtThreads) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    float v = 0.0f;
    if (r < valid) {
      v = g[r * stride + c];
      if (bias != nullptr) v += bias[c];
    }
    sm[r * kP + c] = v;
  }
}

__device__ __forceinline__ bool masked(int row, int col, int S, int causal) {
  return row >= S || col >= S || (causal && col > row);
}

// Column sums of a block's 64 x 64 fp32 accumulator (rows ty + 16i, columns
// tx + 16j), in a fixed order: each thread's 4 rows, then the 16 row groups
// through shared memory `red` (16 x 64 floats). Every thread calls it.
__device__ __forceinline__ void column_sums(const float (&acc)[kTM][kTN],
                                            float* red, float* out) {
  const int ty = simt_ty(), tx = simt_tx();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) v += acc[i][j];
    red[ty * kHeadDim + tx + 16 * j] = v;
  }
  __syncthreads();
  if (threadIdx.x < kHeadDim) {
    float v = 0.0f;
    for (int r = 0; r < kSimtSide; ++r) v += red[r * kHeadDim + threadIdx.x];
    out[threadIdx.x] = v;
  }
  __syncthreads();
}

// acc's rows below S to dst + row·stride + column.
__device__ __forceinline__ void store_tile(const float (&acc)[kTM][kTN],
                                           float* dst, long long stride,
                                           int row0, int S) {
  const int ty = simt_ty(), tx = simt_tx();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) dst[row * stride + tx + 16 * j] = acc[i][j];
  }
}

struct Heads {   // one operand: base pointer, strides, optional (3D,) bias part
  const float* p;
  Strides st;
  const float* bias;
  __device__ const float* at(int b, int h) const { return p + offset(st, b, h); }
  __device__ const float* bias_of(int h) const {
    return bias == nullptr ? nullptr : bias + h * kHeadDim;
  }
};

template <bool kDropout>
__global__ void __launch_bounds__(kSimtThreads)
attention_f32_fwd_kernel(Heads q, Heads k, Heads v, float* __restrict__ out,
                         Strides so, float* __restrict__ m_out,
                         float* __restrict__ l_out, Dropout drop, int S, int H,
                         int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTileFloats;
  float* sV = sK + kTileFloats;
  float* sP = sV + kTileFloats;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = simt_ty(), tx = simt_tx();
  const float* kb = k.at(b, h);
  const float* vb = v.at(b, h);
  load_head_tile(sQ, q.at(b, h) + q0 * q.st.s, q.st.s, q.bias_of(h), S - q0);
  const int kv_end = causal ? min(S, q0 + kTile) : S;

  // Pass 1: the exact row max, so p is formed against it as in the bf16
  // kernels and the plain version.
  float m[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) m[i] = -INFINITY;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    load_head_tile(sK, kb + k0 * k.st.s, k.st.s, k.bias_of(h), S - k0);
    __syncthreads();
    float s[kTM][kTN];
    simt_zero(s);
    simt_product<kTM, kTN, false, true>(s, sQ, kP, sK, kP, kHeadDim);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int row = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
        if (col < S && !(causal && col > row)) m[i] = fmaxf(m[i], s[i][j] * kScale);
      }
  }
  // Key 0 is valid for every row, so m is finite.
#pragma unroll
  for (int i = 0; i < kTM; ++i) m[i] = row_max16(m[i]);

  // Pass 2: p = exp(s − m), summed into l before the mask, then D∘p · v.
  DropoutStream drs{};
  if constexpr (kDropout) drs = dropout_stream(drop, b * H + h);
  float o[kTM][kTN], l[kTM];
  simt_zero(o);
#pragma unroll
  for (int i = 0; i < kTM; ++i) l[i] = 0.0f;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    load_head_tile(sK, kb + k0 * k.st.s, k.st.s, k.bias_of(h), S - k0);
    load_head_tile(sV, vb + k0 * v.st.s, v.st.s, v.bias_of(h), S - k0);
    __syncthreads();
    float s[kTM][kTN];
    simt_zero(s);
    simt_product<kTM, kTN, false, true>(s, sQ, kP, sK, kP, kHeadDim);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int row = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
        float p = 0.0f;
        if (col < S && !(causal && col > row)) {
          p = expf(s[i][j] * kScale - m[i]);
          l[i] += p;
          if constexpr (kDropout) p *= dropout_keep(drs, row, col, S);
        }
        sP[(ty + 16 * i) * kP + tx + 16 * j] = p;
      }
    __syncthreads();
    simt_product<kTM, kTN, false, false>(o, sP, kP, sV, kP, kTile);
  }

  float* ob = out + offset(so, b, h);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    l[i] = row_sum16(l[i]);
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) ob[row * so.s + tx + 16 * j] = o[i][j] / l[i];
    if (m_out != nullptr && tx == 0) {
      const size_t idx = (static_cast<size_t>(b) * H + h) * S + row;
      m_out[idx] = m[i];
      l_out[idx] = l[i];
    }
  }
}

// The backward's shared arguments.
struct Bwd {
  Heads q, k, v, dout;
  const float* m;
  const float* l;
  float* delta;
  float *dq, *dk, *dv;
  Strides sdq, sdk, sdv;
  float* part;   // (B·nT, part_ld) bias-gradient partials, or null
  int part_ld;
  Dropout drop;
  int S, H, causal;
};

template <bool kDropout>
__global__ void __launch_bounds__(kSimtThreads)
attention_f32_bwd_dq_kernel(Bwd a) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTileFloats;
  float* sK = sDO + kTileFloats;
  float* sV = sK + kTileFloats;
  float* sDS = sV + kTileFloats;

  const int S = a.S, H = a.H, causal = a.causal;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = simt_ty(), tx = simt_tx();
  const float* kb = a.k.at(b, h);
  const float* vb = a.v.at(b, h);
  load_head_tile(sQ, a.q.at(b, h) + q0 * a.q.st.s, a.q.st.s, a.q.bias_of(h),
                 S - q0);
  load_head_tile(sDO, a.dout.at(b, h) + q0 * a.dout.st.s, a.dout.st.s,
                 nullptr, S - q0);
  // Padded rows: m = 0, 1/l = 1 and dO = 0, so dp, Δ and ds vanish there.
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;
  float mr[kTM], linv[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty + 16 * i;
    mr[i] = row < S ? a.m[stat0 + row] : 0.0f;
    linv[i] = row < S ? 1.0f / a.l[stat0 + row] : 1.0f;
  }
  const int kv_end = causal ? min(S, q0 + kTile) : S;
  DropoutStream drs{};
  if constexpr (kDropout) drs = dropout_stream(a.drop, b * H + h);

  // Pass 1: Δ = Σ_keys ph·(D∘dp).
  float delta[kTM] = {};
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    load_head_tile(sK, kb + k0 * a.k.st.s, a.k.st.s, a.k.bias_of(h), S - k0);
    load_head_tile(sV, vb + k0 * a.v.st.s, a.v.st.s, a.v.bias_of(h), S - k0);
    __syncthreads();
    float s[kTM][kTN], dp[kTM][kTN];
    simt_zero(s);
    simt_zero(dp);
    simt_product<kTM, kTN, false, true>(s, sQ, kP, sK, kP, kHeadDim);
    simt_product<kTM, kTN, false, true>(dp, sDO, kP, sV, kP, kHeadDim);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int row = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
        if (masked(row, col, S, causal)) continue;
        float dpd = dp[i][j];
        if constexpr (kDropout) dpd *= dropout_keep(drs, row, col, S);
        delta[i] += expf(s[i][j] * kScale - mr[i]) * dpd;
      }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    delta[i] = row_sum16(delta[i]);
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < S) a.delta[stat0 + row] = delta[i];
  }

  // Pass 2: ds into shared memory, then dq += ds · k.
  float dq[kTM][kTN];
  simt_zero(dq);
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    load_head_tile(sK, kb + k0 * a.k.st.s, a.k.st.s, a.k.bias_of(h), S - k0);
    load_head_tile(sV, vb + k0 * a.v.st.s, a.v.st.s, a.v.bias_of(h), S - k0);
    __syncthreads();
    float s[kTM][kTN], dp[kTM][kTN];
    simt_zero(s);
    simt_zero(dp);
    simt_product<kTM, kTN, false, true>(s, sQ, kP, sK, kP, kHeadDim);
    simt_product<kTM, kTN, false, true>(dp, sDO, kP, sV, kP, kHeadDim);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int row = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
        float ds = 0.0f;
        if (!masked(row, col, S, causal)) {
          const float ph = expf(s[i][j] * kScale - mr[i]);
          float dpd = dp[i][j];
          if constexpr (kDropout) dpd *= dropout_keep(drs, row, col, S);
          ds = dscore(ph, dpd, delta[i], linv[i]);
        }
        sDS[(ty + 16 * i) * kP + tx + 16 * j] = ds;
      }
    __syncthreads();
    simt_product<kTM, kTN, false, false>(dq, sDS, kP, sK, kP, kTile);
  }

  store_tile(dq, a.dq + offset(a.sdq, b, h), a.sdq.s, q0, S);
  if (a.part != nullptr)
    column_sums(dq, sDS,
                a.part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) *
                             a.part_ld + h * kHeadDim);
}

template <bool kDropout>
__global__ void __launch_bounds__(kSimtThreads)
attention_f32_bwd_dkdv_kernel(Bwd a) {
  extern __shared__ float smem[];
  float* sK = smem;                    // this block's keys
  float* sV = sK + kTileFloats;
  float* sQ = sV + kTileFloats;        // the current q tile (unscaled)
  float* sDO = sQ + kTileFloats;
  float* sDOL = sDO + kTileFloats;     // dO / l
  float* sPt = sDOL + kTileFloats;     // (D∘ph)ᵀ, [key][query]
  float* sDSt = sPt + kTileFloats;     // dsᵀ, [key][query]
  float* sM = sDSt + kTileFloats;
  float* sLinv = sM + kTile;
  float* sDelta = sLinv + kTile;

  const int S = a.S, H = a.H, causal = a.causal;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ty = simt_ty(), tx = simt_tx();
  const float* qb = a.q.at(b, h);
  const float* dob = a.dout.at(b, h);
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;
  load_head_tile(sK, a.k.at(b, h) + k0 * a.k.st.s, a.k.st.s, a.k.bias_of(h),
                 S - k0);
  load_head_tile(sV, a.v.at(b, h) + k0 * a.v.st.s, a.v.st.s, a.v.bias_of(h),
                 S - k0);
  DropoutStream drs{};
  if constexpr (kDropout) drs = dropout_stream(a.drop, b * H + h);

  float dk[kTM][kTN], dv[kTM][kTN];
  simt_zero(dk);
  simt_zero(dv);
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += kTile) {
    __syncthreads();   // every thread is done with the previous q tile
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool valid = row < S;
      sM[threadIdx.x] = valid ? a.m[stat0 + row] : 0.0f;
      sLinv[threadIdx.x] = valid ? 1.0f / a.l[stat0 + row] : 1.0f;
      sDelta[threadIdx.x] = valid ? a.delta[stat0 + row] : 0.0f;
    }
    load_head_tile(sQ, qb + q0 * a.q.st.s, a.q.st.s, a.q.bias_of(h), S - q0);
    load_head_tile(sDO, dob + q0 * a.dout.st.s, a.dout.st.s, nullptr, S - q0);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kHeadDim; i += kSimtThreads) {
      const int r = i / kHeadDim, c = i % kHeadDim;
      sDOL[r * kP + c] = sDO[r * kP + c] * sLinv[r];
    }
    // sᵀ = k·qᵀ and dpᵀ = v·dOᵀ: rows keys, columns queries.
    float st[kTM][kTN], dpt[kTM][kTN];
    simt_zero(st);
    simt_zero(dpt);
    simt_product<kTM, kTN, false, true>(st, sK, kP, sQ, kP, kHeadDim);
    simt_product<kTM, kTN, false, true>(dpt, sV, kP, sDO, kP, kHeadDim);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int key = k0 + ty + 16 * i, qi = tx + 16 * j, q = q0 + qi;
        float pd = 0.0f, ds = 0.0f;
        if (!(key >= S || q >= S || (causal && key > q))) {
          const float ph = expf(st[i][j] * kScale - sM[qi]);
          float dpd = dpt[i][j];
          pd = ph;
          if constexpr (kDropout) {  // the forward's (query, key) pair
            const float dm = dropout_keep(drs, q, key, S);
            pd *= dm;
            dpd *= dm;
          }
          ds = dscore(ph, dpd, sDelta[qi], sLinv[qi]);
        }
        sPt[(ty + 16 * i) * kP + qi] = pd;
        sDSt[(ty + 16 * i) * kP + qi] = ds;
      }
    __syncthreads();
    simt_product<kTM, kTN, false, false>(dv, sPt, kP, sDOL, kP, kTile);
    simt_product<kTM, kTN, false, false>(dk, sDSt, kP, sQ, kP, kTile);
  }

  store_tile(dk, a.dk + offset(a.sdk, b, h), a.sdk.s, k0, S);
  store_tile(dv, a.dv + offset(a.sdv, b, h), a.sdv.s, k0, S);
  if (a.part != nullptr) {
    const int D = H * kHeadDim;
    float* prow = a.part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) *
                               a.part_ld + h * kHeadDim;
    column_sums(dk, sPt, prow + D);
    column_sums(dv, sPt, prow + 2 * D);
  }
}

// out[c] = Σ_r part[r][c], rows in order: the same sum in every run.
__global__ void column_total_f32_kernel(const float* __restrict__ part,
                                        float* __restrict__ out, int rows,
                                        int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float acc = 0.0f;
  for (int r = 0; r < rows; ++r) acc += part[static_cast<size_t>(r) * cols + c];
  out[c] = acc;
}

constexpr size_t kFwdSmem = 4 * kTileFloats * sizeof(float);
constexpr size_t kDqSmem = 5 * kTileFloats * sizeof(float);
constexpr size_t kDkdvSmem = (7 * kTileFloats + 3 * kTile) * sizeof(float);

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

Strides strides_at(const long long* s, int i) {
  return {s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

// q, k, v, out: (B, H, S, 64) fp32 at the element strides strides[0..2] (q),
// [3..5] (k), [6..8] (v), [9..11] (out), each (batch, head, row), unit
// stride along head_dim. bq, bk, bv: each head's 64 bias values at
// b + h·64, added to q, k and v as they are read, or null. m, l: (B, H, S)
// fp32, or both null for no stats. seed: (2,) int32 [seed, offset] on the
// device with `threshold` and `scale` (csrc/dropout.cuh), or null for no
// dropout. Returns cudaGetLastError() after the launch.
extern "C" int attention_f32_fwd(const void* q, const void* k, const void* v,
                                 const void* bq, const void* bk, const void* bv,
                                 void* out, void* m, void* l, const void* seed,
                                 const long long* strides, int B, int S, int H,
                                 int causal, unsigned int threshold,
                                 float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  auto kernel = seed != nullptr ? &attention_f32_fwd_kernel<true>
                                : &attention_f32_fwd_kernel<false>;
  const int err = allow_smem(kernel, kFwdSmem);
  if (err) return err;
  const Heads hq{static_cast<const float*>(q), strides_at(strides, 0),
                 static_cast<const float*>(bq)};
  const Heads hk{static_cast<const float*>(k), strides_at(strides, 1),
                 static_cast<const float*>(bk)};
  const Heads hv{static_cast<const float*>(v), strides_at(strides, 2),
                 static_cast<const float*>(bv)};
  const Dropout drop{static_cast<const int*>(seed), threshold, scale};
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, kSimtThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      hq, hk, hv, static_cast<float*>(out), strides_at(strides, 3),
      static_cast<float*>(m), static_cast<float*>(l), drop, S, H, causal);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v, dout, dq, dk, dv: (B, H, S, 64) fp32 at the element strides
// strides[3i .. 3i+2] (batch, head, row) for i = 0..6 in that order; bq, bk,
// bv as for attention_f32_fwd; m, l: the forward's (B, H, S) fp32; delta:
// (B, H, S) fp32 scratch. With part (B·⌈S/64⌉, 3·H·64) fp32 scratch and
// dbias (3·H·64,) fp32 non-null, also the bias gradient: the column sums of
// dq, dk and dv at columns h·64, D + h·64 and 2D + h·64 (the packed layout).
// seed as for the forward. Returns the first cudaGetLastError() of the
// launches.
extern "C" int attention_f32_bwd(const void* q, const void* k, const void* v,
                                 const void* bq, const void* bk, const void* bv,
                                 const void* dout, const void* m, const void* l,
                                 void* dq, void* dk, void* dv, void* delta,
                                 void* part, void* dbias, const void* seed,
                                 const long long* strides, int B, int S, int H,
                                 int causal, unsigned int threshold,
                                 float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto dq_kernel = seed != nullptr ? &attention_f32_bwd_dq_kernel<true>
                                   : &attention_f32_bwd_dq_kernel<false>;
  auto dkdv_kernel = seed != nullptr ? &attention_f32_bwd_dkdv_kernel<true>
                                     : &attention_f32_bwd_dkdv_kernel<false>;
  int err = allow_smem(dq_kernel, kDqSmem);
  if (err) return err;
  err = allow_smem(dkdv_kernel, kDkdvSmem);
  if (err) return err;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int cols = 3 * H * kHeadDim;
  Bwd a{};
  a.q = {static_cast<const float*>(q), strides_at(strides, 0),
         static_cast<const float*>(bq)};
  a.k = {static_cast<const float*>(k), strides_at(strides, 1),
         static_cast<const float*>(bk)};
  a.v = {static_cast<const float*>(v), strides_at(strides, 2),
         static_cast<const float*>(bv)};
  a.dout = {static_cast<const float*>(dout), strides_at(strides, 3), nullptr};
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.sdq = strides_at(strides, 4);
  a.sdk = strides_at(strides, 5);
  a.sdv = strides_at(strides, 6);
  a.part = dbias != nullptr ? static_cast<float*>(part) : nullptr;
  a.part_ld = cols;
  a.drop = {static_cast<const int*>(seed), threshold, scale};
  a.S = S;
  a.H = H;
  a.causal = causal;
  const dim3 grid(n_tiles, H, B);
  dq_kernel<<<grid, kSimtThreads, kDqSmem, st>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dkdv_kernel<<<grid, kSimtThreads, kDkdvSmem, st>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err || a.part == nullptr) return err;
  column_total_f32_kernel<<<(cols + 255) / 256, 256, 0, st>>>(
      a.part, static_cast<float*>(dbias), B * n_tiles, cols);
  return static_cast<int>(cudaGetLastError());
}
