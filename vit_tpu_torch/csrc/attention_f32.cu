// The fp32 forms of the attention forwards, K1 and K6, for Hopper (sm_90a).
// The backwards' fp32 form (K2, K7/K8) is attention_bwd.cu's kernel pair
// instantiated on three bf16 parts of each operand.
//
// Replace the Pallas forward kernels of vit_tpu/kernels/attention.py when
// they run on fp32 operands, where they take their products at
// Precision.HIGHEST (:95, :646): _fa_packed_kernel (:623, launched by
// _packed_fwd_impl :790) and _fa_kernel (:76, launched by
// _flash_attention_fwd_impl :172). The math is the bf16 kernel's
// (attention_fwd.cu) without its bf16 casts:
//   s = (q kᵀ)/8; m = max s; p = exp(s − m); l = Σ p;
//   o = (D∘p)·v / l, with the saved (m, l) the unmasked ones.
// D is the dropout mask of csrc/dropout.cuh, hashed from (query, key), so
// the fp32 form drops exactly the bf16 form's elements. The 1/8 multiplies
// the fp32 product q·k, which is q/8 · k to the bit (a power of two
// commutes with every rounding of the sum).
//
// One kernel serves both layouts: every operand is a (B, H, S, 64) fp32
// array addressed by its own (batch, head, row) strides, with an optional
// (64-per-head) bias added as a tile is read. The packed projection
// (B, S, 3D) of K1 is three such arrays, q at column 0, k at D and v at 2D,
// strides (S·3D, 64, 3D), with the (3D,) bias in three parts; K6's head
// views pass no bias. m and l are contiguous (B, H, S) fp32 in both
// layouts, where the backward reads them.
//
// Design: a block of 256 threads per (64-row tile, head, batch), the tile
// products in the register-blocked SIMT form of simt_f32.cuh (each thread 4
// rows x 4 columns of a 64 x 64 tile), every tile in shared memory at pitch
// 65. Pass 1 over the key tiles for the exact row max, pass 2 for p
// (written to shared memory), l and P·V, as the bf16 kernel does (66.6 KB
// of shared memory: q, k, v, p). Under the causal mask a q tile stops at
// its own last key.
//
// What bounds it: the products, 4·S²·64 FLOP per (batch, head) (6 with the
// recomputed q·kᵀ), against 4·S·64·4 bytes of q, k, v and output: S/4 FLOP
// per byte, far above the fp32 ridge (≈ 20), so the CUDA cores' FMA rate,
// here at one shared-memory load per two FMAs, is the ceiling. The
// backward's split products on the tensor cores are the way past it.

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

constexpr size_t kFwdSmem = 4 * kTileFloats * sizeof(float);

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
