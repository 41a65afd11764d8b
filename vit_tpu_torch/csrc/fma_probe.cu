// P: the FMA-rate probe, for Hopper (sm_90a).
//
// Replaces the Pallas kernel scripts/bench_vpu.py:_fma_kernel (:32, launched
// by vpu_fma_rate :53 through pl.pallas_call :60), which measured the TPU
// vector unit's fp32 FMA ceiling. Same function: every element x carries
// `chains` independent streams a_i = x + i, each runs `iters` steps of
// a ← a·c + d (c = 1.0000001 and d = 1e-7 in the element type, passed as
// kernel arguments so the compiler cannot fold them), and the output is
// Σ_i a_i, added in order in the element type. fp32 uses fmaf; bf16 uses
// packed __hfma2 on __nv_bfloat162, two elements per thread, each counted as
// one MAC. The accumulators live in registers.
//
// On the H100 it measures the CUDA cores' fp32 (and bf16) FMA issue rate:
// the ceiling of every kernel whose work the tensor cores cannot take (the
// fp32 rows of K9b, K9c, K11, and K5). The TPU's (64, 128)
// single block was one core's vector registers; the function is
// elementwise, so the H100 form's default shape fills the card instead:
// 132 SMs x 2,048 resident threads (64 warps of 32, the SM's limit), one
// element (fp32) or pair (bf16) per thread, 8 blocks of 256 per SM: one
// whole wave, 16 warps per scheduler, enough to cover the 4-cycle FMA
// latency even with one chain. At ≤ 32 registers a thread the register file
// (65,536 per SM) holds all 2,048 threads; the chains (at most 6) are
// template arguments so the accumulators stay registers.
//
// What bounds it: operations only. The bytes (one read and one write per
// element) are negligible beside iters·chains FMAs per element: the bound is
// elements·iters·chains over 132 SMs x 128 FP32 lanes x the clock (x 2 for
// bf16's packed pairs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kBlocksPerSm = 8;   // 2,048 threads: at most 32 registers each

template <int kChains>
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
fma_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
               long long n, int iters, float c, float d) {
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x;
       i < n; i += stride) {
    const float xi = x[i];
    float a[kChains];
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch) a[ch] = xi + static_cast<float>(ch);
#pragma unroll 8
    for (int it = 0; it < iters; ++it)
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch) a[ch] = fmaf(a[ch], c, d);
    float s = a[0];
#pragma unroll
    for (int ch = 1; ch < kChains; ++ch) s = s + a[ch];
    out[i] = s;
  }
}

template <int kChains>
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
fma_bf16_kernel(const __nv_bfloat162* __restrict__ x,
                __nv_bfloat162* __restrict__ out, long long n2, int iters,
                __nv_bfloat16 c, __nv_bfloat16 d) {
  const __nv_bfloat162 c2 = __halves2bfloat162(c, c);
  const __nv_bfloat162 d2 = __halves2bfloat162(d, d);
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x;
       i < n2; i += stride) {
    const __nv_bfloat162 xi = x[i];
    __nv_bfloat162 a[kChains];
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch) {
      const __nv_bfloat16 k = __float2bfloat16(static_cast<float>(ch));
      a[ch] = __hadd2(xi, __halves2bfloat162(k, k));
    }
#pragma unroll 8
    for (int it = 0; it < iters; ++it)
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch) a[ch] = __hfma2(a[ch], c2, d2);
    __nv_bfloat162 s = a[0];
#pragma unroll
    for (int ch = 1; ch < kChains; ++ch) s = __hadd2(s, a[ch]);
    out[i] = s;
  }
}

unsigned grid_for(long long work) {
  long long blocks = (work + kBlock - 1) / kBlock;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond that
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

template <int kChains>
int launch_f32(const void* x, void* out, long long n, int iters, float c,
               float d, cudaStream_t st) {
  fma_f32_kernel<kChains><<<grid_for(n), kBlock, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, iters, c, d);
  return static_cast<int>(cudaGetLastError());
}

template <int kChains>
int launch_bf16(const void* x, void* out, long long n2, int iters,
                __nv_bfloat16 c, __nv_bfloat16 d, cudaStream_t st) {
  fma_bf16_kernel<kChains><<<grid_for(n2), kBlock, 0, st>>>(
      static_cast<const __nv_bfloat162*>(x), static_cast<__nv_bfloat162*>(out),
      n2, iters, c, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: n fp32 values, contiguous. chains in 1..6 (cudaErrorInvalidValue
// otherwise); c and d the step's constants. Returns cudaGetLastError().
extern "C" int fma_chains_f32(const void* x, void* out, long long n, int iters,
                              int chains, float c, float d, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: return launch_f32<1>(x, out, n, iters, c, d, st);
    case 2: return launch_f32<2>(x, out, n, iters, c, d, st);
    case 3: return launch_f32<3>(x, out, n, iters, c, d, st);
    case 4: return launch_f32<4>(x, out, n, iters, c, d, st);
    case 5: return launch_f32<5>(x, out, n, iters, c, d, st);
    case 6: return launch_f32<6>(x, out, n, iters, c, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, out: n bf16 values (n even), contiguous, 4-byte aligned; c and d the
// constants already rounded to bf16, passed as their fp32 values. The rest
// as for fma_chains_f32.
extern "C" int fma_chains_bf16(const void* x, void* out, long long n,
                               int iters, int chains, float c, float d,
                               void* stream) {
  if (n <= 0) return 0;
  if (n % 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16 cb = __float2bfloat16(c), db = __float2bfloat16(d);
  const long long n2 = n / 2;
  switch (chains) {
    case 1: return launch_bf16<1>(x, out, n2, iters, cb, db, st);
    case 2: return launch_bf16<2>(x, out, n2, iters, cb, db, st);
    case 3: return launch_bf16<3>(x, out, n2, iters, cb, db, st);
    case 4: return launch_bf16<4>(x, out, n2, iters, cb, db, st);
    case 5: return launch_bf16<5>(x, out, n2, iters, cb, db, st);
    case 6: return launch_bf16<6>(x, out, n2, iters, cb, db, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
