// K9b and K9c: the two passes of the fused LayerNorm → matmul backward, for
// Hopper (sm_90a).
//
// K9b replaces the Pallas kernel vit_tpu/kernels/ln_matmul.py:_dgelu_kernel
// (:148, launched by _dgelu_impl :166): dzc = bf16(dz · gelu′(zpre)) in fp32,
// the flat derivative of the tanh-composed erf GELU (gelu.cuh) whatever the
// model's GELU setting. K9c replaces _ln_bwd_kernel (:78, launched by
// _ln_bwd_impl :190): for the non-affine LayerNorm,
//   dx = rstd · (g − mean(g) − x̂ · mean(g · x̂)),
// with x̂ and rstd recomputed from x in fp32 (two passes, eps 1e-5).
//
// What bounds them: bytes. K9b reads zpre and dz and writes dzc, 6 bytes per
// element for ~30 FLOP; K9c reads x and g and writes dx, 6 bytes per element
// for ~10 FLOP. Both read and write 16 or 8 bytes a thread with neighbouring
// threads on neighbouring addresses, and keep every intermediate in
// registers: K9b is a grid-stride loop over 8-element vectors; K9c gives each
// row (C ≤ 1024) to one warp, whose lanes hold 4·C/128 values of x and of g
// and reduce Σx, Σ(x − μ)², Σg and Σg·x̂ with shuffles. A ragged tail is
// handled element by element; nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"
#include "mma.cuh"

namespace {

using namespace vit;

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxC = 1024;

__global__ void __launch_bounds__(kBlock)
dgelu_kernel(const bf16* __restrict__ zpre, const bf16* __restrict__ dz,
             bf16* __restrict__ dzc, long long n) {
  const long long n8 = n / 8;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x;
       i < n8; i += stride) {
    const uint4 zr = reinterpret_cast<const uint4*>(zpre)[i];
    const uint4 dr = reinterpret_cast<const uint4*>(dz)[i];
    const bf16* zv = reinterpret_cast<const bf16*>(&zr);
    const bf16* dv = reinterpret_cast<const bf16*>(&dr);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = pack_bf16x2(
          __bfloat162float(dv[2 * e]) * gelu_grad(__bfloat162float(zv[2 * e])),
          __bfloat162float(dv[2 * e + 1]) *
              gelu_grad(__bfloat162float(zv[2 * e + 1])));
    reinterpret_cast<uint4*>(dzc)[i] = out;
  }
  if (blockIdx.x == 0)
    for (long long i = n8 * 8 + threadIdx.x; i < n; i += kBlock)
      dzc[i] = __float2bfloat16(__bfloat162float(dz[i]) *
                                gelu_grad(__bfloat162float(zpre[i])));
}

__global__ void __launch_bounds__(kBlock)
ln_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
              bf16* __restrict__ dx, int N, int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= N) return;
  const size_t base = static_cast<size_t>(row) * C;
  float xv[kMaxC / 128][4], gv[kMaxC / 128][4];
  float sx = 0.0f, sg = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxC / 128; ++j) {
    if (j < C / 128) {
      const size_t i = base + lane * 4 + 128 * j;
      const uint2 xr = *reinterpret_cast<const uint2*>(x + i);
      const uint2 gr = *reinterpret_cast<const uint2*>(g + i);
      const bf16* xp = reinterpret_cast<const bf16*>(&xr);
      const bf16* gp = reinterpret_cast<const bf16*>(&gr);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xv[j][e] = __bfloat162float(xp[e]);
        gv[j][e] = __bfloat162float(gp[e]);
        sx += xv[j][e];
        sg += gv[j][e];
      }
    }
  }
  const float mu = warp_sum(sx) / C;
  const float c1 = warp_sum(sg) / C;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxC / 128; ++j) {
    if (j < C / 128) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xv[j][e] -= mu;
        sq += xv[j][e] * xv[j][e];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / C + 1e-5f);
  float sgx = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxC / 128; ++j) {
    if (j < C / 128) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xv[j][e] *= rstd;  // x̂
        sgx += gv[j][e] * xv[j][e];
      }
    }
  }
  const float c2 = warp_sum(sgx) / C;
#pragma unroll
  for (int j = 0; j < kMaxC / 128; ++j) {
    if (j < C / 128) {
      uint2 packed;
      packed.x = pack_bf16x2(rstd * (gv[j][0] - c1 - xv[j][0] * c2),
                             rstd * (gv[j][1] - c1 - xv[j][1] * c2));
      packed.y = pack_bf16x2(rstd * (gv[j][2] - c1 - xv[j][2] * c2),
                             rstd * (gv[j][3] - c1 - xv[j][3] * c2));
      *reinterpret_cast<uint2*>(dx + base + lane * 4 + 128 * j) = packed;
    }
  }
}

}  // namespace

// zpre, dz, dzc: n bf16 values each, contiguous, 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int ln_matmul_dgelu(const void* zpre, const void* dz, void* dzc,
                               long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n / 8 + kBlock - 1) / kBlock;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond ~16 waves
  if (blocks < 1) blocks = 1;
  dgelu_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(zpre), static_cast<const bf16*>(dz),
      static_cast<bf16*>(dzc), n);
  return static_cast<int>(cudaGetLastError());
}

// x, g, dx: (N, C) bf16, contiguous, 8-byte aligned; C a multiple of 128 up
// to 1024 (cudaErrorInvalidValue otherwise). Returns cudaGetLastError().
extern "C" int ln_bwd(const void* x, const void* g, void* dx, int N, int C,
                      void* stream) {
  if (C % 128 || C > kMaxC || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  ln_bwd_kernel<<<(N + kWarps - 1) / kWarps, kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<bf16*>(dx), N, C);
  return static_cast<int>(cudaGetLastError());
}
