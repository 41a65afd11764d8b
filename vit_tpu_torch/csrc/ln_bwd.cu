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
//
// Both kernels are templated on the element type (bf16 or fp32), for the
// JAX kernels' fp32 operands: the fp32 forms read and write fp32 with the
// same fp32 arithmetic, 4 values per 16-byte vector in K9b and 4 per lane
// and 128-column step in K9c. Their bound is bytes as well.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"
#include "mma.cuh"
#include "simt_f32.cuh"

namespace {

using namespace vit;

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxC = 1024;

// 16 bytes of T as floats, and back: 8 bf16 or 4 fp32 values.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float (&v)[kVec<T>]) {
  const T* p = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec<T>; ++e) v[e] = to_f(p[e]);
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&v)[kVec<T>]) {
  uint4 out;
  if constexpr (sizeof(T) == 2) {
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = pack_bf16x2(v[2 * e], v[2 * e + 1]);
  } else {
    out = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                     __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
dgelu_kernel(const T* __restrict__ zpre, const T* __restrict__ dz,
             T* __restrict__ dzc, long long n) {
  constexpr int V = kVec<T>;
  const long long nv = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x;
       i < nv; i += stride) {
    float zv[V], dv[V];
    unpack16<T>(reinterpret_cast<const uint4*>(zpre)[i], zv);
    unpack16<T>(reinterpret_cast<const uint4*>(dz)[i], dv);
#pragma unroll
    for (int e = 0; e < V; ++e) dv[e] *= gelu_grad(zv[e]);
    reinterpret_cast<uint4*>(dzc)[i] = pack16<T>(dv);
  }
  if (blockIdx.x == 0)
    for (long long i = nv * V + threadIdx.x; i < n; i += kBlock)
      dzc[i] = from_f<T>(to_f(dz[i]) * gelu_grad(to_f(zpre[i])));
}

// Four neighbouring values of T as floats, and back (8 or 16 bytes).
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  if constexpr (sizeof(T) == 2) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = to_f(e[k]);
  } else {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c,
                                       float d) {
  if constexpr (sizeof(T) == 2) {
    uint2 packed;
    packed.x = pack_bf16x2(a, b);
    packed.y = pack_bf16x2(c, d);
    *reinterpret_cast<uint2*>(p) = packed;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
              T* __restrict__ dx, int N, int C) {
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
      float xe[4], ge[4];
      load4(x + i, xe);
      load4(g + i, ge);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xv[j][e] = xe[e];
        gv[j][e] = ge[e];
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
    if (j < C / 128)
      store4(dx + base + lane * 4 + 128 * j,
             rstd * (gv[j][0] - c1 - xv[j][0] * c2),
             rstd * (gv[j][1] - c1 - xv[j][1] * c2),
             rstd * (gv[j][2] - c1 - xv[j][2] * c2),
             rstd * (gv[j][3] - c1 - xv[j][3] * c2));
  }
}

template <typename T>
int launch_dgelu(const void* zpre, const void* dz, void* dzc, long long n,
                 void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n / kVec<T> + kBlock - 1) / kBlock;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond ~16 waves
  if (blocks < 1) blocks = 1;
  dgelu_kernel<T><<<static_cast<unsigned>(blocks), kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(zpre), static_cast<const T*>(dz),
      static_cast<T*>(dzc), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ln_bwd(const void* x, const void* g, void* dx, int N, int C,
                  void* stream) {
  if (C % 128 || C > kMaxC || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  ln_bwd_kernel<T><<<(N + kWarps - 1) / kWarps, kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      N, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// zpre, dz, dzc: n values each of one type (bf16 for ln_matmul_dgelu, fp32
// for ln_matmul_dgelu_f32), contiguous, 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int ln_matmul_dgelu(const void* zpre, const void* dz, void* dzc,
                               long long n, void* stream) {
  return launch_dgelu<bf16>(zpre, dz, dzc, n, stream);
}

extern "C" int ln_matmul_dgelu_f32(const void* zpre, const void* dz, void* dzc,
                                   long long n, void* stream) {
  return launch_dgelu<float>(zpre, dz, dzc, n, stream);
}

// x, g, dx: (N, C) of one type (bf16 for ln_bwd, 8-byte aligned; fp32 for
// ln_bwd_f32, 16-byte aligned), contiguous; C a multiple of 128 up to 1024
// (cudaErrorInvalidValue otherwise). Returns cudaGetLastError().
extern "C" int ln_bwd(const void* x, const void* g, void* dx, int N, int C,
                      void* stream) {
  return launch_ln_bwd<bf16>(x, g, dx, N, C, stream);
}

extern "C" int ln_bwd_f32(const void* x, const void* g, void* dx, int N, int C,
                          void* stream) {
  return launch_ln_bwd<float>(x, g, dx, N, C, stream);
}
