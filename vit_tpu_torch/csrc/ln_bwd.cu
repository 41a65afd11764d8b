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
// (12 in fp32) for ~10 FLOP. K9b is a grid-stride loop over 16-byte
// vectors. K9c gives each row to a warp, 4 warps a block, and keeps the
// memory busy while rows reduce:
// - one kernel per width (C a multiple of 128 up to 1024, a template
//   parameter), so each lane holds exactly its C/32 values of x and of g
//   and starts all its loads at once;
// - 16-byte loads and stores (st.global.cs) a lane, 8 bf16 or 4 fp32
//   values (bf16 rows of 128, 384, 640 or 896 end with an 8-byte step);
//   nothing is padded;
// - two rounds of paired warp sums, (Σx, Σg) and then (Σd², Σg·d) with
//   d = x − μ, whose shuffles interleave; c2 = rstd·Σg·d/C.
// On an H100, persistent warps that walk rows came out no faster in either
// row type, whether the next row's loads sat in registers while one
// reduced (a second fp32 row in registers cuts the warps an SM holds) or a
// ring of rows sat in shared memory, fed by 1-D bulk copies (cp.async.bulk);
// PERF.md §6 has this form's times.
//
// Both kernels are templated on the element type (bf16 or fp32), for the
// JAX kernels' fp32 operands: the fp32 forms read and write fp32 with the
// same fp32 arithmetic, 4 values per 16-byte vector. Their bound is bytes
// as well.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"
#include "mma.cuh"
#include "simt_f32.cuh"

namespace {

using namespace vit;

constexpr int kBlock = 256;  // K9b's threads a block

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

// K9c's block: 4 warps, a row a warp.
constexpr int kLnWarps = 4;
constexpr int kLnThreads = 32 * kLnWarps;

// What a lane of K9c holds of a row of C values of T: kFull 16-byte chunks
// (lane + 32·j of the row's chunks), then, where 32 chunks do not divide
// the row (bf16 at C 128, 384, 640, 896), kTail values of 8 bytes at the
// row's end. kPer values in all.
template <typename T, int C>
struct LnRow {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kFull = C / (32 * kVec);
  static constexpr int kTail = (C % (32 * kVec)) / 32;
  static constexpr int kPer = kFull * kVec + kTail;
  static_assert(C % 128 == 0 && (kTail == 0 || kTail == 4), "C");
};

// One 16- or 8-byte load: bf16 with the streaming hint (ld.global.cs, each
// value is read once), fp32 plain (on an H100 the hint made bf16 faster
// and fp32 slower).
template <typename T, typename V>
__device__ __forceinline__ V load_once(const uint8_t* p) {
  if constexpr (sizeof(T) == 2)
    return __ldcs(reinterpret_cast<const V*>(p));
  else
    return *reinterpret_cast<const V*>(p);
}

// A lane's kPer values of the row at `row` (global memory) as floats.
template <typename T, int C>
__device__ __forceinline__ void load_row(const T* row, int lane,
                                         float (&v)[LnRow<T, C>::kPer]) {
  using R = LnRow<T, C>;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(row);
#pragma unroll
  for (int j = 0; j < R::kFull; ++j) {
    float e[R::kVec];
    unpack16<T>(load_once<T, uint4>(p + 16 * (lane + 32 * j)), e);
#pragma unroll
    for (int k = 0; k < R::kVec; ++k) v[j * R::kVec + k] = e[k];
  }
  if constexpr (R::kTail != 0) {
    const uint2 raw = load_once<T, uint2>(p + 512 * R::kFull + 8 * lane);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < R::kTail; ++k) v[R::kFull * R::kVec + k] = to_f(e[k]);
  }
}

// Streaming stores (st.global.cs): dx is not read again by this kernel.
__device__ __forceinline__ void store_cs(void* p, const uint4& v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void store_cs(void* p, const uint2& v) {
  asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};\n" ::"l"(p), "r"(v.x),
               "r"(v.y)
               : "memory");
}

// A lane's kPer values of dx into the row at `out` (global memory).
template <typename T, int C>
__device__ __forceinline__ void write_row(T* out, int lane,
                                          const float (&v)[LnRow<T, C>::kPer]) {
  using R = LnRow<T, C>;
  uint8_t* row = reinterpret_cast<uint8_t*>(out);
#pragma unroll
  for (int j = 0; j < R::kFull; ++j) {
    float e[R::kVec];
#pragma unroll
    for (int k = 0; k < R::kVec; ++k) e[k] = v[j * R::kVec + k];
    store_cs(row + 16 * (lane + 32 * j), pack16<T>(e));
  }
  if constexpr (R::kTail != 0) {
    const float* e = v + R::kFull * R::kVec;
    store_cs(row + 512 * R::kFull + 8 * lane,
             make_uint2(pack_bf16x2(e[0], e[1]), pack_bf16x2(e[2], e[3])));
  }
}

// Two warp sums at once: their shuffles interleave.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// dx of one row from a lane's share of x (xv, overwritten) and of g (gv,
// overwritten with dx): two rounds of paired warp sums, (Σx, Σg), then
// (Σd², Σg·d) with d = x − μ; rstd = rsqrt(Σd²/C + eps), c1 = Σg/C,
// c2 = rstd·Σg·d/C, dx = rstd·(g − c1 − d·rstd·c2).
template <typename T, int C>
__device__ __forceinline__ void row_dx(float (&xv)[LnRow<T, C>::kPer],
                                       float (&gv)[LnRow<T, C>::kPer]) {
  using R = LnRow<T, C>;
  float sx = 0.0f, sg = 0.0f;
#pragma unroll
  for (int e = 0; e < R::kPer; ++e) {
    sx += xv[e];
    sg += gv[e];
  }
  warp_sum2(sx, sg);
  const float mu = sx / C, c1 = sg / C;
  float sq = 0.0f, sgd = 0.0f;
#pragma unroll
  for (int e = 0; e < R::kPer; ++e) {
    xv[e] -= mu;
    sq += xv[e] * xv[e];
    sgd += gv[e] * xv[e];
  }
  warp_sum2(sq, sgd);
  const float rstd = rsqrtf(sq / C + 1e-5f);
  const float c2 = rstd * sgd / C;
#pragma unroll
  for (int e = 0; e < R::kPer; ++e)
    gv[e] = rstd * (gv[e] - c1 - (xv[e] * rstd) * c2);
}

// Warp w of block b takes row b·kLnWarps + w: all of its loads at once,
// its two rounds of sums, its stores.
template <typename T, int C>
__global__ void __launch_bounds__(kLnThreads)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
              T* __restrict__ dx, int N) {
  using R = LnRow<T, C>;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32;
  if (row >= N) return;
  float xv[R::kPer], gv[R::kPer];
  load_row<T, C>(x + static_cast<size_t>(row) * C, lane, xv);
  load_row<T, C>(g + static_cast<size_t>(row) * C, lane, gv);
  row_dx<T, C>(xv, gv);
  write_row<T, C>(dx + static_cast<size_t>(row) * C, lane, gv);
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

template <typename T, int C>
int launch_ln_bwd_c(const void* x, const void* g, void* dx, int N,
                    cudaStream_t stream) {
  if (N == 0) return 0;
  ln_bwd_kernel<T, C><<<(N + kLnWarps - 1) / kLnWarps, kLnThreads, 0,
                        stream>>>(static_cast<const T*>(x),
                                  static_cast<const T*>(g),
                                  static_cast<T*>(dx), N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ln_bwd(const void* x, const void* g, void* dx, int N, int C,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return launch_ln_bwd_c<T, 128>(x, g, dx, N, st);
    case 256: return launch_ln_bwd_c<T, 256>(x, g, dx, N, st);
    case 384: return launch_ln_bwd_c<T, 384>(x, g, dx, N, st);
    case 512: return launch_ln_bwd_c<T, 512>(x, g, dx, N, st);
    case 640: return launch_ln_bwd_c<T, 640>(x, g, dx, N, st);
    case 768: return launch_ln_bwd_c<T, 768>(x, g, dx, N, st);
    case 896: return launch_ln_bwd_c<T, 896>(x, g, dx, N, st);
    case 1024: return launch_ln_bwd_c<T, 1024>(x, g, dx, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// x, g, dx: (N, C) of one type (bf16 for ln_bwd, fp32 for ln_bwd_f32),
// contiguous, 16-byte aligned; C a multiple of 128 up to 1024
// (cudaErrorInvalidValue otherwise). Returns cudaGetLastError() after the
// launch.
extern "C" int ln_bwd(const void* x, const void* g, void* dx, int N, int C,
                      void* stream) {
  return launch_ln_bwd<bf16>(x, g, dx, N, C, stream);
}

extern "C" int ln_bwd_f32(const void* x, const void* g, void* dx, int N, int C,
                          void* stream) {
  return launch_ln_bwd<float>(x, g, dx, N, C, stream);
}
