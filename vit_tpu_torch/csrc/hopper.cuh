// Hopper (sm_90a) primitives as small inline-PTX wrappers: the mbarrier,
// TMA tensor loads and stores (cp.async.bulk.tensor), warpgroup products
// (wgmma.mma_async m64n64k16, m64n32k16 (A from shared memory or
// registers), and m64n128k16 / m64n256k16 for
// K9a and K10, bf16 in, fp32 accumulate; m64n32k32 int8 in,
// int32 accumulate, for K12a and K12b) and setmaxnreg, that the attention
// kernels (K6, K7/K8 and their packed forms K1, K2; their fp32 forms
// through fp32-accurate products of three bf16 parts), the ConvNeXt block
// tail (K3, K4; their fp32 forms the same way), the depthwise convolution
// (K11a, K11b: halo tiles in, output tiles out by TMA), the LayerNorm →
// matmul (K9a and its fp32 form) and the weight gradient (K10 and its fp32
// form) are built from, and the host side of their tensor maps.
//
// Tiles. Every operand tile here is 64 bf16 wide (head_dim 64 = one
// 128-byte row; attention_tile.cuh adds the 32-wide heads' 64-byte rows) and lands in shared memory through a tensor map built with
// CU_TENSOR_MAP_SWIZZLE_128B: row r of a tile sits at byte r·128, its
// 16-byte chunk c at chunk c ^ (r % 8). A tile's base is 1024-byte aligned
// (one swizzle period of 8 rows), so a wgmma descriptor with base offset 0
// reads it. Such a tile serves a product in two ways:
//   K-major: the tile's rows are the product's M or N rows and its 64
//     columns the reduction, e.g. K in s = Q·Kᵀ. Descriptor stride byte
//     offset (8-row group to 8-row group) 1024; a 16-wide step of the
//     reduction advances the start address by 32 bytes inside the swizzled
//     row, as the hardware applies the XOR to the final address.
//   MN-major (the transpose bit): the tile's rows are the reduction and its
//     64 columns the N dimension, e.g. V in o = P·V. One swizzle atom spans
//     all 64 columns; 8-row groups of the reduction are 1024 bytes apart and
//     a 16-row step advances the start address by 2048 bytes. No transposed
//     copy of the tile is ever made.
//
// Accumulator layout of m64nN (fp32), per thread of a warpgroup with warp w
// (0..3), g = lane / 4 and t = lane % 4: d[4j + 2r + c] = D[16w + g + 8r]
// [8j + 2t + c], i.e. mma.sync m16n8's C layout for each 8-column tile j, on
// the warp's 16 rows. A register A operand (m64k16) is mma.sync m16n8k16's
// A fragment on the warp's 16 rows: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]. So two neighbouring 8-column
// accumulator tiles repack to bf16 as one A step, and a score tile feeds the
// next product without a trip through shared memory.
//
// Threads may rewrite a tile in place before a wgmma reads it (the packed
// attention's bias, attention_tile.cuh:add_head_bias): each writer fences
// its generic-proxy
// writes with fence_proxy_async(), then a named barrier over the threads
// that issue the wgmmas; without the fence a wgmma can read the bytes TMA
// wrote, which gives wrong numbers and no fault.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vit {
namespace hopper {

constexpr int kTileRows = 64;                     // rows of one TMA box
constexpr uint32_t kTileBytes = kTileRows * 128;  // one 64 x 64 bf16 tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, its base rounded up to 1024 bytes (launchers
// ask for sizeof(T) + 1024).
template <typename T>
__device__ __forceinline__ T& aligned_smem() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  return *reinterpret_cast<T*>(smem_raw + ((1024u - (base & 1023u)) & 1023u));
}

// ---- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); then a
// __syncthreads() before any thread uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed. A fresh barrier
// counts its (nonexistent) phase of parity 1 as completed, so a producer
// waiting for free slots starts at parity 1 and a consumer at parity 0.
// A wait that never ends (a fault in the pipeline's bookkeeping) traps
// after 2^28 polls, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// A ring of kStages shared-memory stages that a producer fills and the
// consumers drain, its barriers addressed by a load's place i in the
// sequence of loads through it: stage i % kStages, in that stage's lap
// i / kStages.
template <int kStages>
struct Ring {
  uint64_t full[kStages], empty[kStages];

  // `producers` arrivals (one of them with the TMA byte count) fill a
  // stage, one arrival from each of `consumer_warps` warps frees it. One
  // thread calls this.
  __device__ void init(uint32_t producers, uint32_t consumer_warps) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], producers);
      mbar_init(&empty[s], consumer_warps);
    }
  }
  __device__ static int stage(int i) { return i % kStages; }
  __device__ void wait_full(int i) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
  }
  __device__ void wait_empty(int i) {
    mbar_wait(&empty[i % kStages], ((i / kStages) & 1) ^ 1);
  }
  // Every thread of a consumer warp calls this when it is done with load i;
  // the warp arrives once.
  __device__ void release(int i) {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[i % kStages]);
  }
};

// exp(x) for attention's shifted scores, as the single MUFU instruction
// ex2.approx of an argument already scaled by log2(e) (callers fold the
// scaling and the shift into one FMA). Relative error about 2^-22 beyond
// that of the rounded argument: a few 1e-6 where expf is within one ulp.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- TMA -----------------------------------------------------------------

// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at `dst`; completion is counted on `bar` in
// bytes. Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-D tensor map at coordinates (c0, c1), innermost first;
// otherwise as tma_load_4d.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, written from shared memory at `src` as a bulk async group; elements
// outside the tensor are not written. The threads that wrote `src` fence
// their writes (fence_proxy_async) and synchronise before one thread issues
// it, then commits the group (bulk_commit).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// The same for one box of a 2-D tensor map at (c0, c1).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed bulk groups are still
// reading their shared memory (bulk_wait_read) or still running (bulk_wait).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sets this warpgroup's registers a thread to N (a multiple of 8, 24 to
// 256), as its four warps reach it together: a producer warpgroup gives
// registers up (dec) so that the consumer warpgroups can take them (inc).
// ptxas honours it only where the roles split once and never rejoin.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands written by threads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over `threads` threads, e.g. one warpgroup.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Two bf16 sums a + b, each rounded once to nearest even (a·1 + b).
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3F803F80u), "r"(b));
  return d;
}

// ---- wgmma ---------------------------------------------------------------

// x as a value the compiler cannot see through, so that descriptors formed
// from it are formed where they are used instead of being kept in
// registers across the loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Shared-memory matrix descriptor of a 128-byte swizzled tile at `addr`:
// start address, leading and stride byte offsets (all >> 4), layout 1 =
// 128B swizzle in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major: the leading offset is unused under the swizzle (1 by convention).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// MN-major: 8-row groups of the reduction 1024 bytes apart; the leading
// offset (the next 64-column atom) is never reached at N = 64.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return desc_sw128(addr, 1024, 1024);
}

// MN-major over two 64-column atoms `lbo` bytes apart (N = 128): the
// leading offset steps from one atom to the next along N.
__device__ __forceinline__ uint64_t desc_mn2(uint32_t addr, uint32_t lbo) {
  return desc_sw128(addr, lbo, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tells the compiler that registers change here, so no read of an
// accumulator moves above a wgmma_wait and no write of it below a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
template <int P, int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[P][N][M]) {
#pragma unroll
  for (int p = 0; p < P; ++p) fence_regs(r[p]);
}

#define VIT_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define VIT_ACC32_LIST                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (+)= A·B, m64n64k16: A and B from shared memory through descriptors;
// kTransB = 1 reads B MN-major. scale_d = 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VIT_ACC32_LIST
      ", %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : VIT_ACC32(d)
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB));
}

#define VIT_ACC16(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d (+)= A·B, m64n32k16, as wgmma_ss over 32 columns: d[4j + 2r + c] =
// D[16w + g + 8r][8j + 2t + c] for j < 4. A K-major B of 32 rows starts 32
// rows (4096 bytes) into a tile; an MN-major one 32 columns (64 bytes) into
// its 128-byte rows, which the swizzle XOR leaves in place.
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, %19;\n"
      "}\n"
      : VIT_ACC16(d)
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB));
}

// d += A·B, m64n64k16: A from registers (one k16 step of A fragments), B
// from shared memory; kTransB = 1 reads B MN-major.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VIT_ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : VIT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(kTransB));
}

// d += A·B, m64n32k16: A from registers (one k16 step of A fragments), B
// from shared memory; kTransB = 1 reads B MN-major. The accumulator layout
// of wgmma_ss_n32 (the attention kernels' 32-wide heads: o += P·V).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : VIT_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(kTransB));
}

#define VIT_IACC16(d)                                                        \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),    \
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),           \
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])

// d (+)= A·B, m64n32k32, int8 × int8 → int32 (exact, as the MXU's int8
// products): A and B K-major from shared memory through descriptors (8-bit
// operands have no transpose bit). A k32 step is 32 bytes of a 128-byte
// swizzled row, the byte arithmetic of bf16's k16 step, so desc_k serves; a
// B of 32 rows starts 32 rows (4096 bytes) into a tile for its rows 32-63.
// The accumulator layout is the fp32 one: d[4j + 2r + c] = D[16w + g + 8r]
// [8j + 2t + c], j < 4. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_s8_n32(int (&d)[16], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p;\n"
      "}\n"
      : VIT_IACC16(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// Eight accumulator registers d[o .. o + 7] as asm operands, for the wide
// products' operand lists.
#define VIT_ACC8(d, o)                                                       \
  "+f"(d[(o) + 0]), "+f"(d[(o) + 1]), "+f"(d[(o) + 2]), "+f"(d[(o) + 3]),     \
      "+f"(d[(o) + 4]), "+f"(d[(o) + 5]), "+f"(d[(o) + 6]), "+f"(d[(o) + 7])

// d (+)= A·B, m64nNk16 for N 128 or 256 (N / 2 accumulator registers, the
// layout of m64n64's continued over N / 8 column tiles: d[4j + 2r + c] =
// D[16w + g + 8r][8j + 2t + c]): A and B both K-major from shared memory
// through descriptors, B's N rows 128 bytes apart in one swizzled run of
// 64-row tiles (8-row groups 1024 bytes apart, as desc_k). scale_d = 0
// overwrites d. Fewer shared-memory bytes a FLOP than m64n64: A is read
// once for N columns.
template <int N>
__device__ __forceinline__ void wgmma_ss_wide(float (&d)[N / 2], uint64_t a,
                                              uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss_wide<128>(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : VIT_ACC8(d, 0), VIT_ACC8(d, 8), VIT_ACC8(d, 16), VIT_ACC8(d, 24),
        VIT_ACC8(d, 32), VIT_ACC8(d, 40), VIT_ACC8(d, 48), VIT_ACC8(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_wide<256>(float (&d)[128], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : VIT_ACC8(d, 0), VIT_ACC8(d, 8), VIT_ACC8(d, 16), VIT_ACC8(d, 24),
        VIT_ACC8(d, 32), VIT_ACC8(d, 40), VIT_ACC8(d, 48), VIT_ACC8(d, 56),
        VIT_ACC8(d, 64), VIT_ACC8(d, 72), VIT_ACC8(d, 80), VIT_ACC8(d, 88),
        VIT_ACC8(d, 96), VIT_ACC8(d, 104), VIT_ACC8(d, 112), VIT_ACC8(d, 120)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= A·B, m64n128k16, both operands MN-major (the transpose bits):
// A's 64 rows one 64-column atom of a tile whose rows are the reduction
// (desc_mn), B's 128 columns two such atoms `lbo` bytes apart (desc_mn2),
// e.g. dW = gᵀ·x over rows of g and x as they lie in memory. The
// accumulator layout of wgmma_ss_wide<128>.
__device__ __forceinline__ void wgmma_ss_mn128(float (&d)[64], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : VIT_ACC8(d, 0), VIT_ACC8(d, 8), VIT_ACC8(d, 16), VIT_ACC8(d, 24),
        VIT_ACC8(d, 32), VIT_ACC8(d, 40), VIT_ACC8(d, 48), VIT_ACC8(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// The same over 256 columns, m64n256k16: B's 256 columns four 64-column
// atoms `lbo` bytes apart (desc_mn2); the accumulator layout of
// wgmma_ss_wide<256>.
__device__ __forceinline__ void wgmma_ss_mn256(float (&d)[128], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, 1, 1;\n"
      "}\n"
      : VIT_ACC8(d, 0), VIT_ACC8(d, 8), VIT_ACC8(d, 16), VIT_ACC8(d, 24),
        VIT_ACC8(d, 32), VIT_ACC8(d, 40), VIT_ACC8(d, 48), VIT_ACC8(d, 56),
        VIT_ACC8(d, 64), VIT_ACC8(d, 72), VIT_ACC8(d, 80), VIT_ACC8(d, 88),
        VIT_ACC8(d, 96), VIT_ACC8(d, 104), VIT_ACC8(d, 112), VIT_ACC8(d, 120)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef VIT_ACC8
#undef VIT_IACC16
#undef VIT_ACC16
#undef VIT_ACC32
#undef VIT_ACC32_LIST

// ---- fp32-accurate products from three bf16 parts --------------------------
//
// An fp32 value x splits into bf16 parts x = x0 + x1 + x2 exactly: x0 =
// bf16(x), x1 = bf16(x - x0), x2 = x - x0 - x1 (the 24-bit significand in
// three 8-bit pieces; exact while x2 stays a normal bf16, |x| above about
// 2^-110). A product A·B of fp32 operands is then the six bf16 products
// A_i·B_j with i + j <= 2 summed in one fp32 accumulator, the small terms
// first (A2B0, A1B1, A0B2, A1B0, A0B1, A0B0); the three dropped terms are
// below 2^-23 of |A|·|B|, as the TPU's Precision.HIGHEST sums the same six
// bf16 passes. With kParts = 1 the helpers are the plain bf16 products (the
// term A0B0 alone), so one kernel body serves both forms. A part-split
// operand tile keeps its parts `part` bytes apart in shared memory.

// The A and B parts of term t (0..5) of a six-term product
__host__ __device__ constexpr int split_a(int t) {
  return t < 3 ? 2 - t : (t == 3 ? 1 : 0);
}
__host__ __device__ constexpr int split_b(int t) {
  return t < 3 ? t : (t == 4 ? 1 : 0);
}
template <int kParts>
constexpr int kFirstTerm = kParts == 1 ? 5 : 0;

// d = A·Bᵀ over 64 (four k16 steps) from kParts-part tiles, A's parts a_part
// bytes apart and B's b_part bytes apart. 4 wgmmas a term, or kSteps over
// the first 16·kSteps of the 64 (a tile's reduction past a row's end).
template <int kParts, int kSteps = 4>
__device__ __forceinline__ void mma_abt_parts(float (&d)[32], uint32_t a,
                                              uint32_t a_part, uint32_t b,
                                              uint32_t b_part) {
#pragma unroll
  for (int t = kFirstTerm<kParts>; t < 6; ++t)
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_ss<0>(d, desc_k(a + split_a(t) * a_part + 32 * ks),
                  desc_k(b + split_b(t) * b_part + 32 * ks),
                  t > kFirstTerm<kParts> || ks > 0);
}

// The same over 32 columns (wgmma_ss_n32): d (64 x 32) = A·Bᵀ with B the
// 32 rows of a K-major tile from b (4096 bytes into it for its rows 32-63),
// over the first 16·kSteps of the 64 (a tile's reduction past a row's end).
template <int kParts, int kSteps = 4>
__device__ __forceinline__ void mma_abt_parts_n32(float (&d)[16], uint32_t a,
                                                  uint32_t a_part, uint32_t b,
                                                  uint32_t b_part) {
#pragma unroll
  for (int t = kFirstTerm<kParts>; t < 6; ++t)
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_ss_n32<0>(d, desc_k(a + split_a(t) * a_part + 32 * ks),
                      desc_k(b + split_b(t) * b_part + 32 * ks),
                      t > kFirstTerm<kParts> || ks > 0);
}

// The same over N columns (wgmma_ss_wide, N 128 or 256): d (64 x N) =
// A·Bᵀ over 64 with B the N rows of a K-major run of 64-row tiles at b.
template <int kParts, int N>
__device__ __forceinline__ void mma_abt_parts_wide(float (&d)[N / 2],
                                                   uint32_t a, uint32_t a_part,
                                                   uint32_t b, uint32_t b_part) {
#pragma unroll
  for (int t = kFirstTerm<kParts>; t < 6; ++t)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_wide<N>(d, desc_k(a + split_a(t) * a_part + 32 * ks),
                       desc_k(b + split_b(t) * b_part + 32 * ks),
                       t > kFirstTerm<kParts> || ks > 0);
}

// d = A·B over 16·kSteps, 32 columns (wgmma_ss_n32): A a K-major tile at
// a, B read MN-major from b (its rows the reduction, 2048 bytes a k16
// step; 64 bytes into the tile for its columns 32-63), both of kParts
// parts a_part and b_part bytes apart; e.g. da = do·W2 over an atom of C.
template <int kParts, int kSteps = 4>
__device__ __forceinline__ void mma_ab_parts_n32(float (&d)[16], uint32_t a,
                                                 uint32_t a_part, uint32_t b,
                                                 uint32_t b_part) {
#pragma unroll
  for (int t = kFirstTerm<kParts>; t < 6; ++t)
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_ss_n32<1>(d, desc_k(a + split_a(t) * a_part + 32 * ks),
                      desc_mn(b + split_b(t) * b_part + 2048 * ks),
                      t > kFirstTerm<kParts> || ks > 0);
}

// d += A·Bᵀ over 64: A's parts as register fragments a[part][k16 step], B
// a kParts-part tile read K-major from b (its rows the N dimension, 32
// bytes a k16 step), its parts b_part bytes apart; e.g. o += a·W2ᵀ.
template <int kParts>
__device__ __forceinline__ void mma_rbt_parts(
    float (&d)[32], const uint32_t (&a)[kParts][4][4], uint32_t b,
    uint32_t b_part) {
#pragma unroll
  for (int t = kFirstTerm<kParts>; t < 6; ++t)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs<0>(d, a[split_a(t)][ks],
                  desc_k(b + split_b(t) * b_part + 32 * ks));
}

// Two fp32 values (lo, hi) as kParts packed bf16 pairs into A fragment
// register i of k16 step ks: the value itself rounded (kParts = 1) or its
// three parts.
template <int kParts, int kSteps>
__device__ __forceinline__ void put_a(uint32_t (&a)[kParts][kSteps][4],
                                      int ks, int i, float lo, float hi) {
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    a[p][ks][i] = *reinterpret_cast<const uint32_t*>(&v);
    if (p + 1 < kParts) {
      lo = __fsub_rn(lo, __low2float(v));
      hi = __fsub_rn(hi, __high2float(v));
    }
  }
}

// Four fp32 values as kParts bf16 parts, 8 bytes each, part p at dst +
// p·part (elements): x = x0 + x1 + x2 exactly (x0 = bf16(x), x1 = bf16(x
// − x0), x2 = bf16(x − x0 − x1)), as put_a splits.
template <int kParts = 3>
__device__ __forceinline__ void store_parts(float (&v)[4], __nv_bfloat16* dst,
                                            size_t part) {
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(dst + p * part) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
    if (p + 1 < kParts) {
      v[0] = __fsub_rn(v[0], __low2float(lo));
      v[1] = __fsub_rn(v[1], __high2float(lo));
      v[2] = __fsub_rn(v[2], __low2float(hi));
      v[3] = __fsub_rn(v[3], __high2float(hi));
    }
  }
}

// ---- host: tensor maps ---------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library does not link libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of one unpacked bf16 operand (B, H, S, 64) with element
// strides st = (batch, head, row) and unit stride along head_dim: 4-D
// (width, S, H, B), boxes of 64 x 64 rows of one head, 128-byte swizzle,
// zeros past S. A width of 192 reads a row of three 64-wide parts, part p
// at column 64p. A box of 32 columns (a 32-wide head: rows of 64 bytes)
// takes the 64-byte swizzle. Strides of a dimension of size 1 are never
// used and are given as the row stride. Returns 0 or a cudaError_t.
inline int head_map(CUtensorMap* map, const void* base, const long long* st,
                    int B, int H, int S, int width = 64, int box_cols = 64) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t row = static_cast<cuuint64_t>(st[2]) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      row, H > 1 ? static_cast<cuuint64_t>(st[1]) * 2 : row,
      B > 1 ? static_cast<cuuint64_t>(st[0]) * 2 : row};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), kTileRows, 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// The tensor map of a row-major bf16 matrix (rows, cols), cols a multiple
// of 8 and rows 16-byte aligned: 2-D (cols, rows), boxes of 64 columns x
// box_rows rows, 128-byte swizzle, zeros past either edge. With elem_bytes
// 4, of an fp32 matrix, boxes of 32 columns (one 128-byte swizzled row).
// Returns 0 or a cudaError_t.
inline int matrix_map(CUtensorMap* map, const void* base, int rows,
                      int cols, int elem_bytes = 2, int box_rows = kTileRows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// The tensor map of an operand's three bf16 parts, (3, rows, cols): 4-D
// (cols, rows, 3, 1), boxes of 64 columns x 64 rows of one part, zeros
// past the part's rows and columns; part p of a box at coordinate p of the
// third dimension.
inline int parts_map(CUtensorMap* map, const void* base, int rows, int cols) {
  const long long st[3] = {0, static_cast<long long>(rows) * cols, cols};
  return head_map(map, base, st, 1, 3, rows, cols);
}

// The tensor map of a row-major int8 matrix (rows, cols), cols a multiple
// of 16: 2-D (cols, rows), boxes of 128 columns (one 128-byte swizzled
// row) x 64 rows, zeros past either edge. Returns 0 or a cudaError_t.
inline int byte_matrix_map(CUtensorMap* map, const void* base, int rows,
                           int cols) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {128, kTileRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace vit
