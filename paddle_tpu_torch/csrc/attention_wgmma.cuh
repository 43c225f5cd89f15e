// Hopper tensor-core tile code for the port's 16-bit kernels and the f32
// attention kernels' 3xTF32 products (`WgmmaTf32`, `split_tf32`, `swz32`,
// `frag_a_tf32`, and the backward's S / dP stage `sdp_issue_3xtf32` /
// `ds_3xtf32`): the flash
// forward #2 (flash_attention_fwd.cu), the dQ kernel #3 and the dK/dV
// kernel #4 (flash_attention_bwd.cu), the bias gradient #5
// (flash_attention_dbias.cu), the matmul+rope kernel #10
// (matmul_rope.cu) and the grouped matmuls #11 and #13
// (grouped_matmul.cu): warpgroup matrix multiplies (`wgmma.mma_async`, f32
// accumulate), 128-byte-swizzled shared-memory tiles filled by
// `cp.async` (or by TMA, which writes the same layout), and the
// descriptors that let wgmma read them.
//
// Tiles.  A [R][D] tile of 16-bit elements (a row a query or a key) is
// stored as D / 64 column blocks [R][64], each row 128 bytes, with the
// 16-byte chunk c of row r at chunk position c ^ (r % 8): the 128-byte
// swizzle, which wgmma's descriptor names (layout type 1) and which
// spreads the eight rows of an 8 x 128-byte atom over all 32 banks.  The
// tile base is 1024-byte aligned, so the swizzle the hardware applies
// from address bits [7, 10) is the one the copies wrote.  One stored
// layout serves both operand roles:
//   - K-major (the reduction dim runs along the row: Q and K in S = Q K^T,
//     K/V and Q/dO in the backward's S^T = K Q^T and dP^T = V dO^T, dO
//     and V in dP = dO V^T, x in x W, lhs in #11 and w[e] [N][K] in its
//     transpose_w form): the 16-column slice kk starts at column block
//     kk / 4, byte 32 (kk % 4); 8-row groups are 1024 bytes apart (SBO);
//   - MN-major (the reduction dim runs down the rows: V in O += P V, dO
//     and Q in dV += P^T dO and dK += dS^T Q, K in dQ += dS K, W [K][N]
//     in x W and w[e] [K][N] in #11, lhs and dout in #13's lhs^T dout;
//     wgmma's transpose bits): the 16-row slice kk starts 2048 kk
//     bytes in; 8-row groups are 1024 bytes apart (SBO) and column
//     blocks R * 128 bytes apart (LBO).
//
// Fragments.  The f32 accumulator of an m64nN product gives thread t of
// the warpgroup (warp w = t / 32, lane l) rows 16 w + l / 4 and
// 16 w + l / 4 + 8, columns 8 j + 2 (l % 4) + {0, 1}: d[4 j + {0, 1}] on
// the first row, d[4 j + {2, 3}] on the second.  The register A operand
// of an m64k16 product has the same layout, so the slice kk of an
// accumulator, rounded to 16 bits two values a register, is the A operand
// of the next product over those columns (`frag_a`): P = softmax(S) and
// dS feed P V, P^T dO, dS^T Q and dS K without leaving the registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace ptt {
namespace wg {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the special-function unit (-inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte (4-byte) asynchronous copy into shared memory; zeros where
// !valid (nothing is read from src then).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Waits until at most N of this thread's committed copy groups are
// pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's finished shared-memory writes before later reads
// by wgmma (the async proxy); a barrier then publishes them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier over one warpgroup (ids 1, 2, ...; 0 is __syncthreads).
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Byte offset of element (r, c) in a swizzled [R][D] tile.
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * (R * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// Starts copying rows [0, n) of src (row stride rs elements, 16-byte
// aligned rows) into the swizzled tile at dst; rows [n, R) become zeros.
// Thread tid copies the 16-byte chunk tid % (D / 8) of rows tid / (D / 8)
// + k NT / (D / 8): a row step that is a multiple of 8 keeps the chunk's
// swizzled position, so each copy is one address step from the last.
template <int R, int D, int NT, typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src,
                                          long long rs, int n, int tid) {
  constexpr int CH = D / 8, STEP = NT / CH;
  static_assert(NT % CH == 0 && STEP % 8 == 0 && R % STEP == 0,
                "a thread's rows must share their swizzle phase");
  const int r0 = tid / CH, c = (tid % CH) * 8;
  const uint32_t d0 = dst + swz<R>(r0, c);
  const T* s0 = src + r0 * rs + c;
#pragma unroll
  for (int k = 0; k < R / STEP; ++k) {
    const bool ok = r0 + k * STEP < n;
    cp16(d0 + k * STEP * 128, ok ? s0 + k * STEP * rs : src, ok);
  }
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// The 16-column slice kk of a K-major operand whose tile has R rows.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int kk) {
  return make_desc(base + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16, 1024);
}
// The 16-row slice kk of an MN-major operand whose tile has R rows.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int kk) {
  return make_desc(base + kk * 2048, R * 128, 1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending
// (groups complete in order).
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of wgmma's registers above the
// wait (or reusing its A registers before it).
template <int M>
__device__ __forceinline__ void keep(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M>
__device__ __forceinline__ void keep(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo,
                                                         float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<const __half2*>(&v));
}

// The accumulator's 16-column slice kk as the A operand of a product.
template <typename T, int M>
__device__ __forceinline__ void frag_a(const float (&d)[M], int kk,
                                       uint32_t (&a)[4]) {
  a[0] = pack2<T>(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack2<T>(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2<T>(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2<T>(d[8 * kk + 6], d[8 * kk + 7]);
}

// The same slice as a 16-bit high part and the 16-bit rounding of what
// it leaves (hi + lo carries p to about 2^-16 of itself).
template <typename T, int M>
__device__ __forceinline__ void frag_a_split(const float (&d)[M], int kk,
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x0 = d[8 * kk + 2 * j], x1 = d[8 * kk + 2 * j + 1];
    hi[j] = pack2<T>(x0, x1);
    const float2 h = unpack2<T>(hi[j]);
    lo[j] = pack2<T>(x0 - h.x, x1 - h.y);
  }
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as the
// 32-bit pattern wgmma reads: its low 13 bits are zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}
// The same rounding by two integer operations, bit for bit `tf32`'s for
// finite x: half a unit of the 13 dropped bits added to the magnitude
// (ties away from zero), then the bits dropped.  The kernels that split
// every operand of every tile (#3's and #5's f32 routes) use this one:
// there it ran faster than cvt.rna.tf32 (PERF.md).
__device__ __forceinline__ uint32_t tf32_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = hi + lo to about 2^-22 of x: hi its TF32 rounding, lo the TF32
// rounding of the remainder (exact in f32).  A product of two such pairs
// taken as hi hi' + hi lo' + lo hi' (3xTF32) leaves out lo lo', about
// 2^-22 of the product.  INT: rounded by `tf32_int`.
template <bool INT = false>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = INT ? tf32_int(x) : tf32(x);
  const float r = x - __uint_as_float(hi);
  lo = INT ? tf32_int(r) : tf32(r);
}

// Byte offset of f32 element (r, c) in a swizzled [R][D] tile: D / 32
// column blocks [R][32] of 128-byte rows, the 16-byte chunk c / 4 of row
// r at chunk position (c / 4) ^ (r % 8) (the layout of `swz` with 4-byte
// elements; desc_k reads its 8-column slices as TF32 k steps).
template <int R>
__device__ __forceinline__ uint32_t swz32(int r, int c) {
  return (c >> 5) * (R * 128) + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) +
         (c & 3) * 4;
}

// The TF32 A operand of an m64k8 product over the 8 key columns
// [8 kk, 8 kk + 8) of an f32 accumulator, high and low parts.  The A
// fragment gives thread (g, t4) rows g, g + 8 at columns t4, t4 + 4; the
// accumulator holds columns 2 t4, 2 t4 + 1.  So column t4 of the operand
// carries key 2 t4 and column t4 + 4 key 2 t4 + 1: the product sums over
// the keys in the order {0, 2, 4, 6, 1, 3, 5, 7}, and the B operand's k
// rows must follow it (`key_slot`).
template <bool INT = false, int M>
__device__ __forceinline__ void frag_a_tf32(const float (&d)[M], int kk,
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split_tf32<INT>(d[4 * kk + 0], hi[0], lo[0]);   // row g,     key 2 t4
  split_tf32<INT>(d[4 * kk + 2], hi[1], lo[1]);   // row g + 8, key 2 t4
  split_tf32<INT>(d[4 * kk + 1], hi[2], lo[2]);   // row g,     key 2 t4 + 1
  split_tf32<INT>(d[4 * kk + 3], hi[3], lo[3]);   // row g + 8, key 2 t4 + 1
}
// The k position of key j in a B operand read against frag_a_tf32.
__device__ __forceinline__ int key_slot(int j) {
  return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1);
}

#define PTT_F8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PTT_WG_D16(d) PTT_F8(d, 0), PTT_F8(d, 8)
#define PTT_WG_D32(d) PTT_WG_D16(d), PTT_F8(d, 16), PTT_F8(d, 24)
#define PTT_WG_D64(d)                                                    \
  PTT_WG_D32(d), PTT_F8(d, 32), PTT_F8(d, 40), PTT_F8(d, 48), PTT_F8(d, 56)
#define PTT_WG_D128(d)                                                   \
  PTT_WG_D64(d), PTT_F8(d, 64), PTT_F8(d, 72), PTT_F8(d, 80),             \
      PTT_F8(d, 88), PTT_F8(d, 96), PTT_F8(d, 104), PTT_F8(d, 112),       \
      PTT_F8(d, 120)
// the accumulator's operand names in the instruction text
#define PTT_WG_S16                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define PTT_WG_S32                                                       \
  PTT_WG_S16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
             "%27, %28, %29, %30, %31"
#define PTT_WG_S64                                                       \
  PTT_WG_S32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
             "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
             "%55, %56, %57, %58, %59, %60, %61, %62, %63"
#define PTT_WG_S128                                                      \
  PTT_WG_S64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, " \
             "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "    \
             "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, "    \
             "%97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "  \
             "%107, %108, %109, %110, %111, %112, %113, %114, %115, "     \
             "%116, %117, %118, %119, %120, %121, %122, %123, %124, "     \
             "%125, %126, %127"

// ss: A and B descriptors (operands AB), scale_d the predicate (P).
#define PTT_WG_SS(TY, N, DS, DOPS, AB, P)                                \
  static __device__ __forceinline__ void ss(float(&d)[N / 2], uint64_t a, \
                                            uint64_t b, int scale_d) {   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY   \
                 "." TY " {" DS "}, " AB ", p, 1, 1, 0, 0;\n}\n"          \
                 : DOPS(d)                                               \
                 : "l"(a), "l"(b), "r"(scale_d));                        \
  }
// ss_mn: as ss, B MN-major (the transpose bit).
#define PTT_WG_SS_MN(TY, N, DS, DOPS, AB, P)                             \
  static __device__ __forceinline__ void ss_mn(                          \
      float(&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {           \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY   \
                 "." TY " {" DS "}, " AB ", p, 1, 1, 0, 1;\n}\n"          \
                 : DOPS(d)                                               \
                 : "l"(a), "l"(b), "r"(scale_d));                        \
  }
// ss_tt: as ss, A and B MN-major (both transpose bits; 16-bit types only).
#define PTT_WG_SS_TT(TY, N, DS, DOPS, AB, P)                             \
  static __device__ __forceinline__ void ss_tt(                          \
      float(&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {           \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY   \
                 "." TY " {" DS "}, " AB ", p, 1, 1, 1, 1;\n}\n"          \
                 : DOPS(d)                                               \
                 : "l"(a), "l"(b), "r"(scale_d));                        \
  }
// rs: four A registers and the B descriptor (operands AB), an
// accumulating predicate (P), B transposed.
#define PTT_WG_RS(TY, N, DS, DOPS, AB, P)                                \
  static __device__ __forceinline__ void rs(                             \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t b) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY   \
                 "." TY " {" DS "}, " AB ", p, 1, 1, 1;\n}\n"             \
                 : DOPS(d)                                               \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),   \
                   "r"(1));                                              \
  }

// One m64nNk16 product of 16-bit T into an f32 accumulator of N / 2
// registers a thread.  ss: A and B K-major in shared memory (scale_d 0
// overwrites d).  ss_mn: A K-major, B MN-major (x W in #10; lhs w[e] in
// #11).  ss_tt: A and B MN-major (lhs^T dout in #13).  rs: A in
// registers (`frag_a`), B MN-major in shared memory (the transpose bit),
// accumulating.  N 32 (the dropout dK/dV kernel's score tiles) takes ss
// only, N 256 (#11 and #13) the three shared-memory forms.
template <typename T, int N>
struct Wgmma;

#define PTT_WG_TYPE(T, TY)                                               \
  template <>                                                            \
  struct Wgmma<T, 32> {                                                  \
    PTT_WG_SS(TY, 32, PTT_WG_S16, PTT_WG_D16, "%16, %17", "%18")         \
  };                                                                     \
  template <>                                                            \
  struct Wgmma<T, 64> {                                                  \
    PTT_WG_SS(TY, 64, PTT_WG_S32, PTT_WG_D32, "%32, %33", "%34")         \
    PTT_WG_RS(TY, 64, PTT_WG_S32, PTT_WG_D32, "{%32, %33, %34, %35}, %36", \
              "%37")                                                     \
  };                                                                     \
  template <>                                                            \
  struct Wgmma<T, 128> {                                                 \
    PTT_WG_SS(TY, 128, PTT_WG_S64, PTT_WG_D64, "%64, %65", "%66")        \
    PTT_WG_SS_MN(TY, 128, PTT_WG_S64, PTT_WG_D64, "%64, %65", "%66")     \
    PTT_WG_RS(TY, 128, PTT_WG_S64, PTT_WG_D64,                           \
              "{%64, %65, %66, %67}, %68", "%69")                        \
  };                                                                     \
  template <>                                                            \
  struct Wgmma<T, 256> {                                                 \
    PTT_WG_SS(TY, 256, PTT_WG_S128, PTT_WG_D128, "%128, %129", "%130")   \
    PTT_WG_SS_MN(TY, 256, PTT_WG_S128, PTT_WG_D128, "%128, %129", "%130") \
    PTT_WG_SS_TT(TY, 256, PTT_WG_S128, PTT_WG_D128, "%128, %129", "%130") \
  };

PTT_WG_TYPE(__nv_bfloat16, "bf16")
PTT_WG_TYPE(__half, "f16")

// TF32 forms (m64nNk8: 8 f32 operands, 32 bytes, a k step; no transpose
// bits, so both shared-memory operands are K-major).  ss: A and B
// descriptors, scale_d the predicate.  rs: four A registers (`frag_a_tf32`
// below) and the B descriptor, accumulating (scale_d 0: overwriting).
#define PTT_TF_SS(N, DS, DOPS, AB, P)                                    \
  static __device__ __forceinline__ void ss(float(&d)[N / 2], uint64_t a, \
                                            uint64_t b, int scale_d) {   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                   \
                 "k8.f32.tf32.tf32 {" DS "}, " AB ", p, 1, 1;\n}\n"       \
                 : DOPS(d)                                               \
                 : "l"(a), "l"(b), "r"(scale_d));                        \
  }
#define PTT_TF_RS(N, DS, DOPS, AB, P)                                    \
  static __device__ __forceinline__ void rs(                             \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t b,              \
      int scale_d = 1) {                                                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                   \
                 "k8.f32.tf32.tf32 {" DS "}, " AB ", p, 1, 1;\n}\n"       \
                 : DOPS(d)                                               \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),   \
                   "r"(scale_d));                                        \
  }

// One m64nNk8 TF32 product into an f32 accumulator of N / 2 registers a
// thread (the f32 flash forward's 3xTF32 products: N 32 / 64 for
// S = Q K^T, 64 / 128 for O += P V).
template <int N>
struct WgmmaTf32;
template <>
struct WgmmaTf32<32> {
  PTT_TF_SS(32, PTT_WG_S16, PTT_WG_D16, "%16, %17", "%18")
};
template <>
struct WgmmaTf32<64> {
  PTT_TF_SS(64, PTT_WG_S32, PTT_WG_D32, "%32, %33", "%34")
  PTT_TF_RS(64, PTT_WG_S32, PTT_WG_D32, "{%32, %33, %34, %35}, %36", "%37")
  // m64n32k8 into the first 16 registers of an m64n64 accumulator (its
  // columns 0-31), accumulating
  static __device__ __forceinline__ void ss_n32(float (&d)[32], uint64_t a,
                                                uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
                 PTT_WG_S16 "}, %16, %17, p, 1, 1;\n}\n"
                 : PTT_WG_D16(d)
                 : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct WgmmaTf32<128> {
  PTT_TF_RS(128, PTT_WG_S64, PTT_WG_D64, "{%64, %65, %66, %67}, %68",
            "%69")
};

#undef PTT_TF_RS
#undef PTT_TF_SS
#undef PTT_WG_TYPE
#undef PTT_WG_RS
#undef PTT_WG_SS_TT
#undef PTT_WG_SS_MN
#undef PTT_WG_SS
#undef PTT_WG_S128
#undef PTT_WG_S64
#undef PTT_WG_S32
#undef PTT_WG_S16
#undef PTT_WG_D128
#undef PTT_WG_D64
#undef PTT_WG_D32
#undef PTT_WG_D16
#undef PTT_F8

// -------- the f32 backward's S / dP stage on 3xTF32 (dQ #3, dbias #5)
//
// One warpgroup's 64 query rows against 32 keys.  Q (scaled) and dO are
// the A operands: swizzled [RQ][D] hi and lo tiles, the warpgroup's rows
// at qh / ql / oh / ol.  K and V are the B operands, each a hi-over-lo
// row tile [64][D] (the 32 keys' hi rows over their lo rows, `swz32<64>`):
// one m64n64 product a k step takes hi hi' into columns 0-31 and hi lo'
// into 32-63, one m64n32 (lo against the hi rows) adds lo hi' to 0-31,
// and the halves are summed after.

// Issues S = Q K^T and dP = dO V^T as two wgmma groups (sc, then dc:
// m64n64 accumulators); `ds_3xtf32` waits for them.
template <int RQ, int D>
__device__ __forceinline__ void sdp_issue_3xtf32(float (&sc)[32],
                                                 float (&dc)[32],
                                                 uint32_t qh, uint32_t ql,
                                                 uint32_t oh, uint32_t ol,
                                                 uint32_t kn, uint32_t vn) {
  fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    WgmmaTf32<64>::ss(sc, desc_k<RQ>(qh, kk), desc_k<64>(kn, kk), kk > 0);
    WgmmaTf32<64>::ss_n32(sc, desc_k<RQ>(ql, kk), desc_k<64>(kn, kk));
  }
  commit();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    WgmmaTf32<64>::ss(dc, desc_k<RQ>(oh, kk), desc_k<64>(vn, kk), kk > 0);
    WgmmaTf32<64>::ss_n32(dc, desc_k<RQ>(ol, kk), desc_k<64>(vn, kk));
  }
  commit();
}

// A thread's two query rows of the warpgroup's tile (d[4j + {0, 1}] on
// r_a, d[4j + {2, 3}] on r_b = r_a + 8): lse, lse in log2 units, delta,
// and the rows' dropout keys.
struct TfRows {
  int r_a, r_b;
  float lse_a, lse_b, ml_a, ml_b, dl_a, dl_b;
  uint32_t rk_a, rk_b;
};

// dS = P (dP' - delta) of the 32 keys from t0 (element i: row i & 2 ?
// r_b : r_a, key t0 + 8 (i >> 2) + 2 t4 + (i & 1)), with P = exp(s -
// lse) built while dP runs.  `edge` tiles (a mask or bias, the causal
// diagonal, the ragged key end) go element by element: the addend
// add(i, r, key), then causal masking to -1e30, the subtraction s - lse
// first (exact where both are -1e30, so a row whose every key is hidden
// weighs them alike, as the plain version does), and 0 past Sq or Sk;
// the others take one FFMA an element.  In dropout mode dP' = keep ?
// dP / (1 - p) : 0, one hash an element.
template <bool DROP, typename Add>
__device__ __forceinline__ void ds_3xtf32(float (&ds)[16], float (&sc)[32],
                                          float (&dc)[32], const TfRows& rw,
                                          int t0, int t4, bool edge,
                                          bool causal, int off, int Sq,
                                          int Sk, const Dropout& drop,
                                          Add add) {
  wait<1>();
  keep(sc);
  if (edge) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i & 2) ? rw.r_b : rw.r_a;
      const int key = t0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const bool ok = key < Sk && r < Sq;
      float x = sc[i] + sc[i + 16];
      if (ok) x += add(i, r, key);
      if (causal && key > off + r) x = kMasked;
      ds[i] = ok ? ex2((x - ((i & 2) ? rw.lse_b : rw.lse_a)) * kLog2e) : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      ds[i] = ex2(fmaf(sc[i] + sc[i + 16], kLog2e,
                       (i & 2) ? -rw.ml_b : -rw.ml_a));
  }
  wait<0>();
  keep(dc);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float dpv = dc[i] + dc[i + 16];
    if constexpr (DROP)
      dpv = drop.apply((i & 2) ? rw.rk_b : rw.rk_a,
                       t0 + 8 * (i >> 2) + 2 * t4 + (i & 1), dpv);
    ds[i] *= dpv - ((i & 2) ? rw.dl_b : rw.dl_a);
  }
}

}  // namespace wg
}  // namespace ptt
