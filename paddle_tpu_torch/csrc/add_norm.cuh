// Fused residual add + RMSNorm or LayerNorm over the last axis, forward
// and backward.
//
// Replaces the TPU kernel `_add_norm_call`
// (paddle_tpu/ops/pallas/fused_train.py) with its two bodies,
// `_add_rms_kernel_body` and `_add_ln_kernel_body`: for every row,
// h = r + x in their promoted dtype, then y = norm(h) * w (+ b).  x and
// r are float32, bfloat16 or float16, in one dtype or (the mixed mode)
// one 16-bit and one float32: under amp O1 a post-norm block's output
// (x, after a white-listed linear) is 16-bit and its residual stream
// float32, and the reference's h = r + x promotes.  Each operand is read
// at its own width; h, and the gradient of the wider operand, are in the
// promoted dtype, the narrower operand's gradient is that gradient
// rounded to its dtype (the VJP of jnp's cast).  The roundings are
// the plain version's (`add_rms_norm_reference`,
// `add_layer_norm_reference` in ops/fused_train.py): statistics in f32,
// the normalised value rounded to h's dtype, then the scale (and the
// shift) applied in the promoted output dtype, each step rounded as
// PyTorch rounds it.  The products and sums of those steps use the
// __f*_rn intrinsics so that nvcc contracts none of them into an FMA.
//
// The backward is the reference's `_add_rms_bwd` / `_add_ln_bwd` (the
// VJP of the plain chain) as a kernel: per row it reads h, dy, dh (when
// h's gradient is used) and the weight, recomputes the statistics with
// the forward's own code (the same layout, so the same sums in the same
// order), and writes dx once: the gradient of both x and r.  It keeps the
// plain autograd's roundings where they fall on a 16-bit tensor
// (`add_rms_norm_backward_reference`, `add_layer_norm_backward_reference`):
// dy * w rounded to the product's dtype and then to h's, the gradient
// that reaches h rounded to h's dtype before dh is added, dw the sum of
// dy * round(n) over the rows.  dw (and db) are summed in f32 in shared
// memory, a row of sums per row group, added in group order into [blocks,
// H] partials, which a second launch sums in a fixed order into the
// weight's dtype: no float atomics, so two runs give the same bits.
//
// Layout: a row is held in registers by TPR threads, each thread ITERS
// vectors of VEC elements (VEC 8 bf16 or 4 f32: 16 bytes a load; VEC 1
// takes any H and alignment).  Rows of up to 1024 elements take one warp
// a row, eight rows a block, and reduce with warp shuffles alone; wider
// rows take a warpgroup (up to 4096) or the whole block (up to 8192) a
// row.  A block is 256 threads in every layout, so an SM holds up to 64
// rows' loads in flight (BERT's 768-wide bf16 rows: 3 KiB of x and r
// each), against the one row a block of the layout before, whose
// 96-thread rows left too few bytes in flight to cover the memory's
// latency.  The backward's grid is persistent (as many blocks as fit on
// the card), each block walking rows with a stride, so its dw partials
// stay few; its registers hold only the current row (the sums live in
// shared memory), so three blocks fit an SM at BERT's width and two at
// Llama's, where per-thread sums held in registers had fit one or two.
//
// What bounds it on an H100: bytes.  At the Llama training shape (8192
// rows of 4096 bf16) the forward reads x and r and writes h and y, 4 x 64
// MiB, for about 6 flops an element: 0.080 ms at 3.35 TB/s; the backward
// reads h, dy and dh and writes dx, the same 256 MiB.  The design point
// is that single pass each way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {

constexpr int kThreads = 256;   // every launch's block
constexpr int kMaxH = 8192;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// two 16-bit values as floats, and back (bf16 or f16 pairs)
__device__ __forceinline__ float2 pair_f(uint32_t u, __nv_bfloat16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ float2 pair_f(uint32_t u, __half*) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}
__device__ __forceinline__ uint32_t pair_of(float a, float b,
                                            __nv_bfloat16*) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pair_of(float a, float b, __half*) {
  const __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x rounded to T and widened back: the value a T tensor holds
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int VEC> struct Io;

template <> struct Io<1> {
  template <typename T>
  __device__ static void load(const T* p, float* f) { f[0] = to_f(*p); }
  template <typename T>
  __device__ static void store(T* p, const float* f) { *p = from_f<T>(f[0]); }
};

// VEC elements of a 16-bit type H (bf16 or f16) or of float
template <> struct Io<4> {
  template <typename H>
  __device__ static void load(const H* p, float* f) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = pair_f(u.x, (H*)nullptr), b = pair_f(u.y, (H*)nullptr);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
  __device__ static void load(const float* p, float* f) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  }
  template <typename H>
  __device__ static void store(H* p, const float* f) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pair_of(f[0], f[1], (H*)nullptr),
                   pair_of(f[2], f[3], (H*)nullptr));
  }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <> struct Io<8> {
  template <typename H>
  __device__ static void load(const H* p, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = pair_f(w[i], (H*)nullptr);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static void load(const float* p, float* f) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  template <typename H>
  __device__ static void store(H* p, const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = pair_of(f[2 * i], f[2 * i + 1], (H*)nullptr);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static void store(float* p, const float* f) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

// TPR threads a row, each holding ITERS vectors of VEC elements; a block
// holds kRows rows, of up to kWidth elements
template <int TPR_, int ITERS_, int VEC_> struct Layout {
  static constexpr int TPR = TPR_, ITERS = ITERS_, VEC = VEC_;
  static constexpr int kRows = kThreads / TPR;
  static constexpr int kWidth = TPR * ITERS * VEC;
  static_assert(TPR % 32 == 0 && kThreads % TPR == 0, "whole warps a row");
};

// the first column of a thread's vector `it`
template <class L> __device__ __forceinline__ int col(int it, int t) {
  return (it * L::TPR + t) * L::VEC;
}

// the sums of v[0..N) over the TPR threads of a row, in every thread of
// it.  `red` holds kThreads / 32 * N floats.  Every thread of the block
// calls it the same number of times (rows wider than a warp meet at
// __syncthreads).
template <int TPR, int N>
__device__ __forceinline__ void row_sum(float (&v)[N], float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
  if constexpr (TPR > 32) {
    constexpr int kWarps = TPR / 32;
    const int warp = threadIdx.x >> 5, first = warp - warp % kWarps;
    __syncthreads();                       // red may hold an earlier sum
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = red[first * N + k];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) s += red[(first + q) * N + k];
      v[k] = s;
    }
  }
}

// mean (0 for RMS) and rstd of a row held in v (0 past the row's end):
// the forward's and the backward's statistics, from this one code
template <bool LN, class L>
__device__ __forceinline__ void row_stats(
    const float (&v)[L::ITERS][L::VEC], int t, int H, float eps,
    float* red, float& mean, float& rstd) {
  float s[1] = {0.f};
#pragma unroll
  for (int it = 0; it < L::ITERS; ++it) {
    if (col<L>(it, t) < H) {
#pragma unroll
      for (int j = 0; j < L::VEC; ++j)
        s[0] = LN ? __fadd_rn(s[0], v[it][j])
                  : __fmaf_rn(v[it][j], v[it][j], s[0]);
    }
  }
  row_sum<L::TPR>(s, red);
  const float inv_h = 1.f / static_cast<float>(H);
  mean = 0.f;
  if (LN) {
    mean = __fmul_rn(s[0], inv_h);
    s[0] = 0.f;
#pragma unroll
    for (int it = 0; it < L::ITERS; ++it) {
      if (col<L>(it, t) < H) {
#pragma unroll
        for (int j = 0; j < L::VEC; ++j) {
          const float d = __fsub_rn(v[it][j], mean);
          s[0] = __fmaf_rn(d, d, s[0]);
        }
      }
    }
    row_sum<L::TPR>(s, red);
  }
  rstd = rsqrtf(__fadd_rn(__fmul_rn(s[0], inv_h), eps));
}

// X: x; T: r and h (X is T, or a 16-bit X under an f32 T); W: weight
// and bias; O: y (the promoted dtype)
template <typename X, typename T, typename W, typename O, bool LN, bool BIAS,
          class L>
__global__ void __launch_bounds__(kThreads)
add_norm_fwd(const X* __restrict__ x, const T* __restrict__ r,
             const W* __restrict__ w, const W* __restrict__ b,
             T* __restrict__ h, O* __restrict__ y, long long rows, int H,
             float eps) {
  constexpr int ITERS = L::ITERS, VEC = L::VEC;
  __shared__ float red[kThreads / 32];
  const int t = threadIdx.x % L::TPR;
  const long long row =
      static_cast<long long>(blockIdx.x) * L::kRows + threadIdx.x / L::TPR;
  const bool live = row < rows;
  const long long base = row * H;
  float v[ITERS][VEC];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = col<L>(it, t);
    if (live && i < H) {
      float a[VEC], c[VEC];
      Io<VEC>::load(x + base + i, a);
      Io<VEC>::load(r + base + i, c);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        v[it][j] = round_to<T>(__fadd_rn(c[j], a[j]));    // h = r + x
      Io<VEC>::store(h + base + i, v[it]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[it][j] = 0.f;
    }
  }
  float mean, rstd;
  row_stats<LN, L>(v, t, H, eps, red, mean, rstd);
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = col<L>(it, t);
    if (live && i < H) {
      float wf[VEC], bf[VEC], o[VEC];
      Io<VEC>::load(w + i, wf);
      if (BIAS) Io<VEC>::load(b + i, bf);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float n = LN ? __fmul_rn(__fsub_rn(v[it][j], mean), rstd)
                           : __fmul_rn(v[it][j], rstd);
        o[j] = round_to<O>(__fmul_rn(round_to<T>(n), wf[j]));
        if (BIAS) o[j] = round_to<O>(__fadd_rn(o[j], bf[j]));
      }
      Io<VEC>::store(y + base + i, o);
    }
  }
}

// The backward's dw (and db) sums live in shared memory, a row of
// kWidth floats per row group and sum, so that a thread holds no more
// than its current row: thread t's element j of vector it sits at
// slot<L>(it, t, j), float4 by float4 across the warp (no bank
// conflicts).
template <class L> __device__ __forceinline__ int slot(int it, int t, int j) {
  if constexpr (L::VEC >= 4)
    return ((it * (L::VEC / 4) + (j >> 2)) * L::TPR + t) * 4 + (j & 3);
  else
    return it * L::TPR + t;
}

// acc[0..VEC) += c at a thread's vector `it`
template <class L>
__device__ __forceinline__ void acc_add(float* acc, int it, int t,
                                        const float (&c)[L::VEC]) {
  if constexpr (L::VEC >= 4) {
#pragma unroll
    for (int q = 0; q < L::VEC / 4; ++q) {
      float4* p = reinterpret_cast<float4*>(acc + slot<L>(it, t, 4 * q));
      float4 a = *p;
      a.x = __fadd_rn(a.x, c[4 * q]);
      a.y = __fadd_rn(a.y, c[4 * q + 1]);
      a.z = __fadd_rn(a.z, c[4 * q + 2]);
      a.w = __fadd_rn(a.w, c[4 * q + 3]);
      *p = a;
    }
  } else {
    acc[slot<L>(it, t, 0)] = __fadd_rn(acc[slot<L>(it, t, 0)], c[0]);
  }
}

// Blocks of the backward resident on an SM: its registers hold one row,
// so narrow rows fit three blocks
template <class L> constexpr int bwd_min_blocks() {
  return L::ITERS * L::VEC <= 24 ? 3 : 2;
}

// the dynamic shared memory of a backward block: dw (and db) sums
template <class L, bool BIAS> constexpr int bwd_smem() {
  return L::kRows * L::kWidth * (BIAS ? 2 : 1) *
         static_cast<int>(sizeof(float));
}

// dx for the rows r0 + (the block's rows), walking the rows with a stride
// of the grid; part: [blocks, H] f32 sums of dw, then (BIAS) of db, each
// the block's row groups added in order.  dx is x's gradient in X; in
// the mixed mode (X narrower than T) dr gets the residual's, in T, and
// dx the same values rounded to X
template <typename X, typename T, typename W, typename O, bool LN, bool BIAS,
          class L>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks<L>())
add_norm_bwd(const T* __restrict__ h, const O* __restrict__ dy,
             const T* __restrict__ dh, const W* __restrict__ w,
             X* __restrict__ dx, T* __restrict__ dr, float* __restrict__ part,
             long long rows, int H, float eps) {
  constexpr int ITERS = L::ITERS, VEC = L::VEC;
  constexpr int NS = LN ? 3 : 1;
  constexpr int kSums = BIAS ? 2 : 1;
  __shared__ float red[kThreads / 32 * NS];
  extern __shared__ float4 acc_mem[];
  float* acc = reinterpret_cast<float*>(acc_mem);
  for (int i = threadIdx.x; i < L::kRows * L::kWidth * kSums; i += kThreads)
    acc[i] = 0.f;
  __syncthreads();
  const int t = threadIdx.x % L::TPR, grp = threadIdx.x / L::TPR;
  float* aw = acc + grp * L::kWidth * kSums;     // this group's dw sums
  float* ab = aw + L::kWidth;                    // and db's
  const float inv_h = 1.f / static_cast<float>(H);
  for (long long r0 = static_cast<long long>(blockIdx.x) * L::kRows;
       r0 < rows; r0 += static_cast<long long>(gridDim.x) * L::kRows) {
    const long long row = r0 + grp;
    const bool live = row < rows;
    const long long base = row * H;
    // h and dy are loaded together; g holds dy until it becomes the
    // gradient reaching the rounded normalised value
    float v[ITERS][VEC], g[ITERS][VEC];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = col<L>(it, t);
      if (live && i < H) {
        Io<VEC>::load(h + base + i, v[it]);
        Io<VEC>::load(dy + base + i, g[it]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[it][j] = g[it][j] = 0.f;
      }
    }
    float mean, rstd;
    row_stats<LN, L>(v, t, H, eps, red, mean, rstd);
    // g = dy * w in the product's dtype, then h's: one rounding to h's
    // dtype, as y's dtype is h's or f32.  s[0]: the sum of g * d; LN
    // also s[1]: of g, s[2]: of d
    float s[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) s[k] = 0.f;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = col<L>(it, t);
      if (live && i < H) {
        float wf[VEC], cw[VEC], cb[VEC];
        Io<VEC>::load(w + i, wf);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float e = g[it][j];
          cb[j] = e;
          const float d = LN ? __fsub_rn(v[it][j], mean) : v[it][j];
          const float n = round_to<T>(__fmul_rn(d, rstd));   // the forward's
          cw[j] = round_to<O>(__fmul_rn(e, n));
          const float gj = round_to<T>(__fmul_rn(e, wf[j]));
          g[it][j] = gj;
          v[it][j] = d;
          s[0] = __fmaf_rn(gj, d, s[0]);
          if constexpr (LN) {
            s[1] = __fadd_rn(s[1], gj);
            s[2] = __fadd_rn(s[2], d);
          }
        }
        acc_add<L>(aw, it, t, cw);
        if constexpr (BIAS) acc_add<L>(ab, it, t, cb);
      }
    }
    row_sum<L::TPR>(s, red);
    // d(rstd) through the variance (mean square): k per unit of d
    const float k = __fmul_rn(-__fmul_rn(__fmul_rn(s[0], rstd),
                                         __fmul_rn(rstd, rstd)), inv_h);
    // LN: the mean of the gradient reaching h, subtracted from each
    float c = 0.f;
    if constexpr (LN)
      c = __fmul_rn(__fadd_rn(__fmul_rn(rstd, s[1]), __fmul_rn(k, s[2])),
                    inv_h);
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = col<L>(it, t);
      if (live && i < H) {
        float q[VEC], o[VEC];
        if (dh != nullptr) Io<VEC>::load(dh + base + i, q);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float gh = __fadd_rn(__fmul_rn(g[it][j], rstd),
                                     __fmul_rn(v[it][j], k));
          o[j] = round_to<T>(LN ? __fsub_rn(gh, c) : gh);
          if (dh != nullptr) o[j] = round_to<T>(__fadd_rn(o[j], q[j]));
        }
        if constexpr (!std::is_same<X, T>::value)
          Io<VEC>::store(dr + base + i, o);
        Io<VEC>::store(dx + base + i, o);
      }
    }
  }
  // the block's partials: each column's row groups added in group order
  __syncthreads();
  for (int a = 0; a < kSums; ++a) {
    float* out =
        part + (static_cast<long long>(a) * gridDim.x + blockIdx.x) * H;
    for (int i = threadIdx.x; i < H; i += kThreads) {
      const int it = i / (L::TPR * VEC), rem = i % (L::TPR * VEC);
      const int at = slot<L>(it, rem / VEC, rem % VEC) + a * L::kWidth;
      float sum = acc[at];
      for (int q = 1; q < L::kRows; ++q)
        sum = __fadd_rn(sum, acc[q * L::kWidth * kSums + at]);
      out[i] = sum;
    }
  }
}

// dw (blockIdx.y 0) or db (1) from the [blocks, H] partials: 32 columns
// a block of kReduceThreads, each column summed over the blocks in 32
// strided slices, then the slices in order -- one fixed order for a
// given grid
constexpr int kReduceThreads = 1024;

template <typename W>
__global__ void __launch_bounds__(kReduceThreads)
add_norm_bwd_reduce(const float* __restrict__ part, int blocks, int H,
                    W* __restrict__ dw, W* __restrict__ db) {
  constexpr int kSlices = kReduceThreads / 32;
  __shared__ float red[kSlices][33];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float* p = part + static_cast<long long>(blockIdx.y) * blocks * H;
  float a = 0.f;
  if (c < H) {
#pragma unroll 4
    for (int b = slice; b < blocks; b += kSlices)
      a = __fadd_rn(a, p[static_cast<long long>(b) * H + c]);
  }
  red[slice][lane] = a;
  __syncthreads();
  if (slice == 0 && c < H) {
    float s = red[0][lane];
#pragma unroll
    for (int q = 1; q < kSlices; ++q) s = __fadd_rn(s, red[q][lane]);
    (blockIdx.y ? db : dw)[c] = from_f<W>(s);
  }
}

// y is 16-bit only when h and the weight share that dtype:
// torch.promote_types
template <typename T, typename W>
using Out = typename std::conditional<std::is_same<T, W>::value, T,
                                      float>::type;

// the layout of a row of H elements; f.run<...>().  Vectorised (vec 8),
// a thread moves 16 bytes of h's dtype a load: 8 16-bit or 4 f32 values
// (a warp's loads then cover one contiguous span; a narrower x is read
// at its own width, 8 bytes a load under an f32 h)
template <class F, typename X, typename T, typename W, bool LN, bool BIAS>
cudaError_t by_layout(F& f, int vec, int H) {
  constexpr int V = 16 / sizeof(T);
  if (vec == 8) {
    if (H <= 768)
      return f.template run<X, T, W, LN, BIAS,
                            Layout<32, 768 / 32 / V, V>>();
    if (H <= 1024)
      return f.template run<X, T, W, LN, BIAS,
                            Layout<32, 1024 / 32 / V, V>>();
    if (H <= 4096)
      return f.template run<X, T, W, LN, BIAS,
                            Layout<128, 4096 / 128 / V, V>>();
    return f.template run<X, T, W, LN, BIAS,
                          Layout<256, kMaxH / 256 / V, V>>();
  }
  return f.template run<X, T, W, LN, BIAS, Layout<256, kMaxH / 256, 1>>();
}

template <class F, typename X, typename T, typename W>
cudaError_t by_body(F& f, int ln, int has_bias, int vec, int H) {
  if (!ln) return by_layout<F, X, T, W, false, false>(f, vec, H);
  if (has_bias) return by_layout<F, X, T, W, true, true>(f, vec, H);
  return by_layout<F, X, T, W, true, false>(f, vec, H);
}

using bf16 = __nv_bfloat16;

// dtypes: 0 float32, 1 bfloat16, 2 float16.  x_dtype is x's (the
// narrower operand's in the mixed mode), h_dtype r's and h's.  Each
// translation unit that includes this header instantiates the
// combinations its PTT_ADD_NORM_CASES lists, PTT_CASE(key, X, T, W) with
// key = x_dtype * 9 + h_dtype * 3 + w_dtype, and refuses the others
// (cudaErrorInvalidValue): add_norm.cu x, r and h in one of float32 and
// bfloat16 with the weight in either; add_norm_half.cu float16 h with an
// f16 or f32 weight, and an f32 h with an f16 weight; add_norm_mixed.cu
// a 16-bit x over an f32 h with an f32 weight or one in x's dtype.  The
// split keeps each nvcc process near the others' build time, since the
// sources build in parallel
template <class F>
cudaError_t dispatch(F& f, int ln, int has_bias, int x_dtype, int h_dtype,
                     int w_dtype, int vec, int H) {
  switch (x_dtype * 9 + h_dtype * 3 + w_dtype) {
#define PTT_CASE(key, X, T, W) \
  case key:                    \
    return by_body<F, X, T, W>(f, ln, has_bias, vec, H);
    PTT_ADD_NORM_CASES
#undef PTT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

struct Forward {
  const void *x, *r, *w, *b;
  void *h, *y;
  long long rows;
  int H;
  float eps;
  cudaStream_t s;
  template <typename X, typename T, typename W, bool LN, bool BIAS, class L>
  cudaError_t run() {
    using O = Out<T, W>;
    const long long blocks = (rows + L::kRows - 1) / L::kRows;
    add_norm_fwd<X, T, W, O, LN, BIAS, L>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            static_cast<const X*>(x), static_cast<const T*>(r),
            static_cast<const W*>(w), static_cast<const W*>(b),
            static_cast<T*>(h), static_cast<O*>(y), rows, H, eps);
    return cudaGetLastError();
  }
};

// the backward's grid: as many blocks as are resident on the card at
// once, at most one a block of rows
struct BackwardGrid {
  long long rows;
  int blocks;
  template <typename X, typename T, typename W, bool LN, bool BIAS, class L>
  cudaError_t run() {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const auto kernel = add_norm_bwd<X, T, W, Out<T, W>, LN, BIAS, L>;
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bwd_smem<L, BIAS>());
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, bwd_smem<L, BIAS>());
    if (e != cudaSuccess) return e;
    const long long need = (rows + L::kRows - 1) / L::kRows;
    const long long most =
        static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    blocks = static_cast<int>(need < most ? need : most);
    return cudaSuccess;
  }
};

struct Backward {
  const void *h, *dy, *dh, *w;
  void *dx, *dr;
  float* part;
  void *dw, *db;
  long long rows;
  int H;
  float eps;
  int blocks;
  cudaStream_t s;
  template <typename X, typename T, typename W, bool LN, bool BIAS, class L>
  cudaError_t run() {
    using O = Out<T, W>;
    if (!std::is_same<X, T>::value && dr == nullptr)
      return cudaErrorInvalidValue;
    const auto kernel = add_norm_bwd<X, T, W, O, LN, BIAS, L>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bwd_smem<L, BIAS>());
    if (e != cudaSuccess) return e;
    add_norm_bwd<X, T, W, O, LN, BIAS, L>
        <<<blocks, kThreads, bwd_smem<L, BIAS>(), s>>>(
        static_cast<const T*>(h), static_cast<const O*>(dy),
        static_cast<const T*>(dh), static_cast<const W*>(w),
        static_cast<X*>(dx), static_cast<T*>(dr), part, rows, H, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    add_norm_bwd_reduce<W><<<dim3((H + 31) / 32, BIAS ? 2 : 1),
                             kReduceThreads, 0, s>>>(
        part, blocks, H, static_cast<W*>(dw), static_cast<W*>(db));
    return cudaGetLastError();
  }
};

}  // namespace ptt

extern "C" {

// ln: 0 RMSNorm, 1 LayerNorm (b may be null: no bias).  dtypes: 0 float32,
// 1 bfloat16, 2 float16; x in x_dtype, r and h in h_dtype (equal, or a
// 16-bit x over a float32 h: the mixed mode), w and b in w_dtype (see
// dispatch for the combinations), y in h's dtype when w shares it, else
// float32.  All operands contiguous; rows of H <= 8192 elements; vec 8
// needs H % 8 == 0 and 16-byte aligned pointers, vec 1 takes anything.
// Returns a cudaError_t.
int add_norm(int ln, const void* x, const void* r, const void* w,
             const void* b, void* h, void* y, long long rows, int H,
             float eps, int x_dtype, int h_dtype, int w_dtype, int vec,
             void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (H <= 0 || H > ptt::kMaxH || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  ptt::Forward f{x, r, w, b, h, y, rows, H, eps,
                 static_cast<cudaStream_t>(stream)};
  return ptt::dispatch(f, ln, b != nullptr, x_dtype, h_dtype, w_dtype, vec,
                       H);
}

// The backward's block count for these arguments (> 0), or minus a
// cudaError_t: the caller sizes add_norm_bwd's partials by it.
int add_norm_bwd_blocks(int ln, int has_bias, int x_dtype, int h_dtype,
                        int w_dtype, int vec, long long rows, int H) {
  if (rows <= 0 || H <= 0 || H > ptt::kMaxH) return -cudaErrorInvalidValue;
  ptt::BackwardGrid f{rows, 0};
  const cudaError_t e =
      ptt::dispatch(f, ln, has_bias, x_dtype, h_dtype, w_dtype, vec, H);
  return e == cudaSuccess ? f.blocks : -static_cast<int>(e);
}

// dx (x_dtype; with a narrower x also dr, the residual's, in h_dtype),
// dw and db (w_dtype; db null: no bias) from h (h_dtype), dy (y's dtype),
// dh (h_dtype; null: h's gradient unused) and w, with part an f32
// scratch of (db ? 2 : 1) * blocks * H elements and blocks from
// add_norm_bwd_blocks for the same arguments.  Operands as for add_norm
// (vec 8: h, dy, dh, w, dx and dr aligned).  Returns a cudaError_t.
int add_norm_bwd(int ln, const void* h, const void* dy, const void* dh,
                 const void* w, void* dx, void* dr, float* part, void* dw,
                 void* db, long long rows, int H, float eps, int x_dtype,
                 int h_dtype, int w_dtype, int vec, int blocks,
                 void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (H <= 0 || H > ptt::kMaxH || blocks <= 0) return cudaErrorInvalidValue;
  ptt::Backward f{h, dy, dh, w, dx, dr, part, dw, db, rows, H, eps, blocks,
                  static_cast<cudaStream_t>(stream)};
  return ptt::dispatch(f, ln, db != nullptr, x_dtype, h_dtype, w_dtype, vec,
                       H);
}

const char* add_norm_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
