// Shared online-softmax attention tile for the port's attention kernels
// (ragged_paged_attention.cu, flash_attention_fwd.cu).
//
// One block of NT = 256 threads owns BR = 64 query rows.  It streams the
// keys those rows may see through shared memory in tiles of BK = 64 rows
// (K and V in their storage type), and keeps the FlashAttention-2 state
// of each row — running max m, normaliser l, and the f32 accumulator —
// in registers.  Thread (ty, tx) = (tid / 16, tid % 16) owns query rows
// ty + 16 i (i < 4): it computes the 4 x 4 scores of those rows against
// keys tx + 16 j, and the output columns tx + 16 c (c < D / 16).  A
// row's 16 owners are one half-warp, so the row max and row sum are
// five-step shuffle reductions.
//
// What bounds it on an H100: the attention of the serving path is
// memory-bound (decode reads every cached page once per kv head for a
// few query rows), so the design point is that each K/V byte is read
// from device memory once per block, with 16-byte loads, and that the
// score and probability tiles never leave the SM.  Scores and the PV
// product use f32 FMAs, not tensor cores (wgmma is for a later
// revision); at the serving shapes this leaves the kernel bounded by
// the f32 pipe rather than by bytes, which PERF.md records.
//
// Where a context hides a key (`mask`), the score becomes -1e30 — the
// reference's masking value, not -inf — so a row whose first tiles are
// all hidden carries finite garbage that the rescale factor alpha =
// exp(m_old - m_new) removes once a visible key arrives, exactly as the
// reference's online softmax does.  Keys past the end of the key range
// (the ragged edge of the last tile) score -inf and never count.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ptt {

constexpr int BR = 64;          // query rows per block
constexpr int BK = 64;          // keys per shared-memory tile
constexpr int NT = 256;         // threads per block
constexpr float kMasked = -1e30f;

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
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// Shared-memory layout.  Row pitches are padded so the score loop's
// reads (16 different key rows, one column) fall in 16 different banks.
template <typename T, int D>
struct Tile {
  static constexpr int QLD = D + 1;                      // f32
  static constexpr int KLD = D + 4 / (int)sizeof(T);     // T
  static constexpr int PLD = BK + 1;                     // f32
  static constexpr size_t kBytes = (size_t)BR * QLD * 4 +
                                   2 * (size_t)BK * KLD * sizeof(T) +
                                   (size_t)BR * PLD * 4;
  float* q;
  T* k;
  T* v;
  float* p;
  __device__ explicit Tile(unsigned char* base) {
    q = reinterpret_cast<float*>(base);
    k = reinterpret_cast<T*>(base + (size_t)BR * QLD * 4);
    v = k + BK * KLD;
    p = reinterpret_cast<float*>(v + BK * KLD);
  }
};

// Per-row FlashAttention-2 state of one thread.
template <int D>
struct RowState {
  float m[4];
  float l[4];
  float acc[4][D / 16];
};

// Runs the attention of the block's BR rows over keys [0, ctx.key_end).
// Only the first ctx.rows rows have a query: row groups past them skip
// the two products (a decode descriptor has G = 4 live rows of 64).
// The context supplies:
//   int rows;                     rows of the block that have a query;
//   const T* q_row(int lr)        query row lr of the block, or nullptr;
//   long long k_off(int pos)      element offset of key pos in ctx.k, <0 if none;
//   long long v_off(int pos)      element offset of value pos in ctx.v;
//   float mask(int lr, int pos, float s)  the score after masking;
//   int key_end;  const T* k;  const T* v.
template <typename T, int D, class Ctx>
__device__ __forceinline__ void attend_rows(const Ctx& ctx, float scale,
                                            unsigned char* smem,
                                            RowState<D>& st) {
  using Sm = Tile<T, D>;
  constexpr int VEC = 16 / (int)sizeof(T);   // elements per 16-byte load
  constexpr int CH = D / VEC;                 // 16-byte chunks per row
  constexpr int DC = D / 16;                  // output columns per thread
  Sm sm(smem);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  // this thread's row groups i < nact have a query (uniform per thread)
  const int nact = ctx.rows > ty ? min(4, (ctx.rows - ty + 15) / 16) : 0;

  for (int idx = tid; idx < BR * D; idx += NT) {
    const int lr = idx / D, d = idx % D;
    const T* qr = ctx.q_row(lr);
    sm.q[lr * Sm::QLD + d] = qr ? to_f(qr[d]) * scale : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.m[i] = kMasked;
    st.l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) st.acc[i][c] = 0.f;
  }

  for (int t0 = 0; t0 < ctx.key_end; t0 += BK) {
    __syncthreads();   // previous tile's readers are done
    for (int idx = tid; idx < BK * CH; idx += NT) {
      const int row = idx / CH, c = idx % CH;
      const int pos = t0 + row;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (pos < ctx.key_end) {
        const long long ko = ctx.k_off(pos), vo = ctx.v_off(pos);
        if (ko >= 0) kv = *reinterpret_cast<const uint4*>(ctx.k + ko + c * VEC);
        if (vo >= 0) vv = *reinterpret_cast<const uint4*>(ctx.v + vo + c * VEC);
      }
      // padded rows are only 4-byte aligned: store word by word
      uint32_t* kd = reinterpret_cast<uint32_t*>(sm.k + row * Sm::KLD + c * VEC);
      uint32_t* vd = reinterpret_cast<uint32_t*>(sm.v + row * Sm::KLD + c * VEC);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    if (nact == 4) {                  // every row group live: 4 x 4 tile
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sm.q[(ty + 16 * i) * Sm::QLD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = to_f(sm.k[(tx + 16 * j) * Sm::KLD + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    } else if (nact > 0) {            // only the first nact groups live
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float kv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = to_f(sm.k[(tx + 16 * j) * Sm::KLD + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= nact) break;
          const float qv = sm.q[(ty + 16 * i) * Sm::QLD + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos = t0 + tx + 16 * j;
        s[i][j] = pos < ctx.key_end ? ctx.mask(lr, pos, s[i][j]) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(st.m[i], mx);
      const float alpha = expf(st.m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sm.p[lr * Sm::PLD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      st.l[i] = st.l[i] * alpha + sum;
      st.m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) st.acc[i][c] *= alpha;
    }
    __syncthreads();

    const int kn = nact > 0 ? min(BK, ctx.key_end - t0) : 0;
    if (nact == 4) {
      for (int kk = 0; kk < kn; ++kk) {
        float pv[4], vv[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = sm.p[(ty + 16 * i) * Sm::PLD + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) vv[c] = to_f(sm.v[kk * Sm::KLD + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) st.acc[i][c] = fmaf(pv[i], vv[c], st.acc[i][c]);
      }
    } else {
      for (int kk = 0; kk < kn; ++kk) {
        float vv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) vv[c] = to_f(sm.v[kk * Sm::KLD + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= nact) break;
          const float pv = sm.p[(ty + 16 * i) * Sm::PLD + kk];
#pragma unroll
          for (int c = 0; c < DC; ++c) st.acc[i][c] = fmaf(pv, vv[c], st.acc[i][c]);
        }
      }
    }
  }
}

// Sets the dynamic shared-memory limit of a kernel once, before its
// first launch (the tiles need more than the default 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

}  // namespace ptt
