// Shared tile code of the flash backward kernels (flash_attention_bwd.cu:
// dQ and dK/dV) and of the bias gradient (flash_attention_dbias.cu).
//
// A block of NT = 256 threads stages 64-row tiles of one head in shared
// memory as f32 ([64][D + 1]: the padded pitch puts the 16 rows a
// column read touches in 16 banks) and computes two 64 x 64 products of
// them at once: thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i
// of the first operand of each product and rows tx + 16 j of the second
// (i, j < 4), so the score s = Q K^T and dP = dO V^T of one tile pair
// come from one pass over D with four loads a step and 32 FMAs.
#pragma once

#include "attention_tile.cuh"

namespace ptt {

template <int D>
struct BwdTile {
  static constexpr int LD = D + 1;       // f32 row pitch: conflict-free columns
  static constexpr int PLD = BK + 1;     // f32 pitch of the p / ds tiles
  // dQ: q, dO [BR][LD]; k, v [BK][LD]; ds [BR][PLD]; lse, delta [BR]
  static constexpr size_t kDqBytes =
      ((size_t)(2 * BR + 2 * BK) * LD + (size_t)BR * PLD + 2 * BR) * 4;
  // dK/dV: k, v [BK][LD]; q, dO [BR][LD]; p, ds [BK][PLD]; lse, delta [BR]
  static constexpr size_t kDkvBytes =
      ((size_t)(2 * BR + 2 * BK) * LD + (size_t)2 * BK * PLD + 2 * BR) * 4;
  // dbias: q, dO [BR][LD]; k, v [BK][LD]; lse, delta [BR]
  static constexpr size_t kDbiasBytes =
      ((size_t)(2 * BR + 2 * BK) * LD + 2 * BR) * 4;
};

// Copies rows [r0, r0 + n) of one head (row stride rs elements) into a
// f32 shared tile [64][D + 1], multiplied by `scale`; rows past n are 0.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int n, long long rs, float scale) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CH = D / VEC;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += NT) {
    const int row = idx / CH, c = idx % CH;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row < n)
      raw = *reinterpret_cast<const uint4*>(src + (long long)(r0 + row) * rs +
                                            c * VEC);
    const T* e = reinterpret_cast<const T*>(&raw);
    float* d = dst + row * BwdTile<D>::LD + c * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) d[i] = to_f(e[i]) * scale;
  }
}

// s[i][j] = a1[ty + 16 i] . b1[tx + 16 j] and dp[i][j] = a2[ty + 16 i] .
// b2[tx + 16 j] over D, for f32 tiles of pitch D + 1, summed in order of
// d with one FMA chain each.
template <int D>
__device__ __forceinline__ void tile_products(const float* a1,
                                              const float* b1,
                                              const float* a2,
                                              const float* b2, float s[4][4],
                                              float dp[4][4]) {
  constexpr int LD = BwdTile<D>::LD;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], cv[4], bv[4], ev[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a1[(ty + 16 * i) * LD + d];
      cv[i] = a2[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = b1[(tx + 16 * j) * LD + d];
      ev[j] = b2[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(cv[i], ev[j], dp[i][j]);
      }
  }
}

}  // namespace ptt
