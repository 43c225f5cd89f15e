// Int8 KV pools: per-token absmax quantization of a row in a warp, and
// the unpacking of 16-byte pool chunks, for the port's paged attention
// kernels (paged_decode_attention.cu, ragged_paged_attention.cu).
//
// Pools hold int8 codes with one f32 scale per token row (the scale
// pools [KVH, n_pages, P]).  A row is quantized exactly as
// quantization/ops.py quantize_rows does, so kernel and plain version
// write the same codes and scale bit for bit: the row in the model's
// dtype widened to f32, absmax over D, scale = max(absmax, 1e-8) / 127
// and codes = clip(rint(x / scale), -127, 127) with IEEE divisions
// (__fdiv_rn, whatever the flags) and round-half-to-even (rintf).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ptt {

__device__ __forceinline__ float elem_f(float x) { return x; }
__device__ __forceinline__ float elem_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float elem_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float elem_f(int8_t x) { return (float)x; }

// The 16 / sizeof(TP) elements of a 16-byte pool chunk as f32.
template <typename TP>
__device__ __forceinline__ void unpack16(const uint4& u, float* f) {
  const TP* e = reinterpret_cast<const TP*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(TP); ++i) f[i] = elem_f(e[i]);
}

// One warp quantizes the D-element row `src` (model dtype T) into the
// int8 codes `dst` and the f32 scale `*scale_dst`.  Lane l owns
// elements [l * D/32, (l + 1) * D/32).  Every lane of the warp calls it.
template <typename T, int D>
__device__ __forceinline__ void quantize_row_warp(const T* src, int8_t* dst,
                                                  float* scale_dst, int lane) {
  constexpr int E = D / 32;
  float x[E];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    x[i] = elem_f(src[lane * E + i]);
    amax = fmaxf(amax, fabsf(x[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float c = fminf(fmaxf(rintf(__fdiv_rn(x[i], scale)), -127.f), 127.f);
    dst[lane * E + i] = (int8_t)c;
  }
  if (lane == 0) *scale_dst = scale;
}

}  // namespace ptt
