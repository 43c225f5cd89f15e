// Shared definitions of the port's attention kernels: the FMA-pipe tile
// geometry of the f32 flash backward and bias-gradient kernels (BR query
// rows and BK keys a tile, NT threads a block; flash_bwd_tile.cuh), the
// reference's masking value, conversions between the element types and
// f32, and the dynamic shared-memory opt-in.  Pulls in the dropout keep
// bit (attention_dropout.cuh) for the kernels that include it through
// attention_wgmma.cuh.
//
// Where a kernel hides a key, the score becomes kMasked = -1e30 (the
// reference's masking value, not -inf), so a row whose first tiles are
// all hidden carries finite garbage that the rescale factor alpha =
// exp(m_old - m_new) removes once a visible key arrives, exactly as the
// reference's online softmax does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_dropout.cuh"

namespace ptt {

constexpr int BR = 64;          // query rows a tile
constexpr int BK = 64;          // keys a tile
constexpr int NT = 256;         // threads a block
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
