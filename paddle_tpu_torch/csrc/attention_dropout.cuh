// In-kernel attention dropout: the keep bit of one attention probability,
// shared by the flash forward (flash_attention_fwd.cu), both backward
// kernels (flash_attention_bwd.cu) and the bias gradient
// (flash_attention_dbias.cu).
//
// Replaces `_dropout_keep` (paddle_tpu/ops/pallas/flash_attention.py),
// which seeds the TPU's hardware PRNG once per (b, h, q tile, k tile) at
// the TPU's tile sizes.  The port's kernels tile differently (64-row
// tiles here, others in a later revision), so the bit must not depend on
// any tile: it is a counter-based hash of the element's coordinates
//
//   x = mix(mix(mix(mix(mix(seed_lo, seed_hi), b), h), row), col)
//   mix(x, v) = fmix32((x ^ v) * 0x9E3779B1)       (mod 2^32)
//
// with murmur3's 32-bit finaliser, the query head h (not the kv head),
// the query row in [0, Sq) and the key column in [0, Sk).  An element is
// kept iff x >= min(floor(p * 2^32), 2^32 - 1), the reference's threshold
// rule, and a kept probability is scaled by 1 / (1 - p).  The plain
// PyTorch twin (`dropout_keep` in ops/flash_attention.py) computes the
// same bits with int64 tensors masked to 32 bits.
//
// The seed is a device int64 (the wrapper's per-call seed tensor), read
// by every thread: the host never learns it, so a step never syncs.  A
// block folds (seed, b, h) once, a thread each of its rows once, and one
// mix an element remains (five 32-bit multiplies and shifts).
#pragma once

#include <stdint.h>

namespace ptt {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t drop_mix(uint32_t x, uint32_t v) {
  return fmix32((x ^ v) * 0x9E3779B1u);
}

// The dropout state of one (batch, query head): its folded key, the
// keep threshold and the scale of a kept element.
struct Dropout {
  uint32_t key;
  uint32_t thresh;
  float inv;

  __device__ __forceinline__ void init(const long long* seed, int b, int h,
                                       uint32_t threshold, float inv_keep) {
    const unsigned long long s = static_cast<unsigned long long>(*seed);
    key = drop_mix(drop_mix(drop_mix((uint32_t)s, (uint32_t)(s >> 32)),
                            (uint32_t)b),
                   (uint32_t)h);
    thresh = threshold;
    inv = inv_keep;
  }
  // the key of query row r
  __device__ __forceinline__ uint32_t row(int r) const {
    return drop_mix(key, (uint32_t)r);
  }
  // x scaled by 1 / (1 - p) where the element (row key rk, column c) is
  // kept, else 0
  __device__ __forceinline__ float apply(uint32_t rk, int c, float x) const {
    return drop_mix(rk, (uint32_t)c) >= thresh ? x * inv : 0.f;
  }
};

}  // namespace ptt
