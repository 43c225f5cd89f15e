// The gradient of a trained additive attention bias.
//
// Replaces the TPU kernel `_bwd_dmask_kernel` behind `_bwd_dmask`
// (paddle_tpu/ops/pallas/flash_attention.py): for a bias [MB, MH, Sq, Sk]
// with MB in {1, B} and MH in {1, H} added to the scaled score,
//
//   dbias[mb, mh, r, c] = sum over the broadcast (b, h) of p * (dP' - delta)
//
// with p = exp(s * scale + bias - lse) rebuilt from the forward's saved
// lse (causal cut at off = Sk - Sq: masked scores -1e30, so p = 0 there),
// dP' = dO V^T with the forward's dropout keep bits and 1 / (1 - p)
// applied when the forward dropped (attention_dropout.cuh), and delta =
// rowsum(O * dO) from the wrapper, the same one the dQ and dK/dV kernels
// take.  GQA: query head h reads kv head h / (H / KVH).
//
// Design, as the reference's grid (mb, mh, iq, ik, rb, rh) and the port's
// dK/dV kernel: one block of 256 threads per (64-key tile, 64-row query
// tile, mask batch x mask head).  It loops over the bias's broadcast
// batches and heads inside the block, accumulates the 64 x 64 tile in
// registers (4 x 4 a thread) and writes it once: no atomics, and the
// result does not depend on block order.  Each (b, h) of the loop stages
// Q (pre-scaled) and dO of the 64 rows, and K and V of the 64 keys when
// (b, kv head) changes, in shared memory as f32, and computes the score
// and dO V^T tile with the backward's shared tile code
// (flash_bwd_tile.cuh).  A tile wholly above the causal diagonal skips
// the loop and writes zeros, as the reference writes its zero
// accumulator.  The output is f32; the wrapper casts it to the bias's
// dtype.
//
// What bounds it on an H100: operations.  At GPT-2's shape (B 8, H 12,
// S 1024, D 64, causal) it does two S^2/2 x D products for each of the
// B x H heads against the bias gradient's 4-byte elements — about 50
// flops per byte at D 64 (more as the broadcast sum grows), above the
// ridge.  This first revision runs the products on the f32 FMA pipe
// from shared memory, far below the tensor-core rate, as the other
// backward kernels do.
#include "flash_bwd_tile.cuh"

namespace ptt {

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(NT)
flash_dbias(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const float* __restrict__ bias, float* __restrict__ dbias, int B,
            int H, int KVH, int Sq, int Sk, int MB, int MH, int causal,
            float scale, const long long* seed, unsigned thresh,
            float inv_keep) {
  using Sm = BwdTile<D>;
  constexpr int LD = Sm::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + BR * LD;
  float* sk = sdo + BR * LD;
  float* sv = sk + BK * LD;
  float* slse = sv + BK * LD;
  float* sdelta = slse + BR;

  const int key0 = blockIdx.x * BK, row0 = blockIdx.y * BR;
  const int mbi = blockIdx.z / MH, mhi = blockIdx.z % MH;
  const int rows = min(BR, Sq - row0), kn = min(BK, Sk - key0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int off = Sk - Sq;
  const long long qrs = (long long)H * D, krs = (long long)KVH * D;
  const long long tile = ((long long)blockIdx.z * Sq + row0) * Sk + key0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // a tile with every key past the diagonal of its last row is all zero
  const bool live = !causal || key0 <= off + row0 + rows - 1;
  if (live) {
    float bv[4][4];                  // this thread's bias elements
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lr = ty + 16 * i, lk = tx + 16 * j;
        bv[i][j] = lr < rows && lk < kn
                       ? bias[tile + (long long)lr * Sk + lk] : 0.f;
      }
    const int rb = MB == 1 ? B : 1, rh = MH == 1 ? H : 1;
    int kv_loaded = -1;              // the (b, kv head) whose K/V are staged
    for (int ib = 0; ib < rb; ++ib) {
      const int b = MB == 1 ? ib : mbi;
      for (int ih = 0; ih < rh; ++ih) {
        const int h = MH == 1 ? ih : mhi, kvh = h / (H / KVH);
        const long long lo = ((long long)b * H + h) * Sq;
        __syncthreads();             // previous tile's readers are done
        load_rows<T, D>(sq, q + ((long long)b * Sq * H + h) * D, row0, rows,
                        qrs, scale);
        load_rows<T, D>(sdo, dout + ((long long)b * Sq * H + h) * D, row0,
                        rows, qrs, 1.f);
        if (b * KVH + kvh != kv_loaded) {
          const long long ko = ((long long)b * Sk * KVH + kvh) * D;
          load_rows<T, D>(sk, k + ko, key0, kn, krs, 1.f);
          load_rows<T, D>(sv, v + ko, key0, kn, krs, 1.f);
          kv_loaded = b * KVH + kvh;
        }
        if (tid < BR) {
          slse[tid] = tid < rows ? lse[lo + row0 + tid] : 0.f;
          sdelta[tid] = tid < rows ? delta[lo + row0 + tid] : 0.f;
        }
        __syncthreads();

        float s[4][4], dp[4][4];
        tile_products<D>(sq, sk, sdo, sv, s, dp);
        Dropout drop;
        if constexpr (DROP) drop.init(seed, b, h, thresh, inv_keep);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int lr = ty + 16 * i, r = row0 + lr;
          uint32_t rk = 0;
          if constexpr (DROP) rk = drop.row(r);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int lk = tx + 16 * j, pos = key0 + lk;
            if (lr >= rows || lk >= kn) continue;
            float sc = s[i][j] + bv[i][j];
            if (causal && pos > off + r) sc = kMasked;
            float dpv = dp[i][j];
            if constexpr (DROP) dpv = drop.apply(rk, pos, dpv);
            acc[i][j] += expf(sc - slse[lr]) * (dpv - sdelta[lr]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty + 16 * i;
    if (lr >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lk = tx + 16 * j;
      if (lk < kn) dbias[tile + (long long)lr * Sk + lk] = acc[i][j];
    }
  }
}

struct DbiasArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *bias;
  float* dbias;
  int B, H, KVH, Sq, Sk, MB, MH, causal;
  float scale;
  const long long* seed;
  unsigned thresh;
  float inv_keep;
  cudaStream_t stream;
};

template <typename T, int D, bool DROP>
cudaError_t launch(const DbiasArgs& a) {
  const size_t smem = BwdTile<D>::kDbiasBytes;
  static bool smem_set = false;
  cudaError_t e = allow_smem(flash_dbias<T, D, DROP>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sk + BK - 1) / BK, (a.Sq + BR - 1) / BR, a.MB * a.MH);
  flash_dbias<T, D, DROP><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.bias, a.dbias, a.B, a.H, a.KVH, a.Sq, a.Sk, a.MB, a.MH,
      a.causal, a.scale, a.seed, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const DbiasArgs& a) {
  const bool drop = a.seed != nullptr;
  if (D == 64)
    return drop ? launch<T, 64, true>(a) : launch<T, 64, false>(a);
  if (D == 128)
    return drop ? launch<T, 128, true>(a) : launch<T, 128, false>(a);
  return cudaErrorInvalidValue;
}

}  // namespace ptt

extern "C" {

// Operands contiguous: q, dout [B, Sq, H, D]; k, v [B, Sk, KVH, D]; lse,
// delta [B, H, Sq] f32; bias and dbias f32 [MB, MH, Sq, Sk]; dtype: 0
// float32, 1 bfloat16, 2 float16; seed: the forward's device int64
// dropout seed (null: no dropout), thresh the keep threshold and
// inv_keep 1 / (1 - p).  Returns a cudaError_t.
int flash_attention_dbias(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const float* bias,
                          float* dbias, int B, int H, int KVH, int Sq,
                          int Sk, int D, int MB, int MH, int causal,
                          float scale, int dtype, const long long* seed,
                          unsigned thresh, float inv_keep, void* stream) {
  const ptt::DbiasArgs a{q, k, v, dout, lse, delta, bias, dbias, B, H, KVH,
                         Sq, Sk, MB, MH, causal, scale, seed, thresh,
                         inv_keep, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return ptt::dispatch<float>(D, a);
    case 1:
      return ptt::dispatch<__nv_bfloat16>(D, a);
    case 2:
      return ptt::dispatch<__half>(D, a);
  }
  return cudaErrorInvalidValue;
}

const char* flash_dbias_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
