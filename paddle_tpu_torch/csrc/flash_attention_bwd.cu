// FlashAttention-2 backward: a dQ kernel and a dK/dV kernel, with an
// additive mask, causal masking and GQA.
//
// Replaces the two TPU kernels behind `_bwd_impl`
// (paddle_tpu/ops/pallas/flash_attention.py): `_bwd_dq_kernel` (grid over
// query tiles, streams K/V) and `_bwd_dkv_kernel` (grid over key tiles,
// streams Q/dO over the query-head group).  Both rebuild the softmax from
// the forward's saved log-sum-exp, p = exp(s - lse), with s the scaled,
// masked score (masked scores -1e30, causal off = Sk - Sq, as the
// forward), and take delta = rowsum(dO * O) precomputed by the wrapper:
//   ds = p * (dO V^T - delta)
//   dQ = ds K / sqrt(D)            (dQ kernel)
//   dV = sum_g p^T dO,  dK = sum_g ds^T Q / sqrt(D)   (dK/dV kernel)
//
// Dropout mode (DROP = true, a seed pointer): both kernels regenerate the
// forward's keep bits (attention_dropout.cuh, a hash of seed, b, query
// head, query row, key column) and follow the reference's
// `_bwd_dq_kernel` / `_bwd_dkv_kernel`: dP = dO V^T is masked and scaled,
// dP' = keep ? dP / (1 - p) : 0, and ds = p * (dP' - delta); dV takes the
// dropped probabilities keep ? p / (1 - p) : 0.  delta = rowsum(dO * O)
// stays as it is, O already holding the dropout.  Each kernel computes
// one hash an element of the tiles it visits.
//
// Layout: contiguous [B, S, H, D] (q, dO, dQ) and [B, S, KVH, D] (k, v,
// dK, dV); lse and delta [B, H, Sq] f32; D 64 or 128; f32, bf16, f16.
//
// dQ kernel: one block of 256 threads per (64-row query tile, head,
// batch).  It keeps its Q (pre-scaled) and dO tiles in shared memory as
// f32 and loops over 64-key tiles up to the causal diagonal.  Thread
// (ty, tx) = (tid / 16, tid % 16) computes the 4 x 4 scores s and dO V^T
// of rows ty + 16 i against keys tx + 16 j, writes ds to shared memory,
// then accumulates dq for rows ty + 16 i, columns tx + 16 c in registers.
//
// dK/dV kernel: one block per (64-key tile, kv head, batch).  K and V stay
// in shared memory; the block loops over the G query heads of the group
// and over the query tiles that can see its keys (under causal masking
// from the first row with off + r >= key0), and accumulates dK and dV for
// keys ty + 16 i, columns tx + 16 c in registers across the whole group.
// Each kv head's dK/dV is written once: no atomics and no per-query-head
// partials, so the result does not depend on block order.
//
// What bounds it on an H100: operations.  At the training shape (S 8192
// causal, H 32, D 128) the backward does five S^2 D H / 2-sized products
// against some 100 MB of operands — thousands of flops per byte, far
// above the bf16 ridge of about 295.  This first revision runs every
// product on the f32 FMA pipe from shared memory (each kernel recomputes
// the scores and dO V^T it needs, seven products in all), far below the
// tensor-core rate; tensor cores (mma/wgmma) are the next step.  Reading
// each K/V (dQ) or Q/dO (dK/dV) tile once per 64-row tile keeps the bytes
// near the minimum.
#include "flash_bwd_tile.cuh"

namespace ptt {

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const float* __restrict__ mask, T* __restrict__ dq, int H,
             int KVH, int Sq, int Sk, long long msb, long long msh,
             long long msq, int causal, float scale, const long long* seed,
             unsigned thresh, float inv_keep) {
  using Sm = BwdTile<D>;
  constexpr int LD = Sm::LD, PLD = Sm::PLD, DC = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + BR * LD;
  float* sk = sdo + BR * LD;
  float* sv = sk + BK * LD;
  float* sds = sv + BK * LD;
  float* slse = sds + BR * PLD;
  float* sdelta = slse + BR;

  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int row0 = blockIdx.x * BR;
  const int rows = min(BR, Sq - row0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int off = Sk - Sq;
  const long long qrs = (long long)H * D, krs = (long long)KVH * D;
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* dob = dout + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Sk * KVH + kvh) * D;
  const T* vb = v + ((long long)b * Sk * KVH + kvh) * D;
  const float* mb = mask ? mask + b * msb + h * msh : nullptr;
  const long long lo = ((long long)b * H + h) * Sq;

  load_rows<T, D>(sq, qb, row0, rows, qrs, scale);
  load_rows<T, D>(sdo, dob, row0, rows, qrs, 1.f);
  if (tid < BR) {
    slse[tid] = tid < rows ? lse[lo + row0 + tid] : 0.f;
    sdelta[tid] = tid < rows ? delta[lo + row0 + tid] : 0.f;
  }
  const int key_end = causal ? min(Sk, off + row0 + rows) : Sk;
  Dropout drop;
  uint32_t rk[4];
  if constexpr (DROP) {
    drop.init(seed, b, h, thresh, inv_keep);
#pragma unroll
    for (int i = 0; i < 4; ++i) rk[i] = drop.row(row0 + ty + 16 * i);
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int t0 = 0; t0 < key_end; t0 += BK) {
    const int kn = min(BK, key_end - t0);
    __syncthreads();               // previous tile's readers are done
    load_rows<T, D>(sk, kb, t0, kn, krs, 1.f);
    load_rows<T, D>(sv, vb, t0, kn, krs, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_products<D>(sq, sk, sdo, sv, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = ty + 16 * i, r = row0 + lr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos = t0 + tx + 16 * j;
        float ds = 0.f;
        if (lr < rows && pos < key_end) {
          float sc = s[i][j];
          if (mb) sc += mb[(long long)r * msq + pos];
          if (causal && pos > off + r) sc = kMasked;
          float dpv = dp[i][j];
          if constexpr (DROP) dpv = drop.apply(rk[i], pos, dpv);
          ds = expf(sc - slse[lr]) * (dpv - sdelta[lr]);
        }
        sds[lr * PLD + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < kn; ++kk) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sds[(ty + 16 * i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = sk[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty + 16 * i;
    if (lr >= rows) continue;
    T* o = dq + (((long long)b * Sq + row0 + lr) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ mask, T* __restrict__ dk,
              T* __restrict__ dv, int H, int KVH, int Sq, int Sk,
              long long msb, long long msh, long long msq, int causal,
              float scale, const long long* seed, unsigned thresh,
              float inv_keep) {
  using Sm = BwdTile<D>;
  constexpr int LD = Sm::LD, PLD = Sm::PLD, DC = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + BK * LD;
  float* sq = sv + BK * LD;
  float* sdo = sq + BR * LD;
  float* sp = sdo + BR * LD;
  float* sds = sp + BK * PLD;
  float* slse = sds + BK * PLD;
  float* sdelta = slse + BR;

  const int kvh = blockIdx.y, b = blockIdx.z, G = H / KVH;
  const int key0 = blockIdx.x * BK;
  const int kn = min(BK, Sk - key0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int off = Sk - Sq;
  const long long qrs = (long long)H * D, krs = (long long)KVH * D;
  const T* kb = k + ((long long)b * Sk * KVH + kvh) * D;
  const T* vb = v + ((long long)b * Sk * KVH + kvh) * D;

  load_rows<T, D>(sk, kb, key0, kn, krs, 1.f);
  load_rows<T, D>(sv, vb, key0, kn, krs, 1.f);
  // the first query row that sees key0: off + r >= key0
  const int r_first = causal ? max(0, key0 - off) : 0;

  float adk[4][DC], adv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) adk[i][c] = adv[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + ((long long)b * Sq * H + h) * D;
    const T* dob = dout + ((long long)b * Sq * H + h) * D;
    const float* mb = mask ? mask + b * msb + h * msh : nullptr;
    const long long lo = ((long long)b * H + h) * Sq;
    Dropout drop;
    if constexpr (DROP) drop.init(seed, b, h, thresh, inv_keep);
    for (int r0 = (r_first / BR) * BR; r0 < Sq; r0 += BR) {
      const int rows = min(BR, Sq - r0);
      __syncthreads();             // previous tile's readers are done
      load_rows<T, D>(sq, qb, r0, rows, qrs, scale);
      load_rows<T, D>(sdo, dob, r0, rows, qrs, 1.f);
      if (tid < BR) {
        slse[tid] = tid < rows ? lse[lo + r0 + tid] : 0.f;
        sdelta[tid] = tid < rows ? delta[lo + r0 + tid] : 0.f;
      }
      __syncthreads();

      // keys ty + 16 i against query rows tx + 16 j
      float s[4][4], dp[4][4];
      tile_products<D>(sk, sq, sv, sdo, s, dp);
      uint32_t rk[4];
      if constexpr (DROP) {
#pragma unroll
        for (int j = 0; j < 4; ++j) rk[j] = drop.row(r0 + tx + 16 * j);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lk = ty + 16 * i, key = key0 + lk;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lq = tx + 16 * j, r = r0 + lq;
          float p = 0.f, ds = 0.f;
          if (lk < kn && lq < rows) {
            float sc = s[i][j];
            if (mb) sc += mb[(long long)r * msq + key];
            if (causal && key > off + r) sc = kMasked;
            p = expf(sc - slse[lq]);
            float dpv = dp[i][j];
            if constexpr (DROP) {
              dpv = drop.apply(rk[j], key, dpv);
              ds = p * (dpv - sdelta[lq]);
              p = drop.apply(rk[j], key, p);     // dV takes the dropped p
            } else {
              ds = p * (dpv - sdelta[lq]);
            }
          }
          sp[lk * PLD + lq] = p;
          sds[lk * PLD + lq] = ds;
        }
      }
      __syncthreads();

      for (int qq = 0; qq < rows; ++qq) {
        float pv[4], dsv[4], ov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sp[(ty + 16 * i) * PLD + qq];
          dsv[i] = sds[(ty + 16 * i) * PLD + qq];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          ov[c] = sdo[qq * LD + tx + 16 * c];
          qv[c] = sq[qq * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            adv[i][c] = fmaf(pv[i], ov[c], adv[i][c]);
            adk[i][c] = fmaf(dsv[i], qv[c], adk[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lk = ty + 16 * i;
    if (lk >= kn) continue;
    const long long o = (((long long)b * Sk + key0 + lk) * KVH + kvh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[o + tx + 16 * c] = from_f<T>(adk[i][c]);
      dv[o + tx + 16 * c] = from_f<T>(adv[i][c]);
    }
  }
}

// The operands of one backward launch, as the C entry points take them.
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *mask;
  void *o0, *o1;
  int B, H, KVH, Sq, Sk;
  const long long* ms;
  int causal;
  float scale;
  const long long* seed;
  unsigned thresh;
  float inv_keep;
  cudaStream_t stream;
};

template <typename T, int D, bool DROP>
cudaError_t launch_dq(const BwdArgs& a) {
  const size_t smem = BwdTile<D>::kDqBytes;
  static bool smem_set = false;
  cudaError_t e = allow_smem(flash_bwd_dq<T, D, DROP>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + BR - 1) / BR, a.H, a.B);
  flash_bwd_dq<T, D, DROP><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.mask, static_cast<T*>(a.o0), a.H, a.KVH, a.Sq, a.Sk,
      a.ms[0], a.ms[1], a.ms[2], a.causal, a.scale, a.seed, a.thresh,
      a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int D, bool DROP>
cudaError_t launch_dkv(const BwdArgs& a) {
  const size_t smem = BwdTile<D>::kDkvBytes;
  static bool smem_set = false;
  cudaError_t e = allow_smem(flash_bwd_dkv<T, D, DROP>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sk + BK - 1) / BK, a.KVH, a.B);
  flash_bwd_dkv<T, D, DROP><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.mask, static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.H,
      a.KVH, a.Sq, a.Sk, a.ms[0], a.ms[1], a.ms[2], a.causal, a.scale,
      a.seed, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int D, bool DROP>
cudaError_t launch(int which, const BwdArgs& a) {
  return which == 0 ? launch_dq<T, D, DROP>(a) : launch_dkv<T, D, DROP>(a);
}

template <typename T>
cudaError_t dispatch(int which, int D, const BwdArgs& a) {
  const bool drop = a.seed != nullptr;
  if (D == 64)
    return drop ? launch<T, 64, true>(which, a)
                : launch<T, 64, false>(which, a);
  if (D == 128)
    return drop ? launch<T, 128, true>(which, a)
                : launch<T, 128, false>(which, a);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_dtype(int which, int dtype, int D, const BwdArgs& a) {
  switch (dtype) {
    case 0:
      return dispatch<float>(which, D, a);
    case 1:
      return dispatch<__nv_bfloat16>(which, D, a);
    case 2:
      return dispatch<__half>(which, D, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace ptt

extern "C" {

// Operands contiguous: q, dout [B, Sq, H, D]; k, v [B, Sk, KVH, D]; lse,
// delta [B, H, Sq] f32; mask f32 with element strides b/h/q (0 where it
// broadcasts), null when there is none; dtype: 0 float32, 1 bfloat16,
// 2 float16; seed: the forward's device int64 dropout seed (null: no
// dropout), thresh the keep threshold and inv_keep 1 / (1 - p).  Each
// returns a cudaError_t.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const float* mask, void* dq,
                           int B, int H, int KVH, int Sq, int Sk, int D,
                           const long long* mask_strides, int causal,
                           float scale, int dtype, const long long* seed,
                           unsigned thresh, float inv_keep, void* stream) {
  const ptt::BwdArgs a{q, k, v, dout, lse, delta, mask, dq, nullptr, B, H,
                       KVH, Sq, Sk, mask_strides, causal, scale, seed,
                       thresh, inv_keep, static_cast<cudaStream_t>(stream)};
  return ptt::dispatch_dtype(0, dtype, D, a);
}

int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const float* mask, void* dk,
                            void* dv, int B, int H, int KVH, int Sq, int Sk,
                            int D, const long long* mask_strides, int causal,
                            float scale, int dtype, const long long* seed,
                            unsigned thresh, float inv_keep, void* stream) {
  const ptt::BwdArgs a{q, k, v, dout, lse, delta, mask, dk, dv, B, H, KVH,
                       Sq, Sk, mask_strides, causal, scale, seed, thresh,
                       inv_keep, static_cast<cudaStream_t>(stream)};
  return ptt::dispatch_dtype(1, dtype, D, a);
}

const char* flash_bwd_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
