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
// Both routes follow the reference's grid (mb, mh, iq, ik, rb, rh): one
// block of 256 threads per (64-key tile, 64-row query tile, mask batch x
// mask head), looping over the bias's broadcast batches and heads inside
// the block and summing the 64 x 64 tile in registers in the loop's
// order, written once: no atomics, and the result does not depend on
// block order.  A tile wholly above the causal diagonal skips the loop
// and writes zeros, as the reference writes its zero accumulator.  The
// output is f32; the wrapper casts it to the bias's dtype.
//
// What bounds it on an H100: operations.  At GPT-2's shape (B 8, H 12,
// S 1024, D 64, causal) it does two S^2/2 x D products for each of the
// B x H heads against the bias gradient's 4-byte elements — about 50
// flops per byte at D 64 (more as the broadcast sum grows), above the
// ridge.  The f32 checks hold it to 1e-5 of the plain version, which one
// TF32 product misses, so the f32 route takes three (3xTF32, as the dQ
// and dK/dV kernels).
//
// - f32 at D 64 (the trained bias of GPT-2-width layers):
//   `flash_dbias_3xtf32`.  The FMA-pipe kernel it replaced ran
//   `encoder_bias`'s bias [1, 12, 1024, 1024] at 9.2x its 3xTF32 bound
//   (0.7183 ms on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).  Warpgroup
//   w owns keys 32 w .. 32 w + 31 of the tile and all 64 rows; S = Q K^T,
//   dP = dO V^T and dS are the dQ kernel's own stage (`sdp_issue_3xtf32`,
//   `ds_3xtf32` in attention_wgmma.cuh: Q and dO as hi and lo A tiles, K
//   and V as hi-over-lo B tiles, one m64n64 + one m64n32 product a k
//   step, the bias added on the fragments).  Each (b, h) of the loop
//   changes all four operands, so splitting them is the kernel's other
//   cost: the rows of the next (b, h) come by cp.async into the other of
//   two stages while this one's products run, and each thread splits the
//   chunks it copied in place (hi over the raw f32, lo into the lo tiles;
//   TF32 rounding by integer operations, `split_tf32<true>`, where
//   cvt.rna.tf32 was slower); 225 KB, one block an SM.  lse and delta
//   rows come into registers one (b, h) ahead.
// - 16-bit inputs and D 128: `flash_dbias` on the FMA pipe.  Each (b, h)
//   stages Q (pre-scaled) and dO of the 64 rows, and K and V of the 64
//   keys when (b, kv head) changes, in shared memory as f32, and takes
//   the score and dO V^T tile from the backward's shared tile code
//   (flash_bwd_tile.cuh), 4 x 4 a thread.
#include "attention_wgmma.cuh"
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

// ------------------------------------------------- f32, D 64: 3xTF32

constexpr int kDbTile = 64;    // query rows and keys a tile

// Shared memory of flash_dbias_3xtf32 (D 64): 2 stages of Q hi and dO hi
// [64][D] and K and V each as two hi-over-lo row tiles [64][D] (a
// warpgroup's 32 keys each); then Q lo and dO lo [64][D]; plus 1024 to
// align.  A stage's hi rows arrive as raw f32 rows by cp.async and are
// split in place.
template <int D>
struct DbiasTf32Smem {
  static constexpr int TB = kDbTile * D * 4;
  static constexpr int kStage = 6 * TB, LOFF = 2 * kStage;
  static constexpr size_t kBytes = LOFF + 2 * (size_t)TB + 1024;
};

template <int D, bool DROP>
__global__ void __launch_bounds__(256, 1)
flash_dbias_3xtf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ bias, float* __restrict__ dbias,
                   int B, int H, int KVH, int Sq, int Sk, int MB, int MH,
                   int causal, float scale, const long long* seed,
                   unsigned thresh, float inv_keep) {
  using Sm = DbiasTf32Smem<D>;
  constexpr int BT = kDbTile, TB = Sm::TB, CH = D / 4;
  constexpr int NC = BT * CH / 256;        // 16-byte chunks a thread a tile
  static_assert(D == 64, "a warpgroup's K / V tile is [2 x 32][64]");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = wg::smem_addr(smem);
  const int key0 = blockIdx.x * BT, row0 = blockIdx.y * BT;
  const int mbi = blockIdx.z / MH, mhi = blockIdx.z % MH;
  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, g = (tid & 31) >> 2, t4 = tid & 3;
  const int off = Sk - Sq;
  const long long qrs = (long long)H * D, krs = (long long)KVH * D;
  const long long tile = ((long long)blockIdx.z * Sq + row0) * Sk + key0;
  const int wk0 = key0 + 32 * w;          // this warpgroup's 32 keys
  wg::TfRows rw;
  rw.r_a = row0 + 16 * warp + g;
  rw.r_b = rw.r_a + 8;
  // element i of the thread's tile: row (i & 2 ? r_b : r_a), key
  // wk0 + 8 (i >> 2) + 2 t4 + (i & 1)
  auto key_of = [&](int i) { return wk0 + 8 * (i >> 2) + 2 * t4 + (i & 1); };
  // thread chunk p of each tile: row (or key) (tid + 256 p) / CH, columns
  // 4 ((tid + 256 p) % CH): its byte offset in a Q / dO tile and in the
  // K / V hi-over-lo tiles (the hi row)
  auto q_at = [&](int p) {
    const int i = tid + 256 * p;
    return wg::swz32<BT>(i / CH, (i % CH) * 4);
  };
  auto k_at = [&](int p) {
    const int i = tid + 256 * p, r = i / CH;
    return (r >> 5) * TB + wg::swz32<BT>(r & 31, (i % CH) * 4);
  };

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  // a tile with every key past the diagonal of its last row is all zero
  const bool live = !causal || key0 <= off + min(Sq - 1, row0 + BT - 1);
  const int rb = MB == 1 ? B : 1, rh = MH == 1 ? H : 1;
  const int n_it = live ? rb * rh : 0;
  // iteration it's batch and query head
  auto bh = [&](int it, int& b, int& h) {
    b = MB == 1 ? it / rh : mbi;
    h = MH == 1 ? it % rh : mhi;
  };
  // Iteration it's rows into stage s by cp.async, as they are (rows past
  // Sq or Sk zero): Q and dO rows row0.. into the Q / dO hi tiles, K and V
  // rows key0.. into the hi rows of their tiles; the thread's lse and
  // delta rows into registers
  float nl_a = 0.f, nl_b = 0.f, nd_a = 0.f, nd_b = 0.f;
  auto fetch = [&](int it, int s) {
    int b, h;
    bh(it, b, h);
    const long long qo = (long long)b * Sq * qrs + (long long)h * D;
    const long long ko =
        (long long)b * Sk * krs + (long long)(h / (H / KVH)) * D;
    const uint32_t st = base + s * Sm::kStage;
#pragma unroll
    for (int p = 0; p < NC; ++p) {
      const int i = tid + 256 * p, r = i / CH, c = (i % CH) * 4;
      const bool qok = row0 + r < Sq, kok = key0 + r < Sk;
      wg::cp16(st + q_at(p), qok ? q + qo + (row0 + r) * qrs + c : q, qok);
      wg::cp16(st + TB + q_at(p),
               qok ? dout + qo + (row0 + r) * qrs + c : dout, qok);
      wg::cp16(st + 2 * TB + k_at(p),
               kok ? k + ko + (key0 + r) * krs + c : k, kok);
      wg::cp16(st + 4 * TB + k_at(p),
               kok ? v + ko + (key0 + r) * krs + c : v, kok);
    }
    const long long lo = ((long long)b * H + h) * Sq;
    nl_a = rw.r_a < Sq ? lse[lo + rw.r_a] : 0.f;
    nl_b = rw.r_b < Sq ? lse[lo + rw.r_b] : 0.f;
    nd_a = rw.r_a < Sq ? delta[lo + rw.r_a] : 0.f;
    nd_b = rw.r_b < Sq ? delta[lo + rw.r_b] : 0.f;
  };
  // ... and split where they landed, each thread its own chunks (q scaled,
  // as the plain version: q * scale, rounded once): hi in place, lo into
  // the Q / dO lo tiles and the lo rows of the K / V tiles
  auto split = [&](int s) {
    const uint32_t st = s * Sm::kStage;
#pragma unroll
    for (int p = 0; p < NC; ++p) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {       // Q, dO, K, V
        const uint32_t at = st + (t < 2 ? t * TB + q_at(p)
                                        : (2 * t - 2) * TB + k_at(p));
        const float4 x = *reinterpret_cast<const float4*>(smem + at);
        const float m = t == 0 ? scale : 1.f;
        uint4 hi, lo;
        wg::split_tf32<true>(x.x * m, hi.x, lo.x);
        wg::split_tf32<true>(x.y * m, hi.y, lo.y);
        wg::split_tf32<true>(x.z * m, hi.z, lo.z);
        wg::split_tf32<true>(x.w * m, hi.w, lo.w);
        *reinterpret_cast<uint4*>(smem + at) = hi;
        *reinterpret_cast<uint4*>(
            smem + (t < 2 ? Sm::LOFF + t * TB + q_at(p) : at + 32 * 128)) = lo;
      }
    }
  };

  float bv[16];                       // this thread's bias elements
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = (i & 2) ? rw.r_b : rw.r_a, key = key_of(i);
    bv[i] = live && r < Sq && key < Sk
                ? bias[tile + (long long)(r - row0) * Sk + (key - key0)]
                : 0.f;
  }
  if (n_it > 0) fetch(0, 0);
  wg::cp_commit();
  Dropout drop;
  rw.rk_a = rw.rk_b = 0;
  for (int it = 0; it < n_it; ++it) {
    int b, h;
    bh(it, b, h);
    const int s = it & 1;
    rw.lse_a = nl_a;
    rw.lse_b = nl_b;
    rw.dl_a = nd_a;
    rw.dl_b = nd_b;
    rw.ml_a = rw.lse_a * wg::kLog2e;
    rw.ml_b = rw.lse_b * wg::kLog2e;
    __syncthreads();            // iteration it - 1's products are done
    if (it + 1 < n_it) fetch(it + 1, s ^ 1);
    wg::cp_commit();
    wg::cp_wait<1>();           // this thread's rows of iteration it
    split(s);
    wg::fence_async_smem();
    __syncthreads();

    float sc[32], dc[32];
    const uint32_t st = base + s * Sm::kStage;
    wg::sdp_issue_3xtf32<BT, D>(sc, dc, st, base + Sm::LOFF, st + TB,
                                base + Sm::LOFF + TB, st + 2 * TB + w * TB,
                                st + 4 * TB + w * TB);
    if constexpr (DROP) {
      drop.init(seed, b, h, thresh, inv_keep);
      rw.rk_a = drop.row(rw.r_a);
      rw.rk_b = drop.row(rw.r_b);
    }
    float ds[16];
    wg::ds_3xtf32<DROP>(ds, sc, dc, rw, wk0, t4, true, causal, off, Sq, Sk,
                        drop, [&](int i, int, int) { return bv[i]; });
    // summed in f32 in the order of the (b, h) loop: no atomics
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += ds[i];
  }
  if (n_it == 0) wg::cp_wait_all();

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = (i & 2) ? rw.r_b : rw.r_a, key = key_of(i);
    if (r < Sq && key < Sk)
      dbias[tile + (long long)(r - row0) * Sk + (key - key0)] = acc[i];
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

template <int D, bool DROP>
cudaError_t launch_3xtf32(const DbiasArgs& a) {
  const size_t smem = DbiasTf32Smem<D>::kBytes;
  static bool smem_set = false;
  cudaError_t e = allow_smem(flash_dbias_3xtf32<D, DROP>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sk + kDbTile - 1) / kDbTile,
                  (a.Sq + kDbTile - 1) / kDbTile, a.MB * a.MH);
  flash_dbias_3xtf32<D, DROP><<<grid, 256, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.bias, a.dbias, a.B, a.H, a.KVH, a.Sq, a.Sk, a.MB,
      a.MH, a.causal, a.scale, a.seed, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

// f32 at D 64 on 3xTF32 wgmma; 16-bit inputs and D 128 on the FMA pipe
template <typename T>
cudaError_t dispatch(int D, const DbiasArgs& a) {
  const bool drop = a.seed != nullptr;
  if (D == 64) {
    if constexpr (std::is_same<T, float>::value)
      return drop ? launch_3xtf32<64, true>(a) : launch_3xtf32<64, false>(a);
    else
      return drop ? launch<T, 64, true>(a) : launch<T, 64, false>(a);
  }
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
