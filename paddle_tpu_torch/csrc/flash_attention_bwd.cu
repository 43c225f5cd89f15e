// FlashAttention-2 backward: a dQ kernel (#3) and a dK/dV kernel (#4),
// with an additive mask, causal masking and GQA.
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
// What bounds it on an H100: operations.  At the training shape (S 8192
// causal, H 32, D 128) the dK/dV kernel does four S^2 D H / 2-sized
// products (1.1 TFLOP) and the dQ kernel three (6 D H pairs: 0.83 TFLOP,
// 0.83 ms at 989 TFLOP/s), against some 100 MB of operands -- thousands
// of flops per byte, far above the bf16 ridge of about 295.  So the
// 16-bit products belong on the tensor cores, and so do f32 ones: the
// f32 checks hold the backward to 1e-5 of the plain version, which one
// TF32 product (10 mantissa bits) misses, but three hold (3xTF32: x =
// hi + lo, hi the TF32 rounding of x and lo that of x - hi, a product
// taken as hi hi' + hi lo' + lo hi', about 2^-22 of it left out), at
// 495 / 3 TFLOP/s against the FMA pipe's 67.
//
// dQ kernel: one block per (query tile, head, batch).
// - bf16 / f16: `flash_bwd_dq_wgmma` (attention_wgmma.cuh), 128 query
//   rows a block, 64 per warpgroup (the M dimension of every product).
//   Q and dO are copied once into swizzled tiles and the rows' lse and
//   delta kept in registers; K/V tiles of 64 keys stream through a
//   2-stage cp.async ring up to the block's causal diagonal, the next
//   tile's copy in flight during this tile's three products.  S = Q K^T
//   and dP = dO V^T run on wgmma as two groups (m64n64k16, all four
//   operands K-major in shared memory); P is built on the accumulator
//   fragments while dP runs (ex2 with log2(e) folded in; masks only on a
//   masked, diagonal or ragged tile, the subtraction s - lse first so a
//   row whose every key is hidden weighs them all alike, as the plain
//   version does).  dS = P (dP' - delta), dropped by the forward's keep
//   bits in dropout mode, is rounded to 16 bits in registers and fed
//   back as the register A operand of dQ += dS K (m64n<D>k16, K MN-major
//   through the transpose bit: no transposed copy).  dQ takes the scale
//   once, in the epilogue, and leaves through shared memory with 16-byte
//   stores: each row is written once, without atomics.  Query tiles
//   with the most keys launch first, heads fastest.
// - f32 at D 64 (GPT-2's attention): `flash_bwd_dq_3xtf32`, 128 query
//   rows a block, 64 per warpgroup.  The FMA-pipe kernel it replaced ran
//   GPT-2's dropout backward at 8.0x its 3xTF32 bound (0.9341 ms on an
//   NVIDIA H100 80GB HBM3 at 700 W, PERF.md).  Q (scaled, as the plain
//   version scales it) and dO are split once into TF32 hi / lo A tiles
//   [128][64] (128 KB).  Key tiles of 32 pass through a 2-stage ring (48
//   KB a stage): K and V each as a hi-over-lo row tile [64][64] (the 32
//   keys' hi rows over their lo rows), the B operand of S = Q K^T and
//   dP = dO V^T (a k step is one m64n64 product, hi against hi and lo at
//   once, and one m64n32, lo against hi: the same stage as the bias
//   gradient's, `sdp_issue_3xtf32` / `ds_3xtf32`); and K again as
//   transposed hi / lo tiles [64][32] in `key_slot` order, the B operand
//   of dQ += dS K with dS's hi / lo parts as the register A operand
//   (`frag_a_tf32`).  TF32 wgmma has no transpose bit, so this is #4's
//   problem mirrored: #4 stages Q^T and dO^T.  Each thread reads its
//   chunks of the tile after next into registers and splits the next
//   tile into the free stage while this tile's products run; TF32
//   rounding by integer operations (`split_tf32<true>`, where
//   cvt.rna.tf32 was slower).  Each tile's dQ is summed in a fresh
//   accumulator and added to the running sum by f32 adds (chained in
//   the tensor cores' accumulator over 1024 keys, #4's sums drifted
//   1.2e-5); each element's keep bit is hashed once; masks only on the
//   tiles that need them.  225 KB: one block an SM, query tiles with the
//   most keys first.  A 32-key tile leaves room for the second stage
//   (64-key tiles take 96 KB a stage, one stage); warpgroups freed from
//   the block's barrier by an mbarrier ring were slower (PERF.md).
// - f32 at D 128 (the f32 reference checks): `flash_bwd_dq` on the FMA
//   pipe (flash_bwd_tile.cuh): 64 rows a block, Q (pre-scaled) and dO in
//   shared memory as f32, 4 x 4 register tiles of s and dO V^T, ds
//   through shared memory, dq accumulated in registers.  At D 128 the
//   hi / lo tiles of Q and dO take 256 KB for 128 rows (128 KB for 64)
//   and those of K, V and K^T 96 KB a 32-key stage: they do not fit an
//   SM's 227 KB.
//
// dK/dV kernel: one block per (key tile, kv head, batch).  K and V stay
// in shared memory; the block loops over the G query heads of the group
// and over the query tiles that can see its keys (under causal masking
// from the first row with off + r >= key0), and accumulates dK and dV in
// registers across the whole group.  Each kv head's dK/dV is written
// once: no atomics and no per-query-head partials, so the result does
// not depend on block order.  Key tiles launch with the most query tiles
// (the first keys, under causal masking) first.
// - bf16 / f16: `flash_bwd_dkv_wgmma` (attention_wgmma.cuh), 128 keys a
//   block, 64 per warpgroup (the M dimension of every product).  Q/dO
//   tiles of 64 rows and their lse/delta rows stream through a 2-stage
//   cp.async ring, the next tile's copy in flight during this tile's
//   four products.  S^T = K Q^T and dP^T = V dO^T run on wgmma
//   (m64n64k16, K/V and Q/dO K-major in shared memory); P^T and dS^T are
//   built on the accumulator fragments in f32 (exp2f with log2(e)
//   folded in; masks only where the tile needs them), rounded to 16 bits
//   in registers and fed back as the register A operand of dV += P^T dO
//   and dK += dS^T Q (m64n<D>k16, dO and Q MN-major: the transpose bit).
//   dK takes the scale once, in the epilogue; dK and dV leave through
//   shared memory with 16-byte stores.
// - f32 at D 64 (GPT-2's attention): `flash_bwd_dkv_3xtf32`, 128 keys a
//   block, 64 per warpgroup.  The FMA-pipe kernel it replaced ran GPT-2's
//   dropout backward at 7.8x its 3xTF32 bound (1.21 ms, PERF.md).  K and
//   V are split once into hi / lo TF32 tiles [128][64] (128 KB).  Query
//   tiles of 32 rows: TF32 wgmma has no transpose bit, so q (scaled, as
//   the plain version scales it) and dO are each staged twice: a row
//   tile [64][64] holding the hi rows over the lo rows, the K-major B
//   operand of S^T = K Q^T and dP^T = V dO^T (a k step is one m64n64
//   product, hi against hi and lo at once, and one m64n32, lo against
//   hi: K is read from shared memory twice, where three m64n32 products
//   read it three times, 0.53 -> 0.49 ms), and hi / lo transposed tiles
//   [64][32], the B operand of dV += P^T dO and dK += dS^T Q (m64n64k8,
//   P^T / dS^T hi / lo as the register A operand from `frag_a_tf32`).
//   That operand holds accumulator columns 2 t4, 2 t4 + 1 as its k slots
//   t4, t4 + 4, so the transposed tiles store each 8-row slice in
//   `key_slot` order {0, 2, 4, 6, 1, 3, 5, 7}.  A tile's dV (then dK)
//   is summed in a fresh accumulator and added to the running sums by
//   f32 adds: chained in the tensor cores' own accumulator over GPT-2's
//   1024 rows, the sums drifted 1.2e-5 off the plain version.  The 64 KB
//   of query tiles keep a block in 194 KB, one an SM (232 registers);
//   the next tile's q / dO rows come into registers while this tile's
//   products run.  lse and delta are read by column (the query rows are
//   wgmma's N), each element's keep bit hashed once for P and dP.  Masks
//   as the 16-bit kernel; dK needs no scale (q is scaled).
// - f32 at D 128 (the f32 reference checks, not a timed path):
//   `flash_bwd_dkv` on the FMA pipe, 64 keys a block, 4 x 4 register
//   tiles (flash_bwd_tile.cuh): at D 128 the K / V hi / lo tiles alone
//   take 128 KB for 64 keys, and with 32-row query tiles (128 KB) a
//   block would not fit an SM.
#include "attention_wgmma.cuh"
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

constexpr int kBwdKeys = 128;   // keys a block of the wgmma dK/dV kernel

// Query rows a Q/dO tile: 64, or 32 in dropout mode, whose keep bits take
// registers.
template <bool DROP>
__host__ __device__ constexpr int bwd_rows() {
  return DROP ? 32 : 64;
}

// Shared memory of flash_bwd_dkv_wgmma: K and V, then 2 stages of Q, dO,
// lse and delta (each stage padded to 1024 bytes), plus 1024 to align.
template <int D, bool DROP>
struct DkvWgmmaSmem {
  static constexpr int BQ = bwd_rows<DROP>();
  static constexpr int KB = kBwdKeys * D * 2, QB = BQ * D * 2;
  static constexpr int kStage = 2 * QB + 1024;
  static constexpr size_t kBytes = 2 * (size_t)KB + 2 * (size_t)kStage + 1024;
};

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ mask, T* __restrict__ dk,
                    T* __restrict__ dv, int H, int KVH, int Sq, int Sk,
                    long long msb, long long msh, long long msq, int causal,
                    float scale, const long long* seed, unsigned thresh,
                    float inv_keep) {
  using Sm = DkvWgmmaSmem<D, DROP>;
  constexpr int BN = kBwdKeys, BQ = Sm::BQ, KB = Sm::KB, QB = Sm::QB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sk = wg::smem_addr(smem), sv = sk + KB;
  const int kvh = blockIdx.x, b = blockIdx.y, G = H / KVH;
  const int key0 = blockIdx.z * BN;       // the most query tiles first
  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, g = (tid & 31) >> 2, t4 = tid & 3;
  const int off = Sk - Sq;
  const long long qrs = (long long)H * D, krs = (long long)KVH * D;
  // this warpgroup's keys and this thread's two key rows
  const int wk0 = key0 + 64 * w;
  const int lk = 64 * w + 16 * warp + g;  // block key row of d[4j + {0, 1}]
  const int key_a = key0 + lk, key_b = key_a + 8;

  const long long kvo = ((long long)b * Sk + key0) * krs + kvh * D;
  wg::load_tile<BN, D, 256>(sk, k + kvo, krs, min(BN, Sk - key0), tid);
  wg::load_tile<BN, D, 256>(sv, v + kvo, krs, min(BN, Sk - key0), tid);
  // the query tiles that see the block's keys: from the first row with
  // off + r >= key0
  const int q0 = (causal ? max(0, key0 - off) : 0) / BQ * BQ;
  const int nq = Sq > q0 ? (Sq - q0 + BQ - 1) / BQ : 0;
  const int n_it = G * nq;

  // stage s of the Q/dO ring, and the copy of iteration it into it
  auto stage = [&](int s) { return sk + 2 * KB + s * Sm::kStage; };
  auto fetch = [&](int it) {
    const int h = kvh * G + it / nq, r0 = q0 + (it % nq) * BQ;
    const int n = min(BQ, Sq - r0);
    const uint32_t st = stage(it & 1);
    const long long qo = ((long long)b * Sq + r0) * qrs + (long long)h * D;
    wg::load_tile<BQ, D, 256>(st, q + qo, qrs, n, tid);
    wg::load_tile<BQ, D, 256>(st + QB, dout + qo, qrs, n, tid);
    const long long lo = ((long long)b * H + h) * Sq + r0;
    if (tid < 2 * BQ) {             // lse rows, then delta rows
      const int i = tid % BQ;
      wg::cp4(st + 2 * QB + 4 * tid, (tid < BQ ? lse : delta) + lo +
              (i < n ? i : 0), i < n);
    }
  };
  if (n_it > 0) fetch(0);
  wg::cp_commit();

  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  const float sl2 = scale * wg::kLog2e;
  Dropout drop;
  int h_drop = -1;
  for (int it = 0; it < n_it; ++it) {
    const int h = kvh * G + it / nq, r0 = q0 + (it % nq) * BQ;
    wg::cp_wait_all();
    wg::fence_async_smem();
    __syncthreads();                 // tile it is in; tile it - 1 is read
    if (it + 1 < n_it) {
      fetch(it + 1);
      wg::cp_commit();
    }
    // no key of this warpgroup, or none visible to the tile's rows
    if (wk0 >= Sk || (causal && r0 + BQ - 1 + off < wk0)) continue;
    const uint32_t st = stage(it & 1), sdo = st + QB;
    const float* slse =
        reinterpret_cast<const float*>(smem + (st - sk) + 2 * QB);
    const float* sdelta = slse + BQ;

    // S^T and dP^T as two groups: P is built while dP^T runs, and dS
    // while dV += P^T dO runs
    float s[BQ / 2], dp[BQ / 2];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::Wgmma<T, BQ>::ss(s, wg::desc_k<BN>(sk + w * 64 * 128, kk),
                           wg::desc_k<BQ>(st, kk), kk > 0);
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::Wgmma<T, BQ>::ss(dp, wg::desc_k<BN>(sv + w * 64 * 128, kk),
                           wg::desc_k<BQ>(sdo, kk), kk > 0);
    wg::commit();
    wg::wait<1>();
    wg::keep(s);

    if constexpr (DROP) {
      if (h != h_drop) {
        drop.init(seed, b, h, thresh, inv_keep);
        h_drop = h;
      }
    }
    const float* mb = mask ? mask + b * msb + h * msh : nullptr;
    // P^T = exp(s - lse): masked tiles (a mask, the causal diagonal,
    // ragged ends) element by element, the subtraction first (exact where
    // both are -1e30); the others one FFMA an element
    const bool edge = mb != nullptr || r0 + BQ > Sq || wk0 + 64 > Sk ||
                      (causal && wk0 + 63 > off + r0);
    if (edge) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int lq = 8 * (i >> 2) + 2 * t4 + (i & 1), r = r0 + lq;
        const int key = (i & 2) ? key_b : key_a;
        float x = s[i] * scale;
        const bool ok = key < Sk && r < Sq;
        if (ok && mb) x += mb[(long long)r * msq + key];
        if (causal && key > off + r) x = kMasked;
        s[i] = ok ? wg::ex2((x - slse[lq]) * wg::kLog2e) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int lq = 8 * (i >> 2) + 2 * t4 + (i & 1);
        s[i] = wg::ex2(fmaf(s[i], sl2, -slse[lq] * wg::kLog2e));
      }
    }
    // the keep bit of element i (its query row's key, its key column)
    auto kept = [&](int i, float x) {
      const int r = r0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      return drop.apply(drop.row(r), (i & 2) ? key_b : key_a, x);
    };
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    if constexpr (DROP) {
      float pd[BQ / 2];              // dV takes the dropped p
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) pd[i] = kept(i, s[i]);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wg::frag_a<T>(pd, kk, pa[kk]);
    } else {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wg::frag_a<T>(s, kk, pa[kk]);
    }
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wg::Wgmma<T, D>::rs(adv, pa[kk], wg::desc_mn<BQ>(sdo, kk));
    wg::commit();

    wg::wait<1>();                   // dP^T (dV may still run)
    wg::keep(dp);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int lq = 8 * (i >> 2) + 2 * t4 + (i & 1);
      float dpv = dp[i];
      if constexpr (DROP) dpv = kept(i, dpv);
      dp[i] = s[i] * (dpv - sdelta[lq]);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wg::frag_a<T>(dp, kk, da[kk]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wg::Wgmma<T, D>::rs(adk, da[kk], wg::desc_mn<BQ>(st, kk));
    wg::commit();
    wg::wait<0>();
    wg::keep(adv);
    wg::keep(adk);
    wg::keep(pa);
    wg::keep(da);
  }
  if (n_it == 0) {                   // no query tile: K/V copies in flight
    wg::cp_wait_all();
    __syncthreads();
  }
  if (wk0 >= Sk) return;

  // dK (scaled once) and dV into this warpgroup's rows of the K and V
  // tiles (its own products are done), then 16-byte rows out
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    *reinterpret_cast<uint32_t*>(smem + wg::swz<BN>(lk, c)) =
        wg::pack2<T>(adk[4 * j] * scale, adk[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(smem + wg::swz<BN>(lk + 8, c)) =
        wg::pack2<T>(adk[4 * j + 2] * scale, adk[4 * j + 3] * scale);
    *reinterpret_cast<uint32_t*>(smem + KB + wg::swz<BN>(lk, c)) =
        wg::pack2<T>(adv[4 * j], adv[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(smem + KB + wg::swz<BN>(lk + 8, c)) =
        wg::pack2<T>(adv[4 * j + 2], adv[4 * j + 3]);
  }
  wg::wg_barrier(1 + w);
  constexpr int CH = D / 8;
  for (int i = wt; i < 64 * CH; i += 128) {
    const int r = i / CH, c = (i % CH) * 8, key = wk0 + r;
    if (key >= Sk) continue;
    const long long o = ((long long)b * Sk + key) * krs + kvh * D + c;
    const uint32_t so = wg::swz<BN>(64 * w + r, c);
    *reinterpret_cast<uint4*>(dk + o) =
        *reinterpret_cast<const uint4*>(smem + so);
    *reinterpret_cast<uint4*>(dv + o) =
        *reinterpret_cast<const uint4*>(smem + KB + so);
  }
}

// ------------------------------------------------ dK/dV, f32: 3xTF32

constexpr int kTfKeys = 128;    // keys a block of the 3xTF32 dK/dV kernel
constexpr int kTfRows = 32;     // query rows a Q/dO tile of it

// Shared memory of flash_bwd_dkv_3xtf32 (D 64): K hi / lo and V hi / lo
// [128][D], then Q hi over lo [64][D], Q^T hi / lo [D][32], the same of
// dO, the tile's lse and delta rows, plus 1024 to align.
template <int D>
struct DkvTf32Smem {
  static constexpr int KB = kTfKeys * D * 4, QB = kTfRows * D * 4;
  static constexpr int QOFF = 4 * KB, LOFF = QOFF + 8 * QB;
  static constexpr size_t kBytes = LOFF + 2 * kTfRows * 4 + 1024;
};

template <int D, bool DROP>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_3xtf32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ mask, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int KVH, int Sq, int Sk,
                     long long msb, long long msh, long long msq, int causal,
                     float scale, const long long* seed, unsigned thresh,
                     float inv_keep) {
  using Sm = DkvTf32Smem<D>;
  constexpr int BN = kTfKeys, BQ = kTfRows, KB = Sm::KB, QB = Sm::QB;
  constexpr int CH = D / 4;                  // 16-byte chunks of a row
  static_assert(D == 64 && BQ == 32, "the Q/dO tile copy is 2 chunks a "
                                     "thread of each");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // K, V hi / lo [BN][D]; Q hi over lo [2 BQ][D], Q^T hi / lo [D][BQ],
  // the same of dO; swizzled f32 tiles
  const uint32_t kh = wg::smem_addr(smem), kl = kh + KB, vh = kl + KB,
                 vl = vh + KB, qn = kh + Sm::QOFF, qth = qn + 2 * QB,
                 qtl = qth + QB, on = qtl + QB, oth = on + 2 * QB,
                 otl = oth + QB;
  float* slse = reinterpret_cast<float*>(smem + Sm::LOFF);
  float* sdelta = slse + BQ;
  const int kvh = blockIdx.x, b = blockIdx.y, G = H / KVH;
  const int key0 = blockIdx.z * BN;       // the most query tiles first
  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int off = Sk - Sq;
  const long long qrs = (long long)H * D, krs = (long long)KVH * D;
  // this warpgroup's keys and this thread's two key rows
  const int wk0 = key0 + 64 * w;
  const int key_a = wk0 + 16 * warp + g, key_b = key_a + 8;

  // K and V rows key0.. split into hi / lo (rows past Sk zero)
  {
    const long long kvo = (long long)b * Sk * krs + kvh * D;
#pragma unroll 4
    for (int i = tid; i < BN * CH; i += 256) {
      const int r = i / CH, c = (i % CH) * 4;
      float4 xk = make_float4(0.f, 0.f, 0.f, 0.f), xv = xk;
      if (key0 + r < Sk) {
        xk = *reinterpret_cast<const float4*>(k + kvo + (key0 + r) * krs + c);
        xv = *reinterpret_cast<const float4*>(v + kvo + (key0 + r) * krs + c);
      }
      uint4 hi, lo;
      const uint32_t so = wg::swz32<BN>(r, c);
      wg::split_tf32(xk.x, hi.x, lo.x);
      wg::split_tf32(xk.y, hi.y, lo.y);
      wg::split_tf32(xk.z, hi.z, lo.z);
      wg::split_tf32(xk.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(smem + so) = hi;
      *reinterpret_cast<uint4*>(smem + KB + so) = lo;
      wg::split_tf32(xv.x, hi.x, lo.x);
      wg::split_tf32(xv.y, hi.y, lo.y);
      wg::split_tf32(xv.z, hi.z, lo.z);
      wg::split_tf32(xv.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(smem + 2 * KB + so) = hi;
      *reinterpret_cast<uint4*>(smem + 3 * KB + so) = lo;
    }
  }
  // the query tiles that see the block's keys: from the first row with
  // off + r >= key0
  const int q0 = (causal ? max(0, key0 - off) : 0) / BQ * BQ;
  const int nq = Sq > q0 ? (Sq - q0 + BQ - 1) / BQ : 0;
  const int n_it = G * nq;

  // Iteration it's Q and dO rows come into registers one iteration
  // ahead: thread chunk p of each is row 16 (task % 2) + lane % 16,
  // columns 4 (2 (task / 2) + lane / 16), task = warp + 8 p (a
  // half-warp 16 rows of one chunk, the two halves neighbouring chunks);
  // threads below 2 BQ take a lse (then a delta) row.
  float4 xq[2], xo[2];
  float xl = 0.f;
  auto fetch = [&](int it) {
    const int h = kvh * G + it / nq, r0 = q0 + (it % nq) * BQ;
    const long long qo = (long long)b * Sq * qrs + (long long)h * D;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int task = (tid >> 5) + 8 * p;
      const int r = 16 * (task & 1) + (lane & 15);
      const int c = (2 * (task >> 1) + (lane >> 4)) * 4;
      xq[p] = xo[p] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < Sq) {
        xq[p] = *reinterpret_cast<const float4*>(q + qo + (r0 + r) * qrs + c);
        xo[p] =
            *reinterpret_cast<const float4*>(dout + qo + (r0 + r) * qrs + c);
      }
    }
    if (tid < 2 * BQ) {
      const int i = tid % BQ;
      const long long lo = ((long long)b * H + h) * Sq + r0 + i;
      xl = r0 + i < Sq ? (tid < BQ ? lse : delta)[lo] : 0.f;
    }
  };
  // ... and into shared memory: q scaled (as the plain version: q *
  // scale, rounded once) and dO, split, each as a row tile [2 BQ][D], hi
  // rows over lo rows (the B operand of S^T and dP^T: one m64n64 product
  // takes hi hi' and hi lo' at once), and a transposed tile [D][BQ] hi
  // and lo whose 8-row slices hold their rows in key_slot order (the B
  // operand of dK and dV, read against frag_a_tf32 of P^T and dS^T)
  auto stage = [&]() {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int task = (tid >> 5) + 8 * p;
      const int r = 16 * (task & 1) + (lane & 15);
      const int c = (2 * (task >> 1) + (lane >> 4)) * 4;
      const int slot = wg::key_slot(r);
      const uint32_t so = wg::swz32<2 * BQ>(r, c);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float4 x = t ? xo[p] : xq[p];
        const float m = t ? 1.f : scale;
        const float e[4] = {x.x * m, x.y * m, x.z * m, x.w * m};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wg::split_tf32(e[j], hi[j], lo[j]);
        const uint32_t base = Sm::QOFF + t * 4 * QB;   // Q..., then dO...
        *reinterpret_cast<uint4*>(smem + base + so) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(smem + base + so + BQ * 128) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t to = wg::swz32<D>(c + j, slot);
          *reinterpret_cast<uint32_t*>(smem + base + 2 * QB + to) = hi[j];
          *reinterpret_cast<uint32_t*>(smem + base + 3 * QB + to) = lo[j];
        }
      }
    }
    if (tid < 2 * BQ) slse[tid] = xl;          // lse rows, then delta rows
  };
  if (n_it > 0) fetch(0);

  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  Dropout drop;
  int h_drop = -1;
  for (int it = 0; it < n_it; ++it) {
    const int h = kvh * G + it / nq, r0 = q0 + (it % nq) * BQ;
    __syncthreads();                 // tile it - 1's products are done
    stage();
    wg::fence_async_smem();          // (and the K/V tiles at it 0)
    __syncthreads();
    if (it + 1 < n_it) fetch(it + 1);
    // no key of this warpgroup, or none visible to the tile's rows
    if (wk0 >= Sk || (causal && r0 + BQ - 1 + off < wk0)) continue;

    // S^T = K Q^T and dP^T = V dO^T, three TF32 products a k step each,
    // as two groups (P is built while dP^T runs): hi [Q hi; Q lo] on an
    // m64n64 product (columns 0-31 hi hi', 32-63 hi lo'), then lo Q hi'
    // into columns 0-31; the halves are summed after.  A K-major f32
    // product streams its operands from shared memory, so this reads K
    // hi once a k step where three m64n32 products read it twice.
    float sc[BQ], dc[BQ];
    const uint32_t kwh = kh + w * 64 * 128, kwl = kl + w * 64 * 128;
    const uint32_t vwh = vh + w * 64 * 128, vwl = vl + w * 64 * 128;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wg::WgmmaTf32<2 * BQ>::ss(sc, wg::desc_k<BN>(kwh, kk),
                                wg::desc_k<2 * BQ>(qn, kk), kk > 0);
      wg::WgmmaTf32<2 * BQ>::ss_n32(sc, wg::desc_k<BN>(kwl, kk),
                                    wg::desc_k<2 * BQ>(qn, kk));
    }
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wg::WgmmaTf32<2 * BQ>::ss(dc, wg::desc_k<BN>(vwh, kk),
                                wg::desc_k<2 * BQ>(on, kk), kk > 0);
      wg::WgmmaTf32<2 * BQ>::ss_n32(dc, wg::desc_k<BN>(vwl, kk),
                                    wg::desc_k<2 * BQ>(on, kk));
    }
    wg::commit();
    wg::wait<1>();
    wg::keep(sc);
    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = sc[i] + sc[i + BQ / 2];

    if constexpr (DROP) {
      if (h != h_drop) {
        drop.init(seed, b, h, thresh, inv_keep);
        h_drop = h;
      }
    }
    // element i: key row (i & 2 ? key_b : key_a), query row r0 + lq(i)
    auto lq = [&](int i) { return 8 * (i >> 2) + 2 * t4 + (i & 1); };
    // the keep bits of the thread's elements, hashed once for P and dP
    uint32_t keep = 0;
    if constexpr (DROP) {
#pragma unroll
      for (int j = 0; j < BQ / 4; ++j) {
        const uint32_t rk = drop.row(r0 + 8 * (j >> 1) + 2 * t4 + (j & 1));
        const int i = 4 * (j >> 1) + (j & 1);    // its elements i, i + 2
        keep |= (drop_mix(rk, (uint32_t)key_a) >= drop.thresh ? 1u : 0u) << i;
        keep |= (drop_mix(rk, (uint32_t)key_b) >= drop.thresh ? 1u : 0u)
                << (i + 2);
      }
    }
    auto kept = [&](int i, float x) {
      return (keep >> i) & 1u ? x * drop.inv : 0.f;
    };
    const float* mb = mask ? mask + b * msb + h * msh : nullptr;
    // P^T = exp(s - lse) (q is scaled): masked tiles (a mask, the causal
    // diagonal, ragged ends) element by element, the subtraction first
    // (exact where both are -1e30); the others one FFMA an element
    const bool edge = mb != nullptr || r0 + BQ > Sq || wk0 + 64 > Sk ||
                      (causal && wk0 + 63 > off + r0);
    if (edge) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int r = r0 + lq(i), key = (i & 2) ? key_b : key_a;
        float x = s[i];
        const bool ok = key < Sk && r < Sq;
        if (ok && mb) x += mb[(long long)r * msq + key];
        if (causal && key > off + r) x = kMasked;
        s[i] = ok ? wg::ex2((x - slse[lq(i)]) * wg::kLog2e) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        s[i] = wg::ex2(fmaf(s[i], wg::kLog2e, -slse[lq(i)] * wg::kLog2e));
    }
    // dV += P^T dO (dropped p in dropout mode): hi hi + hi lo + lo hi
    // into a tile accumulator that the first product overwrites, the
    // tile's sum then added to dV (and dK's to dK) by f32 adds.  Chained
    // in the tensor cores' own accumulator over all 1024 rows of GPT-2's
    // keys (384 products a k element), dK / dV drifted 1.2e-5 (relative
    // L2) off the plain version; a tile's 12 products stay near 2e-6.
    uint32_t ph[BQ / 8][4], pl[BQ / 8][4];
    if constexpr (DROP) {
      float pd[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) pd[i] = kept(i, s[i]);
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk)
        wg::frag_a_tf32(pd, kk, ph[kk], pl[kk]);
    } else {
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk)
        wg::frag_a_tf32(s, kk, ph[kk], pl[kk]);
    }
    float tacc[D / 2];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) {
      wg::WgmmaTf32<D>::rs(tacc, ph[kk], wg::desc_k<D>(oth, kk), kk > 0);
      wg::WgmmaTf32<D>::rs(tacc, ph[kk], wg::desc_k<D>(otl, kk));
      wg::WgmmaTf32<D>::rs(tacc, pl[kk], wg::desc_k<D>(oth, kk));
    }
    wg::commit();

    wg::wait<1>();                   // dP^T (dV may still run)
    wg::keep(dc);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) dp[i] = dc[i] + dc[i + BQ / 2];
    // dS^T = P^T (dP'^T - delta), while dV runs
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      float dpv = dp[i];
      if constexpr (DROP) dpv = kept(i, dpv);
      dp[i] = s[i] * (dpv - sdelta[lq(i)]);
    }
    wg::wait<0>();
    wg::keep(tacc);
    wg::keep(ph);
    wg::keep(pl);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) adv[i] += tacc[i];
    // dK += dS^T (q scale), the same way
    uint32_t dh[BQ / 8][4], dl[BQ / 8][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) wg::frag_a_tf32(dp, kk, dh[kk], dl[kk]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) {
      wg::WgmmaTf32<D>::rs(tacc, dh[kk], wg::desc_k<D>(qth, kk), kk > 0);
      wg::WgmmaTf32<D>::rs(tacc, dh[kk], wg::desc_k<D>(qtl, kk));
      wg::WgmmaTf32<D>::rs(tacc, dl[kk], wg::desc_k<D>(qth, kk));
    }
    wg::commit();
    wg::wait<0>();
    wg::keep(tacc);
    wg::keep(dh);
    wg::keep(dl);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) adk[i] += tacc[i];
  }
  if (wk0 >= Sk) return;

  // dK and dV rows out: a quad writes 8 neighbouring floats a store
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (key_a < Sk) {
      const long long o = ((long long)b * Sk + key_a) * krs + kvh * D + c;
      *reinterpret_cast<float2*>(dk + o) = make_float2(adk[4 * j], adk[4 * j + 1]);
      *reinterpret_cast<float2*>(dv + o) = make_float2(adv[4 * j], adv[4 * j + 1]);
    }
    if (key_b < Sk) {
      const long long o = ((long long)b * Sk + key_b) * krs + kvh * D + c;
      *reinterpret_cast<float2*>(dk + o) =
          make_float2(adk[4 * j + 2], adk[4 * j + 3]);
      *reinterpret_cast<float2*>(dv + o) =
          make_float2(adv[4 * j + 2], adv[4 * j + 3]);
    }
  }
}

constexpr int kDqRows = 128;    // query rows a block of the wgmma dQ kernel
constexpr int kDqKeys = 64;     // keys a K/V tile of it

// Shared memory of flash_bwd_dq_wgmma: Q and dO, then 2 stages of K and V
// tiles, plus 1024 to align.
template <int D>
struct DqWgmmaSmem {
  static constexpr int QB = kDqRows * D * 2, KB = kDqKeys * D * 2;
  static constexpr size_t kBytes = 2 * (size_t)QB + 4 * (size_t)KB + 1024;
};

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ mask, T* __restrict__ dq,
                   int H, int KVH, int Sq, int Sk, long long msb,
                   long long msh, long long msq, int causal, float scale,
                   const long long* seed, unsigned thresh, float inv_keep) {
  using Sm = DqWgmmaSmem<D>;
  constexpr int BR = kDqRows, BN = kDqKeys, QB = Sm::QB, KB = Sm::KB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sq = wg::smem_addr(smem), sdo = sq + QB;
  const int h = blockIdx.x, b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BR;   // most keys first
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, g = (tid & 31) >> 2, t4 = tid & 3;
  const int off = Sk - Sq;
  const long long qrs = (long long)H * D, krs = (long long)KVH * D;
  // the keys the block's rows may see, and this warpgroup's
  const int key_end =
      causal ? min(Sk, off + min(Sq - 1, row0 + BR - 1) + 1) : Sk;
  const int wrow0 = row0 + 64 * w;
  const int wkey_end =
      wrow0 >= Sq ? 0
                  : (causal ? min(Sk, off + min(Sq - 1, wrow0 + 63) + 1) : Sk);
  const int lr = 64 * w + 16 * warp + g;    // tile row of d[4j + {0, 1}]
  const int r_a = row0 + lr, r_b = r_a + 8;

  const long long qo = ((long long)b * Sq + row0) * qrs + (long long)h * D;
  wg::load_tile<BR, D, 256>(sq, q + qo, qrs, min(BR, Sq - row0), tid);
  wg::load_tile<BR, D, 256>(sdo, dout + qo, qrs, min(BR, Sq - row0), tid);
  const T* kb = k + (long long)b * Sk * krs + kvh * D;
  const T* vb = v + (long long)b * Sk * krs + kvh * D;
  // stage s of the K/V ring, and the copy of tile it into it (every key
  // of the tile below Sk: a row whose keys are all hidden weighs those
  // past its diagonal too, as the plain version does)
  auto stage = [&](int s) { return sdo + QB + s * 2 * KB; };
  auto fetch = [&](int it) {
    const int t0 = it * BN, n = min(BN, Sk - t0);
    const uint32_t st = stage(it & 1);
    wg::load_tile<BN, D, 256>(st, kb + t0 * krs, krs, n, tid);
    wg::load_tile<BN, D, 256>(st + KB, vb + t0 * krs, krs, n, tid);
  };
  const int ntiles = (key_end + BN - 1) / BN;
  if (ntiles > 0) fetch(0);
  wg::cp_commit();

  // this thread's two rows: lse (log2 units for the unmasked tiles) and
  // delta; rows past Sq take 0 and are never stored
  const long long lo = ((long long)b * H + h) * Sq;
  const float lse_a = r_a < Sq ? lse[lo + r_a] : 0.f;
  const float lse_b = r_b < Sq ? lse[lo + r_b] : 0.f;
  const float dl_a = r_a < Sq ? delta[lo + r_a] : 0.f;
  const float dl_b = r_b < Sq ? delta[lo + r_b] : 0.f;
  const float ml_a = lse_a * wg::kLog2e, ml_b = lse_b * wg::kLog2e;
  Dropout drop;
  uint32_t rk_a = 0, rk_b = 0;
  if constexpr (DROP) {
    drop.init(seed, b, h, thresh, inv_keep);
    rk_a = drop.row(r_a);
    rk_b = drop.row(r_b);
  }
  const float* mb = mask ? mask + b * msb + h * msh : nullptr;
  const float sl2 = scale * wg::kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * BN;
    wg::cp_wait_all();
    wg::fence_async_smem();
    __syncthreads();                 // tile it is in; tile it - 1 is read
    if (it + 1 < ntiles) {
      fetch(it + 1);
      wg::cp_commit();
    }
    if (t0 >= wkey_end) continue;    // uniform over the warpgroup
    const uint32_t sk = stage(it & 1), sv = sk + KB;

    // S = Q K^T and dP = dO V^T as two groups: P is built while dP runs
    float s[BN / 2], dp[BN / 2];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::Wgmma<T, BN>::ss(s, wg::desc_k<BR>(sq + w * 64 * 128, kk),
                           wg::desc_k<BN>(sk, kk), kk > 0);
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::Wgmma<T, BN>::ss(dp, wg::desc_k<BR>(sdo + w * 64 * 128, kk),
                           wg::desc_k<BN>(sv, kk), kk > 0);
    wg::commit();
    wg::wait<1>();
    wg::keep(s);

    // P = exp(s - lse): masked tiles (a mask, the causal diagonal, the
    // ragged end) element by element, the subtraction first (exact where
    // both are -1e30); the others one FFMA an element
    const bool edge = mb != nullptr || t0 + BN > Sk ||
                      (causal && t0 + BN - 1 > off + wrow0);
    if (edge) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i & 2) ? r_b : r_a;
        const int key = t0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        float x = s[i] * scale;
        const bool ok = key < Sk && r < Sq;
        if (ok && mb) x += mb[(long long)r * msq + key];
        if (causal && key > off + r) x = kMasked;
        s[i] = ok ? wg::ex2((x - ((i & 2) ? lse_b : lse_a)) * wg::kLog2e)
                  : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        s[i] = wg::ex2(fmaf(s[i], sl2, (i & 2) ? -ml_b : -ml_a));
    }

    wg::wait<0>();                   // dP
    wg::keep(dp);
    // dS = P (dP' - delta), rounded to 16 bits as the A operand of
    // dQ += dS K (K MN-major: the transpose bit)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      float dpv = dp[i];
      if constexpr (DROP)
        dpv = drop.apply((i & 2) ? rk_b : rk_a,
                         t0 + 8 * (i >> 2) + 2 * t4 + (i & 1), dpv);
      dp[i] = s[i] * (dpv - ((i & 2) ? dl_b : dl_a));
    }
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wg::frag_a<T>(dp, kk, da[kk]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wg::Wgmma<T, D>::rs(acc, da[kk], wg::desc_mn<BN>(sk, kk));
    wg::commit();
    wg::wait<0>();
    wg::keep(acc);
    wg::keep(da);
  }
  if (ntiles == 0) {                 // no key: Q/dO copies in flight
    wg::cp_wait_all();
    __syncthreads();
  }
  if (wrow0 >= Sq) return;

  // dQ (scaled once) into this warpgroup's rows of the Q tile (its own
  // products are done), then 16-byte rows out
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    *reinterpret_cast<uint32_t*>(smem + wg::swz<BR>(lr, c)) =
        wg::pack2<T>(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(smem + wg::swz<BR>(lr + 8, c)) =
        wg::pack2<T>(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
  wg::wg_barrier(1 + w);
  constexpr int CH = D / 8;
  for (int i = wt; i < 64 * CH; i += 128) {
    const int r = i / CH, c = (i % CH) * 8, row = wrow0 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(dq + ((long long)b * Sq + row) * qrs +
                                (long long)h * D + c) =
          *reinterpret_cast<const uint4*>(smem + wg::swz<BR>(64 * w + r, c));
  }
}

// ---------------------------------------------------- dQ, f32: 3xTF32

constexpr int kDqTfRows = 128;  // query rows a block of the 3xTF32 dQ kernel
constexpr int kDqTfKeys = 32;   // keys a K/V tile of it

// Shared memory of flash_bwd_dq_3xtf32 (D 64): Q hi / lo and dO hi / lo
// [128][D], then 2 stages of K hi over lo and V hi over lo [64][D] and
// K^T hi / lo [D][32], plus 1024 to align.
template <int D>
struct DqTf32Smem {
  static constexpr int QB = kDqTfRows * D * 4;
  static constexpr int NB = 2 * kDqTfKeys * D * 4, TB = kDqTfKeys * D * 4;
  static constexpr int kStage = 2 * NB + 2 * TB;
  static constexpr size_t kBytes = 4 * (size_t)QB + 2 * (size_t)kStage + 1024;
};

template <int D, bool DROP>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_3xtf32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ mask, float* __restrict__ dq,
                    int H, int KVH, int Sq, int Sk, long long msb,
                    long long msh, long long msq, int causal, float scale,
                    const long long* seed, unsigned thresh, float inv_keep) {
  using Sm = DqTf32Smem<D>;
  constexpr int BR = kDqTfRows, BN = kDqTfKeys, QB = Sm::QB, NB = Sm::NB,
                TB = Sm::TB;
  constexpr int CH = D / 4;                  // 16-byte chunks of a row
  static_assert(D == 64 && BN == 32, "the K/V tile copy is 2 chunks a "
                                     "thread of each");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // Q hi / lo, dO hi / lo [BR][D]; stage s at soff(s): K hi over lo, V hi
  // over lo [2 BN][D], K^T hi / lo [D][BN]; swizzled f32 tiles
  const uint32_t base = wg::smem_addr(smem);
  auto soff = [&](int s) { return 4 * QB + s * Sm::kStage; };
  const int h = blockIdx.x, b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BR;   // most keys first
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int off = Sk - Sq;
  const long long qrs = (long long)H * D, krs = (long long)KVH * D;
  // the keys the block's rows may see, and this warpgroup's
  const int key_end =
      causal ? min(Sk, off + min(Sq - 1, row0 + BR - 1) + 1) : Sk;
  const int wrow0 = row0 + 64 * w;
  const int wkey_end =
      wrow0 >= Sq ? 0
                  : (causal ? min(Sk, off + min(Sq - 1, wrow0 + 63) + 1) : Sk);

  // Q scaled (as the plain version: q * scale, rounded once) and dO,
  // split into hi / lo (rows past Sq zero)
  {
    const long long qo = (long long)b * Sq * qrs + (long long)h * D;
#pragma unroll 4
    for (int i = tid; i < BR * CH; i += 256) {
      const int r = i / CH, c = (i % CH) * 4;
      float4 xq = make_float4(0.f, 0.f, 0.f, 0.f), xo = xq;
      if (row0 + r < Sq) {
        xq = *reinterpret_cast<const float4*>(q + qo + (row0 + r) * qrs + c);
        xo = *reinterpret_cast<const float4*>(dout + qo + (row0 + r) * qrs +
                                              c);
      }
      uint4 hi, lo;
      const uint32_t so = wg::swz32<BR>(r, c);
      wg::split_tf32<true>(xq.x * scale, hi.x, lo.x);
      wg::split_tf32<true>(xq.y * scale, hi.y, lo.y);
      wg::split_tf32<true>(xq.z * scale, hi.z, lo.z);
      wg::split_tf32<true>(xq.w * scale, hi.w, lo.w);
      *reinterpret_cast<uint4*>(smem + so) = hi;
      *reinterpret_cast<uint4*>(smem + QB + so) = lo;
      wg::split_tf32<true>(xo.x, hi.x, lo.x);
      wg::split_tf32<true>(xo.y, hi.y, lo.y);
      wg::split_tf32<true>(xo.z, hi.z, lo.z);
      wg::split_tf32<true>(xo.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(smem + 2 * QB + so) = hi;
      *reinterpret_cast<uint4*>(smem + 3 * QB + so) = lo;
    }
  }

  // Tile it's K and V rows come into registers two tiles ahead: thread
  // chunk p of each is key 16 (task % 2) + lane % 16, columns 4 (2 (task
  // / 2) + lane / 16), task = warp + 8 p (a half-warp 16 keys of one
  // chunk, the two halves neighbouring chunks).  Every key below Sk is
  // read: a row whose keys are all hidden weighs those past its
  // diagonal too, as the plain version does.
  const float* kb = k + (long long)b * Sk * krs + kvh * D;
  const float* vb = v + (long long)b * Sk * krs + kvh * D;
  float4 xk[2], xv[2];
  auto fetch = [&](int it) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int task = (tid >> 5) + 8 * p;
      const int r = 16 * (task & 1) + (lane & 15), key = it * BN + r;
      const int c = (2 * (task >> 1) + (lane >> 4)) * 4;
      xk[p] = xv[p] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (key < Sk) {
        xk[p] = *reinterpret_cast<const float4*>(kb + key * krs + c);
        xv[p] = *reinterpret_cast<const float4*>(vb + key * krs + c);
      }
    }
  };
  // ... and into stage s, split: K and V each as a row tile, hi rows
  // over lo rows (the B operand of S = Q K^T and dP = dO V^T), and K as a
  // transposed tile [D][BN] hi and lo whose 8-key slices hold their keys
  // in key_slot order (the B operand of dQ += dS K, read against
  // frag_a_tf32 of dS: TF32 wgmma has no transpose bit)
  auto stage = [&](int s) {
    const uint32_t o = soff(s);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int task = (tid >> 5) + 8 * p;
      const int r = 16 * (task & 1) + (lane & 15);
      const int c = (2 * (task >> 1) + (lane >> 4)) * 4;
      const int slot = wg::key_slot(r);
      const uint32_t so = wg::swz32<2 * BN>(r, c);
#pragma unroll
      for (int t = 0; t < 2; ++t) {          // K, then V
        const float4 x = t ? xv[p] : xk[p];
        const float e[4] = {x.x, x.y, x.z, x.w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wg::split_tf32<true>(e[j], hi[j], lo[j]);
        *reinterpret_cast<uint4*>(smem + o + t * NB + so) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(smem + o + t * NB + so + BN * 128) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
        if (t == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t to = wg::swz32<D>(c + j, slot);
            *reinterpret_cast<uint32_t*>(smem + o + 2 * NB + to) = hi[j];
            *reinterpret_cast<uint32_t*>(smem + o + 2 * NB + TB + to) = lo[j];
          }
        }
      }
    }
  };
  const int ntiles = (key_end + BN - 1) / BN;
  if (ntiles > 0) {
    fetch(0);
    stage(0);
  }
  if (ntiles > 1) fetch(1);

  // this thread's two rows: lse, delta and dropout keys; rows past Sq
  // take 0 and are never stored
  wg::TfRows rw;
  rw.r_a = wrow0 + 16 * warp + g;
  rw.r_b = rw.r_a + 8;
  const long long lo = ((long long)b * H + h) * Sq;
  rw.lse_a = rw.r_a < Sq ? lse[lo + rw.r_a] : 0.f;
  rw.lse_b = rw.r_b < Sq ? lse[lo + rw.r_b] : 0.f;
  rw.dl_a = rw.r_a < Sq ? delta[lo + rw.r_a] : 0.f;
  rw.dl_b = rw.r_b < Sq ? delta[lo + rw.r_b] : 0.f;
  rw.ml_a = rw.lse_a * wg::kLog2e;
  rw.ml_b = rw.lse_b * wg::kLog2e;
  Dropout drop;
  rw.rk_a = rw.rk_b = 0;
  if constexpr (DROP) {
    drop.init(seed, b, h, thresh, inv_keep);
    rw.rk_a = drop.row(rw.r_a);
    rw.rk_b = drop.row(rw.r_b);
  }
  const float* mb = mask ? mask + b * msb + h * msh : nullptr;
  auto add = [&](int, int r, int key) {
    return mb ? mb[(long long)r * msq + key] : 0.f;
  };
  const uint32_t qw = base + w * 64 * 128;   // this warpgroup's Q / dO rows

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * BN;
    wg::fence_async_smem();
    __syncthreads();            // stage it is in; tile it - 1 is read
    const bool mine = t0 < wkey_end;         // uniform over the warpgroup
    const uint32_t st = base + soff(it & 1);
    float sc[32], dc[32];
    if (mine)
      wg::sdp_issue_3xtf32<BR, D>(sc, dc, qw, qw + QB, qw + 2 * QB,
                                  qw + 3 * QB, st, st + NB);
    // the next tile into the other stage while the products run, and
    // the one after it into registers
    if (it + 1 < ntiles) stage((it + 1) & 1);
    if (it + 2 < ntiles) fetch(it + 2);
    if (!mine) continue;

    const bool edge = mb != nullptr || t0 + BN > Sk ||
                      (causal && t0 + BN - 1 > off + wrow0);
    float ds[16];
    wg::ds_3xtf32<DROP>(ds, sc, dc, rw, t0, t4, edge, causal, off, Sq, Sk,
                        drop, add);
    // dQ += dS K: hi hi + hi lo + lo hi into a tile accumulator that the
    // first product overwrites, added to dQ by f32 adds (a sum chained in
    // the tensor cores' accumulator over 1024 keys drifts, as #4's did)
    uint32_t dh[BN / 8][4], dl[BN / 8][4];
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk)
      wg::frag_a_tf32<true>(ds, kk, dh[kk], dl[kk]);
    float tacc[D / 2];
    const uint32_t kth = st + 2 * NB, ktl = kth + TB;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      wg::WgmmaTf32<D>::rs(tacc, dh[kk], wg::desc_k<D>(kth, kk), kk > 0);
      wg::WgmmaTf32<D>::rs(tacc, dh[kk], wg::desc_k<D>(ktl, kk));
      wg::WgmmaTf32<D>::rs(tacc, dl[kk], wg::desc_k<D>(kth, kk));
    }
    wg::commit();
    wg::wait<0>();
    wg::keep(tacc);
    wg::keep(dh);
    wg::keep(dl);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += tacc[i];
  }

  // dQ rows out (scaled once): a quad writes 8 neighbouring floats a store
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (rw.r_a < Sq)
      *reinterpret_cast<float2*>(dq + ((long long)b * Sq + rw.r_a) * qrs +
                                 (long long)h * D + c) =
          make_float2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (rw.r_b < Sq)
      *reinterpret_cast<float2*>(dq + ((long long)b * Sq + rw.r_b) * qrs +
                                 (long long)h * D + c) =
          make_float2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
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
cudaError_t launch_dkv_wgmma(const BwdArgs& a) {
  const size_t smem = DkvWgmmaSmem<D, DROP>::kBytes;
  static bool smem_set = false;
  cudaError_t e =
      allow_smem(flash_bwd_dkv_wgmma<T, D, DROP>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.KVH, a.B, (a.Sk + kBwdKeys - 1) / kBwdKeys);
  flash_bwd_dkv_wgmma<T, D, DROP><<<grid, 256, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.mask, static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.H,
      a.KVH, a.Sq, a.Sk, a.ms[0], a.ms[1], a.ms[2], a.causal, a.scale,
      a.seed, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_dkv_3xtf32(const BwdArgs& a) {
  const size_t smem = DkvTf32Smem<D>::kBytes;
  static bool smem_set = false;
  cudaError_t e =
      allow_smem(flash_bwd_dkv_3xtf32<D, DROP>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.KVH, a.B, (a.Sk + kTfKeys - 1) / kTfKeys);
  flash_bwd_dkv_3xtf32<D, DROP><<<grid, 256, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.mask, static_cast<float*>(a.o0),
      static_cast<float*>(a.o1), a.H, a.KVH, a.Sq, a.Sk, a.ms[0], a.ms[1],
      a.ms[2], a.causal, a.scale, a.seed, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int D, bool DROP>
cudaError_t launch_dq_wgmma(const BwdArgs& a) {
  const size_t smem = DqWgmmaSmem<D>::kBytes;
  static bool smem_set = false;
  cudaError_t e = allow_smem(flash_bwd_dq_wgmma<T, D, DROP>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.H, a.B, (a.Sq + kDqRows - 1) / kDqRows);
  flash_bwd_dq_wgmma<T, D, DROP><<<grid, 256, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.mask, static_cast<T*>(a.o0), a.H, a.KVH, a.Sq, a.Sk,
      a.ms[0], a.ms[1], a.ms[2], a.causal, a.scale, a.seed, a.thresh,
      a.inv_keep);
  return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_dq_3xtf32(const BwdArgs& a) {
  const size_t smem = DqTf32Smem<D>::kBytes;
  static bool smem_set = false;
  cudaError_t e = allow_smem(flash_bwd_dq_3xtf32<D, DROP>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.H, a.B, (a.Sq + kDqTfRows - 1) / kDqTfRows);
  flash_bwd_dq_3xtf32<D, DROP><<<grid, 256, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.mask, static_cast<float*>(a.o0), a.H, a.KVH, a.Sq,
      a.Sk, a.ms[0], a.ms[1], a.ms[2], a.causal, a.scale, a.seed, a.thresh,
      a.inv_keep);
  return cudaGetLastError();
}

// dQ (which 0) and dK/dV (which 1): bf16 / f16 on wgmma; f32 on 3xTF32
// wgmma at D 64 and on the FMA pipe at D 128 (whose hi / lo tiles would
// not fit an SM)
template <typename T, int D, bool DROP>
cudaError_t launch(int which, const BwdArgs& a) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (D == 64)
      return which == 0 ? launch_dq_3xtf32<D, DROP>(a)
                        : launch_dkv_3xtf32<D, DROP>(a);
    else
      return which == 0 ? launch_dq<T, D, DROP>(a)
                        : launch_dkv<T, D, DROP>(a);
  } else
    return which == 0 ? launch_dq_wgmma<T, D, DROP>(a)
                      : launch_dkv_wgmma<T, D, DROP>(a);
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
