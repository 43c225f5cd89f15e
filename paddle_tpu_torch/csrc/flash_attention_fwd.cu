// FlashAttention forward with an additive mask, causal masking, GQA and
// in-kernel dropout: kernel #2.
//
// Replaces the TPU kernel `_fwd_kernel` behind `_fwd`
// (paddle_tpu/ops/pallas/flash_attention.py): the training path's causal
// attention ([1, 8192, 32, 128] at Llama-3-8B width, 8 KV heads), and the
// serving engine's synchronous prefill, once per layer and chunk, with
// q [1, P, H, D] against the sequence's gathered pages (strided views)
// and an f32 additive position mask [1, 1, P, maxp * P].
//
// Semantics (every route).  Inputs [B, S, H, D] with any batch, sequence
// and head strides (D contiguous); query head h reads kv head h / G.  The
// scaled score q.k / sqrt(D) takes the mask (broadcast strides msb, msh,
// msq, 0 where it broadcasts); causal masking maps query row i to key
// position off + i with off = Sk - Sq.  A hidden key scores -1e30 (the
// reference's masking value), a key past the end of the key range -inf.
// The output is contiguous [B, Sq, H, D], the log-sum-exp m + log(l)
// [B, H, Sq] f32.  Dropout (a seed pointer, DROP = true): the P.V
// product takes p / (1 - p) where the element's keep bit
// (attention_dropout.cuh: a hash of seed, b, h, query row, key column)
// is set and 0 elsewhere; the row max, l and the lse stay undropped.
//
// What bounds it on an H100: operations.  The causal 8K forward does
// 4 Sq Sk D H / 2 = 550 GFLOP against some 100 MB of operands; the
// prefill chunk about 500 flops a K/V byte; both far above the bf16
// ridge of about 295.  So the products belong on the tensor cores.
//
// bf16 / f16: `flash_fwd_wgmma` (attention_wgmma.cuh).  A block of NWG
// warpgroups owns 64 NWG query rows: 128 where the grid of 128-row tiles
// fills the card's SMs, else 64 (the prefill chunk, Sq 128 x 32 heads,
// would give 32 blocks of 128 rows to 132 SMs; it gets 64 of 64).  The
// query tile is copied once; K/V tiles of 128 keys stream through a
// 2-stage cp.async ring, the next tile's copy in flight during this
// one's products.  Each warpgroup computes S = Q K^T for its 64 rows on
// wgmma (m64n128k16, Q and K K-major in shared memory, f32 accumulate),
// scales in f32 with log2(e) folded in, masks only where a tile needs it
// (a mask, the causal diagonal, the ragged end), and runs the online
// softmax on the accumulator fragments: a row's max and sum are quad
// shuffles, exp is exp2f.  P, dropped and rounded to 16 bits in
// registers, is wgmma's register A operand for O += P V, with V an
// MN-major B (the transpose bit).  The epilogue writes O / l through
// shared memory with 16-byte stores.  Query tiles launch heaviest first
// (the causal tail last), heads fastest.
//
// f32: `flash_fwd_3xtf32`, f32-accurate on the tensor cores.  The f32
// checks hold the route to 1e-5 of the plain version, which one TF32
// product (10 mantissa bits) would not; the FMA pipe gives 67 TFLOP/s.
// So each operand is split as x = hi + lo (hi its TF32 rounding, lo the
// TF32 rounding of x - hi) and each product is taken as hi hi' + hi lo'
// + lo hi' on TF32 wgmma (m64nNk8, f32 accumulate): what is left out,
// lo lo', is about 2^-22 of the product.  A warpgroup owns 64 query
// rows; Q is scaled as the plain version scales it, split, and kept as
// two swizzled tiles; each tile of 4096 / D keys is loaded with 16-byte
// loads, split and stored as K hi / lo (K-major, as stored) and V^T hi /
// lo (TF32 wgmma has no transpose bits, so V is transposed as it is
// staged, a half-warp a 16-key column, 32 banks a warp).  At D 64 (GPT-2
// training, 1536 blocks) a block is one warpgroup in 96 KB of shared
// memory, two blocks an SM; at D 128 (the split path's prefill chunk)
// Q's pair alone takes 64 KB a warpgroup, so a block is two warpgroups,
// 128 rows, sharing each K/V tile in 192 KB, one block an SM (its
// warpgroups hide each other's loads and softmax; prefetching the next
// tile by cp.async instead, at one warpgroup, gained nothing and spilled
// registers; at D 64 two warpgroups were slower).  S = Q K^T is three ss
// products a k step; the online softmax runs on the fragments as in the
// 16-bit kernel (dropout from the same keep bits); P's hi / lo parts are
// the register A operand of O += P V.  TF32's A fragment holds columns
// t4, t4 + 4 where the accumulator holds 2 t4, 2 t4 + 1, so each 8-key
// slice of V^T stores its keys in the order {0, 2, 4, 6, 1, 3, 5, 7}
// and P needs no shuffle.  Where the blocks do not fill the SMs (the
// prefill chunk: 32 blocks), a block's keys split over up to 4 blocks:
// each writes its partial (acc, m, l) and `flash_fwd_3xtf32_merge`
// combines them (a split with no key: m = -inf, l = 0).  An FMA-pipe
// redesign (128-row blocks, 8 x 4 register tiles, a cp.async double
// buffer, P passed by shuffles, the same splits) was about twice as slow
// at GPT-2's shape.  Numbers in PERF.md.
#include <algorithm>

#include "attention_wgmma.cuh"

namespace ptt {

// ------------------------------------------------------- f32: 3xTF32

// Keys a K/V tile of the f32 kernel: a K tile and a V^T tile of 4096 f32
// each (hi and lo: 64 KB); a block's NWG warpgroups own 64 query rows
// each and share the tiles.  Q's hi / lo pair takes 32 KB a warpgroup at
// D 64, 64 KB at D 128.
template <int D>
__host__ __device__ constexpr int tf_keys() {
  return 4096 / D;
}
template <int D, int NWG>
constexpr size_t fwd_tf32_bytes() {
  return 2 * (size_t)64 * NWG * D * 4 + 4 * (size_t)4096 * 4 + 1024;
}

// q/k/v f32; out and lse as flash_fwd_wgmma's when nsplit == 1, else
// this split's partial state into part: acc (unnormalized O) [nsplit][B]
// [H][Sq][D], then (m in log2 units, l) [nsplit][B][H][Sq][2].
template <int D, int NWG, bool DROP>
__global__ void __launch_bounds__(128 * NWG)
flash_fwd_3xtf32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse,
                 float* __restrict__ part, int nsplit, int B, int H, int KVH,
                 int Sq, int Sk, long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh, long long vsb,
                 long long vss, long long vsh, long long msb, long long msh,
                 long long msq, int causal, float scale,
                 const long long* seed, unsigned thresh, float inv_keep) {
  constexpr int BR = 64 * NWG, NT = 128 * NWG, BC = tf_keys<D>();
  constexpr int QB = BR * D * 4, KB = 4096 * 4;
  constexpr int CH = D / 4;                  // 16-byte chunks of a row
  constexpr int PK = 1024 / NT;              // K / V chunks a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // Q hi / lo [BR][D], K hi / lo [BC][D], V^T hi / lo [D][BC], swizzled
  const uint32_t qh = wg::smem_addr(smem), ql = qh + QB, kh = ql + QB,
                 kl = kh + KB, vh = kl + KB, vl = vh + KB;
  const int h = blockIdx.x, b = blockIdx.y;
  const int ntq = (Sq + BR - 1) / BR;
  const int split = blockIdx.z % nsplit;
  const int row0 = (ntq - 1 - (int)blockIdx.z / nsplit) * BR;  // heaviest first
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, w = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int off = Sk - Sq;
  const int key_end =
      causal ? min(Sk, off + min(Sq - 1, row0 + BR - 1) + 1) : Sk;
  // this split's key tiles: an even share of the block's
  const int ntk = (key_end + BC - 1) / BC;
  const int tb = split * ntk / nsplit, te = (split + 1) * ntk / nsplit;
  // this warpgroup's rows and the keys they may see
  const int wrow0 = row0 + 64 * w;
  const int wkey_end =
      wrow0 >= Sq ? 0
                  : (causal ? min(Sk, off + min(Sq - 1, wrow0 + 63) + 1) : Sk);
  const int lr = 64 * w + 16 * warp + g;     // tile row of d[4j + {0, 1}]
  const int r_a = row0 + lr, r_b = r_a + 8;

  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;
  const float* mb = mask ? mask + b * msb + h * msh : nullptr;

  // Q scaled (as the plain version: q * scale, rounded once), split
  {
    const float* qb = q + b * qsb + h * qsh;
#pragma unroll 4
    for (int i = tid; i < BR * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < Sq)
        x = *reinterpret_cast<const float4*>(qb + (row0 + r) * qss + c);
      uint4 hi, lo;
      wg::split_tf32(x.x * scale, hi.x, lo.x);
      wg::split_tf32(x.y * scale, hi.y, lo.y);
      wg::split_tf32(x.z * scale, hi.z, lo.z);
      wg::split_tf32(x.w * scale, hi.w, lo.w);
      const uint32_t o = wg::swz32<BR>(r, c);
      *reinterpret_cast<uint4*>(smem + o) = hi;
      *reinterpret_cast<uint4*>(smem + QB + o) = lo;
    }
  }

  Dropout drop;
  uint32_t rk_a = 0, rk_b = 0;
  if constexpr (DROP) {
    drop.init(seed, b, h, thresh, inv_keep);
    rk_a = drop.row(r_a);
    rk_b = drop.row(r_b);
  }
  const float hidden = __fmul_rn(kMasked, wg::kLog2e);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = hidden, m_b = hidden, l_a = 0.f, l_b = 0.f;

  for (int it = tb; it < te; ++it) {
    const int t0 = it * BC;
    __syncthreads();           // the last tile's products are done
    {
      // K rows t0.. as [BC][D] hi / lo: 16 bytes a thread, a row's
      // chunks on neighbouring threads; all loads first
      float4 x[PK];
#pragma unroll
      for (int p = 0; p < PK; ++p) {
        const int i = tid + NT * p, r = i / CH, c = (i % CH) * 4;
        x[p] = t0 + r < key_end
                   ? *reinterpret_cast<const float4*>(kb + (t0 + r) * kss + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int p = 0; p < PK; ++p) {
        const int i = tid + NT * p, r = i / CH, c = (i % CH) * 4;
        uint4 hi, lo;
        wg::split_tf32(x[p].x, hi.x, lo.x);
        wg::split_tf32(x[p].y, hi.y, lo.y);
        wg::split_tf32(x[p].z, hi.z, lo.z);
        wg::split_tf32(x[p].w, hi.w, lo.w);
        const uint32_t so = wg::swz32<BC>(r, c);
        *reinterpret_cast<uint4*>(smem + 2 * QB + so) = hi;
        *reinterpret_cast<uint4*>(smem + 2 * QB + KB + so) = lo;
      }
      // V rows t0.. as V^T [D][BC] hi / lo, keys in key_slot order: a
      // half-warp takes 16 keys of one chunk (the two halves neighbouring
      // chunks, one 32-byte sector a key), each thread stores its 4
      // elements down the column of its key (32 banks a warp)
#pragma unroll
      for (int p = 0; p < PK; ++p) {
        const int task = (tid >> 5) + 4 * NWG * p;
        const int key = (task % (BC / 16)) * 16 + (lane & 15);
        const int c = (2 * (task / (BC / 16)) + (lane >> 4)) * 4;
        x[p] = t0 + key < key_end
                   ? *reinterpret_cast<const float4*>(vb + (t0 + key) * vss +
                                                      c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int p = 0; p < PK; ++p) {
        const int task = (tid >> 5) + 4 * NWG * p;
        const int key = (task % (BC / 16)) * 16 + (lane & 15);
        const int c = (2 * (task / (BC / 16)) + (lane >> 4)) * 4;
        const int slot = wg::key_slot(key);
        const float e[4] = {x[p].x, x[p].y, x[p].z, x[p].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t hi, lo;
          wg::split_tf32(e[j], hi, lo);
          const uint32_t so = wg::swz32<D>(c + j, slot);
          *reinterpret_cast<uint32_t*>(smem + 2 * QB + 2 * KB + so) = hi;
          *reinterpret_cast<uint32_t*>(smem + 2 * QB + 3 * KB + so) = lo;
        }
      }
    }
    wg::fence_async_smem();
    __syncthreads();
    if (t0 >= wkey_end) continue;    // uniform over the warpgroup

    // S = Q K^T: hi hi + hi lo + lo hi
    float s[BC / 2];
    const uint32_t qwh = qh + w * 64 * 128, qwl = ql + w * 64 * 128;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wg::WgmmaTf32<BC>::ss(s, wg::desc_k<BR>(qwh, kk),
                            wg::desc_k<BC>(kh, kk), kk > 0);
      wg::WgmmaTf32<BC>::ss(s, wg::desc_k<BR>(qwh, kk),
                            wg::desc_k<BC>(kl, kk), 1);
      wg::WgmmaTf32<BC>::ss(s, wg::desc_k<BR>(qwl, kk),
                            wg::desc_k<BC>(kh, kk), 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::keep(s);

    // the online softmax in log2 units, as flash_fwd_wgmma (q is scaled)
    const bool edge = mb != nullptr || t0 + BC > key_end ||
                      (causal && t0 + BC - 1 > off + wrow0);
    float mx_a = -INFINITY, mx_b = -INFINITY;
    if (edge) {
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) {
        const int r = (i & 2) ? r_b : r_a;
        const int pos = t0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        float x = s[i] * wg::kLog2e;
        if (pos < key_end) {
          if (mb) x += __fmul_rn(mb[(long long)min(r, Sq - 1) * msq + pos],
                                 wg::kLog2e);
          if (causal && pos > off + r) x = hidden;
        } else {
          x = -INFINITY;
        }
        s[i] = x;
        if (i & 2) mx_b = fmaxf(mx_b, x);
        else mx_a = fmaxf(mx_a, x);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) {
        if (i & 2) mx_b = fmaxf(mx_b, s[i]);
        else mx_a = fmaxf(mx_a, s[i]);
      }
      mx_a *= wg::kLog2e;
      mx_b *= wg::kLog2e;
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = wg::ex2(m_a - mn_a), al_b = wg::ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    if (edge) {
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) s[i] -= (i & 2) ? mn_b : mn_a;
    } else {
#pragma unroll
      for (int i = 0; i < BC / 2; ++i)
        s[i] = fmaf(s[i], wg::kLog2e, (i & 2) ? -mn_b : -mn_a);
    }
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) {
      const float p = wg::ex2(s[i]);
      if (i & 2) sum_b += p;
      else sum_a += p;
      float pv = p;
      if constexpr (DROP)
        pv = drop.apply((i & 2) ? rk_b : rk_a,
                        t0 + 8 * (i >> 2) + 2 * t4 + (i & 1), p);
      s[i] = pv;
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? al_b : al_a;

    // O += P V: P's hi / lo parts as the register A operand, V^T hi / lo
    uint32_t ph[BC / 8][4], pl[BC / 8][4];
#pragma unroll
    for (int kk = 0; kk < BC / 8; ++kk) wg::frag_a_tf32(s, kk, ph[kk], pl[kk]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BC / 8; ++kk) {
      wg::WgmmaTf32<D>::rs(o, ph[kk], wg::desc_k<D>(vh, kk));
      wg::WgmmaTf32<D>::rs(o, ph[kk], wg::desc_k<D>(vl, kk));
      wg::WgmmaTf32<D>::rs(o, pl[kk], wg::desc_k<D>(vh, kk));
    }
    wg::commit();
    wg::wait<0>();
    wg::keep(ph);
    wg::keep(pl);
    wg::keep(o);
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  const long long lo = ((long long)b * H + h) * Sq;
  if (nsplit == 1) {
    const float ls_a = l_a == 0.f ? 1.f : l_a, ls_b = l_b == 0.f ? 1.f : l_b;
    const float inv_a = 1.f / ls_a, inv_b = 1.f / ls_b;
    // a quad writes 8 neighbouring floats (one 32-byte sector) a store
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (r_a < Sq)
        *reinterpret_cast<float2*>(out + (((long long)b * Sq + r_a) * H + h) *
                                             D + c) =
            make_float2(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      if (r_b < Sq)
        *reinterpret_cast<float2*>(out + (((long long)b * Sq + r_b) * H + h) *
                                             D + c) =
            make_float2(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
    if (t4 == 0) {
      if (r_a < Sq)
        lse[lo + r_a] =
            (m_a == hidden ? kMasked : m_a * wg::kLn2) + logf(ls_a);
      if (r_b < Sq)
        lse[lo + r_b] =
            (m_b == hidden ? kMasked : m_b * wg::kLn2) + logf(ls_b);
    }
    return;
  }
  // a split that saw no key merges as m = -inf, l = 0
  if (tb == te) m_a = m_b = -INFINITY;
  const long long rows = (long long)B * H * Sq;
  float* acc = part + ((long long)split * B * H * Sq + lo) * D;
  float* ml = part + (long long)nsplit * rows * D +
              2 * ((long long)split * rows + lo);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (r_a < Sq)
      *reinterpret_cast<float2*>(acc + (long long)r_a * D + c) =
          make_float2(o[4 * j], o[4 * j + 1]);
    if (r_b < Sq)
      *reinterpret_cast<float2*>(acc + (long long)r_b * D + c) =
          make_float2(o[4 * j + 2], o[4 * j + 3]);
  }
  if (t4 == 0) {
    if (r_a < Sq)
      *reinterpret_cast<float2*>(ml + 2 * r_a) = make_float2(m_a, l_a);
    if (r_b < Sq)
      *reinterpret_cast<float2*>(ml + 2 * r_b) = make_float2(m_b, l_b);
  }
}

// The key splits' partial states of flash_fwd_3xtf32 merged: a warp a
// query row, m = max m_i, O = sum 2^(m_i - m) acc_i / sum 2^(m_i - m) l_i
// (an empty split, m_i = -inf, weighs 0), lse as the single-block
// kernel writes it.
template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_3xtf32_merge(const float* __restrict__ part, float* __restrict__ out,
                       float* __restrict__ lse, int nsplit, int B, int H,
                       int Sq) {
  const long long rows = (long long)B * H * Sq;
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float* ml = part + (long long)nsplit * rows * D;
  float m = -INFINITY;
  for (int i = 0; i < nsplit; ++i) m = fmaxf(m, ml[2 * (i * rows + row)]);
  const float hidden = __fmul_rn(kMasked, wg::kLog2e);
  float l = 0.f, acc[D / 32];
#pragma unroll
  for (int j = 0; j < D / 32; ++j) acc[j] = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const float mi = ml[2 * (i * rows + row)];
    const float w = mi == -INFINITY ? 0.f : wg::ex2(mi - m);
    l += w * ml[2 * (i * rows + row) + 1];
    const float* a = part + (i * rows + row) * D;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) acc[j] += w * a[lane + 32 * j];
  }
  const float ls = l == 0.f ? 1.f : l, inv = 1.f / ls;
  const int r = (int)(row % Sq), h = (int)(row / Sq % H);
  const int b = (int)(row / Sq / H);
  float* o = out + (((long long)b * Sq + r) * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 32; ++j) o[lane + 32 * j] = acc[j] * inv;
  if (lane == 0) lse[row] = (m == hidden ? kMasked : m * wg::kLn2) + logf(ls);
}

// Keys a K/V tile of the wgmma kernel: 128, or 64 in dropout mode, whose
// P V takes two products (below) and whose keep bits take registers.
template <bool DROP>
__host__ __device__ constexpr int fwd_keys() {
  return DROP ? 64 : 128;
}

// Shared memory of flash_fwd_wgmma: the query tile, then 2 stages of K
// and V tiles, plus 1024 bytes to align the base.
template <int D, int NWG, bool DROP>
constexpr size_t fwd_wgmma_bytes() {
  return (size_t)64 * NWG * D * 2 + 4 * (size_t)fwd_keys<DROP>() * D * 2 +
         1024;
}

template <typename T, int D, int NWG, bool DROP>
__global__ void __launch_bounds__(128 * NWG, 1)
flash_fwd_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ mask,
                T* __restrict__ out, float* __restrict__ lse, int H, int KVH,
                int Sq, int Sk, long long qsb, long long qss, long long qsh,
                long long ksb, long long kss, long long ksh, long long vsb,
                long long vss, long long vsh, long long msb, long long msh,
                long long msq, int causal, float scale,
                const long long* seed, unsigned thresh, float inv_keep) {
  constexpr int BR = 64 * NWG, BC = fwd_keys<DROP>(), NT = 128 * NWG;
  constexpr int QB = BR * D * 2, KB = BC * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sq = wg::smem_addr(smem);
  const int h = blockIdx.x, b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BR;   // heaviest first
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, g = (tid & 31) >> 2, t4 = tid & 3;
  const int off = Sk - Sq;
  const int key_end =
      causal ? min(Sk, off + min(Sq - 1, row0 + BR - 1) + 1) : Sk;
  // this warpgroup's rows, the keys they may see, and this thread's rows
  const int wrow0 = row0 + 64 * w;
  const int wkey_end =
      wrow0 >= Sq ? 0
                  : (causal ? min(Sk, off + min(Sq - 1, wrow0 + 63) + 1) : Sk);
  const int lr = 64 * w + 16 * warp + g;    // tile row of d[4j + {0, 1}]
  const int r_a = row0 + lr, r_b = r_a + 8;

  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  const float* mb = mask ? mask + b * msb + h * msh : nullptr;
  auto stage_k = [&](int s) { return sq + QB + s * 2 * KB; };

  wg::load_tile<BR, D, NT>(sq, q + b * qsb + h * qsh + row0 * qss, qss,
                           min(BR, Sq - row0), tid);
  const int ntiles = (key_end + BC - 1) / BC;
  wg::load_tile<BC, D, NT>(stage_k(0), kb, kss, min(BC, key_end), tid);
  wg::load_tile<BC, D, NT>(stage_k(0) + KB, vb, vss, min(BC, key_end), tid);
  wg::cp_commit();

  Dropout drop;
  uint32_t rk_a = 0, rk_b = 0;
  if constexpr (DROP) {
    drop.init(seed, b, h, thresh, inv_keep);
    rk_a = drop.row(r_a);
    rk_b = drop.row(r_b);
  }
  const float sl2 = scale * wg::kLog2e;
  // a hidden key's score in log2 units, also the running max's start: a
  // row whose every key is hidden weighs them all alike, as in natural
  // units (rounded once, so the mask's -1e30 lands on it exactly)
  const float hidden = __fmul_rn(kMasked, wg::kLog2e);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running row max (log2 units) and this thread's share of the row sum
  float m_a = hidden, m_b = hidden, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * BC;
    wg::cp_wait_all();
    wg::fence_async_smem();
    __syncthreads();                 // tile it is in; tile it - 1 is read
    if (it + 1 < ntiles) {
      const int t1 = t0 + BC, n1 = min(BC, key_end - t1);
      const uint32_t st = stage_k((it + 1) & 1);
      wg::load_tile<BC, D, NT>(st, kb + t1 * kss, kss, n1, tid);
      wg::load_tile<BC, D, NT>(st + KB, vb + t1 * vss, vss, n1, tid);
      wg::cp_commit();
    }
    if (t0 >= wkey_end) continue;    // uniform over the warpgroup
    const uint32_t sk = stage_k(it & 1), sv = sk + KB;

    float s[BC / 2];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::Wgmma<T, BC>::ss(s, wg::desc_k<BR>(sq + w * 64 * 128, kk),
                           wg::desc_k<BC>(sk, kk), kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::keep(s);

    // Masked tiles (a mask, the causal diagonal, the ragged end) turn the
    // scores into log2 units element by element; the others take the max
    // of the raw scores (scale > 0) and one FFMA an element below.
    const bool edge = mb != nullptr || t0 + BC > key_end ||
                      (causal && t0 + BC - 1 > off + wrow0);
    float mx_a = -INFINITY, mx_b = -INFINITY;
    if (edge) {
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) {
        const int r = (i & 2) ? r_b : r_a;
        const int pos = t0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        float x = s[i] * sl2;
        if (pos < key_end) {
          if (mb) x += __fmul_rn(mb[(long long)min(r, Sq - 1) * msq + pos],
                                 wg::kLog2e);
          if (causal && pos > off + r) x = hidden;
        } else {
          x = -INFINITY;
        }
        s[i] = x;
        if (i & 2) mx_b = fmaxf(mx_b, x);
        else mx_a = fmaxf(mx_a, x);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) {
        if (i & 2) mx_b = fmaxf(mx_b, s[i]);
        else mx_a = fmaxf(mx_a, s[i]);
      }
      mx_a *= sl2;
      mx_b *= sl2;
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = wg::ex2(m_a - mn_a), al_b = wg::ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    // the exponent: s - m where s may be hidden (exact when both are)
    if (edge) {
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) s[i] -= (i & 2) ? mn_b : mn_a;
    } else {
#pragma unroll
      for (int i = 0; i < BC / 2; ++i)
        s[i] = fmaf(s[i], sl2, (i & 2) ? -mn_b : -mn_a);
    }
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) {
      const float p = wg::ex2(s[i]);
      if (i & 2) sum_b += p;
      else sum_a += p;
      float pv = p;
      if constexpr (DROP)
        pv = drop.apply((i & 2) ? rk_b : rk_a,
                        t0 + 8 * (i >> 2) + 2 * t4 + (i & 1), p);
      s[i] = pv;
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? al_b : al_a;

    wg::fence();
    if constexpr (DROP) {
      // dropped p reaches 1 / (1 - p): P V takes p as a 16-bit high part
      // and its 16-bit remainder, so the output keeps the accuracy of f32
      // probabilities where a kept element is scaled up
      uint32_t hi[BC / 16][4], lo[BC / 16][4];
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
        wg::frag_a_split<T>(s, kk, hi[kk], lo[kk]);
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
        wg::Wgmma<T, D>::rs(o, hi[kk], wg::desc_mn<BC>(sv, kk));
        wg::Wgmma<T, D>::rs(o, lo[kk], wg::desc_mn<BC>(sv, kk));
      }
      wg::commit();
      wg::wait<0>();
      wg::keep(hi);
      wg::keep(lo);
    } else {
      uint32_t pa[BC / 16][4];
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) wg::frag_a<T>(s, kk, pa[kk]);
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
        wg::Wgmma<T, D>::rs(o, pa[kk], wg::desc_mn<BC>(sv, kk));
      wg::commit();
      wg::wait<0>();
      wg::keep(pa);
    }
    wg::keep(o);
  }
  if (wrow0 >= Sq) return;

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  const float ls_a = l_a == 0.f ? 1.f : l_a, ls_b = l_b == 0.f ? 1.f : l_b;
  const float inv_a = 1.f / ls_a, inv_b = 1.f / ls_b;
  // O / l into this warpgroup's rows of the query tile (its own products
  // are done), then 16-byte rows out
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    *reinterpret_cast<uint32_t*>(smem + wg::swz<BR>(lr, c)) =
        wg::pack2<T>(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    *reinterpret_cast<uint32_t*>(smem + wg::swz<BR>(lr + 8, c)) =
        wg::pack2<T>(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
  if (t4 == 0) {
    // m is in log2 units; a row whose every key is hidden keeps -1e30
    const long long lo = ((long long)b * H + h) * Sq;
    if (r_a < Sq)
      lse[lo + r_a] = (m_a == hidden ? kMasked : m_a * wg::kLn2) + logf(ls_a);
    if (r_b < Sq)
      lse[lo + r_b] = (m_b == hidden ? kMasked : m_b * wg::kLn2) + logf(ls_b);
  }
  wg::wg_barrier(1 + w);
  constexpr int CH = D / 8;
  for (int i = wt; i < 64 * CH; i += 128) {
    const int r = i / CH, c = (i % CH) * 8, row = wrow0 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(out + (((long long)b * Sq + row) * H + h) * D +
                                c) =
          *reinterpret_cast<const uint4*>(smem + wg::swz<BR>(64 * w + r, c));
  }
}

template <typename T, int D, int NWG, bool DROP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const float* mask, void* out, float* lse, int B,
                         int H, int KVH, int Sq, int Sk, const long long* st,
                         int causal, float scale, const long long* seed,
                         unsigned thresh, float inv_keep,
                         cudaStream_t stream) {
  const size_t smem = fwd_wgmma_bytes<D, NWG, DROP>();
  static bool smem_set = false;
  cudaError_t e =
      allow_smem(flash_fwd_wgmma<T, D, NWG, DROP>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B, (Sq + 64 * NWG - 1) / (64 * NWG));
  flash_fwd_wgmma<T, D, NWG, DROP><<<grid, 128 * NWG, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, H, KVH, Sq,
      Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, scale, seed, thresh, inv_keep);
  return cudaGetLastError();
}

// The SMs of the current device (read once).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// The wgmma kernel at 128-row blocks where they fill the SMs, else at
// 64-row blocks (the same arithmetic a row either way).
template <typename T, int D, bool DROP>
cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v,
                           const float* mask, void* out, float* lse, int B,
                           int H, int KVH, int Sq, int Sk,
                           const long long* st, int causal, float scale,
                           const long long* seed, unsigned thresh,
                           float inv_keep, cudaStream_t stream) {
  if ((long long)((Sq + 127) / 128) * H * B >= sm_count())
    return launch_wgmma<T, D, 2, DROP>(q, k, v, mask, out, lse, B, H, KVH,
                                       Sq, Sk, st, causal, scale, seed,
                                       thresh, inv_keep, stream);
  return launch_wgmma<T, D, 1, DROP>(q, k, v, mask, out, lse, B, H, KVH, Sq,
                                     Sk, st, causal, scale, seed, thresh,
                                     inv_keep, stream);
}

// Warpgroups of the f32 kernel's blocks: two at D 128 (one block an SM:
// two warpgroups share each split K/V tile and hide each other's loads
// and softmax), one at D 64 (two blocks an SM do that).
template <int D>
constexpr int tf_wgs() {
  return D == 128 ? 2 : 1;
}

// Blocks of flash_fwd_3xtf32 an SM (from its registers and shared
// memory, read once).
template <int D, bool DROP>
int tf32_blocks_per_sm() {
  constexpr int NWG = tf_wgs<D>();
  static int n = 0;
  if (n == 0) {
    static bool smem_set = false;
    if (allow_smem(flash_fwd_3xtf32<D, NWG, DROP>, fwd_tf32_bytes<D, NWG>(),
                   &smem_set) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, flash_fwd_3xtf32<D, NWG, DROP>, 128 * NWG,
            fwd_tf32_bytes<D, NWG>()) != cudaSuccess ||
        n < 1)
      n = 1;
  }
  return n;
}

// Key splits of the f32 kernel: 1 where its blocks fill the SMs (at the
// blocks an SM they can hold), else as many as fill them, at most 4 and
// at most one a key tile (the prefill chunk: 32 blocks of 128 rows at D
// 128, one an SM, split in 4).
template <int D, bool DROP>
int tf32_splits(int B, int H, int Sq, int Sk) {
  constexpr int BR = 64 * tf_wgs<D>();
  const long long blocks = (long long)B * H * ((Sq + BR - 1) / BR);
  const long long slots = (long long)sm_count() * tf32_blocks_per_sm<D, DROP>();
  if (blocks <= 0 || blocks >= slots) return 1;
  const long long n = std::min<long long>(
      {4, slots / blocks, (Sk + tf_keys<D>() - 1) / tf_keys<D>()});
  return n < 1 ? 1 : (int)n;
}

// Floats of the workspace that the key splits' partial states take:
// acc [nsplit][B][H][Sq][D], then (m, l) [nsplit][B][H][Sq][2]; 0 without
// a split.
inline long long tf32_workspace(int nsplit, int B, int H, int Sq, int D) {
  return nsplit == 1 ? 0 : (long long)nsplit * B * H * Sq * (D + 2);
}

template <int D, bool DROP>
cudaError_t launch_3xtf32(const void* q, const void* k, const void* v,
                          const float* mask, void* out, float* lse,
                          float* part, long long part_floats, int B, int H,
                          int KVH, int Sq, int Sk, const long long* st,
                          int causal, float scale, const long long* seed,
                          unsigned thresh, float inv_keep,
                          cudaStream_t stream) {
  constexpr int NWG = tf_wgs<D>();
  const int nsplit = tf32_splits<D, DROP>(B, H, Sq, Sk);
  if (nsplit > 1 &&
      (part == nullptr || part_floats < tf32_workspace(nsplit, B, H, Sq, D)))
    return cudaErrorInvalidValue;
  const size_t smem = fwd_tf32_bytes<D, NWG>();
  static bool smem_set = false;
  cudaError_t e =
      allow_smem(flash_fwd_3xtf32<D, NWG, DROP>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B, ((Sq + 64 * NWG - 1) / (64 * NWG)) * nsplit);
  flash_fwd_3xtf32<D, NWG, DROP><<<grid, 128 * NWG, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(out), lse,
      part, nsplit, B, H, KVH, Sq, Sk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal, scale, seed,
      thresh, inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  const long long rows = (long long)B * H * Sq;
  flash_fwd_3xtf32_merge<D><<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(
      part, static_cast<float*>(out), lse, nsplit, B, H, Sq);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_drop(const void* q, const void* k, const void* v,
                          const float* mask, void* out, float* lse, int B,
                          int H, int KVH, int Sq, int Sk,
                          const long long* st, int causal, float scale,
                          const long long* seed, unsigned thresh,
                          float inv_keep, cudaStream_t stream) {
  if (seed)
    return dispatch_wgmma<T, D, true>(q, k, v, mask, out, lse, B, H, KVH,
                                      Sq, Sk, st, causal, scale, seed,
                                      thresh, inv_keep, stream);
  return dispatch_wgmma<T, D, false>(q, k, v, mask, out, lse, B, H, KVH, Sq,
                                     Sk, st, causal, scale, seed, thresh,
                                     inv_keep, stream);
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const float* mask, void* out, float* lse, int B,
                       int H, int KVH, int Sq, int Sk, const long long* st,
                       int causal, float scale, const long long* seed,
                       unsigned thresh, float inv_keep, cudaStream_t stream) {
  if (D == 64)
    return dispatch_drop<T, 64>(q, k, v, mask, out, lse, B, H, KVH, Sq, Sk,
                                st, causal, scale, seed, thresh, inv_keep,
                                stream);
  if (D == 128)
    return dispatch_drop<T, 128>(q, k, v, mask, out, lse, B, H, KVH, Sq, Sk,
                                 st, causal, scale, seed, thresh, inv_keep,
                                 stream);
  return cudaErrorInvalidValue;
}

}  // namespace ptt

extern "C" {

// Floats of workspace the f32 route needs at this shape for its key
// splits (0 where the keys do not split), and the number of splits into
// *nsplit where it is not null.  Dropout (0/1) picks the kernel whose
// occupancy counts.
long long flash_attention_fwd_workspace(int B, int H, int Sq, int Sk, int D,
                                        int dropout, int* nsplit) {
  int n = 1;
  if (D == 64)
    n = dropout ? ptt::tf32_splits<64, true>(B, H, Sq, Sk)
                : ptt::tf32_splits<64, false>(B, H, Sq, Sk);
  else if (D == 128)
    n = dropout ? ptt::tf32_splits<128, true>(B, H, Sq, Sk)
                : ptt::tf32_splits<128, false>(B, H, Sq, Sk);
  if (nsplit) *nsplit = n;
  return ptt::tf32_workspace(n, B, H, Sq, D);
}

// strides (elements): q b/s/h, k b/s/h, v b/s/h, mask b/h/q (0 where the
// mask broadcasts); dtype: 0 float32, 1 bfloat16, 2 float16; seed: a
// device int64 for dropout (null: none), thresh the keep threshold and
// inv_keep 1 / (1 - p); part and part_floats the f32 route's workspace
// (flash_attention_fwd_workspace; ignored for bf16 / f16).  Returns a
// cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const float* mask, void* out, float* lse, int B,
                        int H, int KVH, int Sq, int Sk, int D,
                        const long long* strides, int causal, float scale,
                        int dtype, const long long* seed, unsigned thresh,
                        float inv_keep, float* part, long long part_floats,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
#define PTT_TF32(DD, DR)                                                    \
  ptt::launch_3xtf32<DD, DR>(q, k, v, mask, out, lse, part, part_floats,   \
                             B, H, KVH, Sq, Sk, strides, causal, scale,    \
                             seed, thresh, inv_keep, s)
      if (D == 64) return seed ? PTT_TF32(64, true) : PTT_TF32(64, false);
      if (D == 128) return seed ? PTT_TF32(128, true) : PTT_TF32(128, false);
#undef PTT_TF32
      return cudaErrorInvalidValue;
    case 1:
      return ptt::dispatch_d<__nv_bfloat16>(D, q, k, v, mask, out, lse, B, H,
                                            KVH, Sq, Sk, strides, causal,
                                            scale, seed, thresh, inv_keep, s);
    case 2:
      return ptt::dispatch_d<__half>(D, q, k, v, mask, out, lse, B, H, KVH,
                                     Sq, Sk, strides, causal, scale, seed,
                                     thresh, inv_keep, s);
  }
  return cudaErrorInvalidValue;
}

const char* flash_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
