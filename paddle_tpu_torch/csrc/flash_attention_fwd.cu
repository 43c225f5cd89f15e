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
// Semantics (both routes).  Inputs [B, S, H, D] with any batch, sequence
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
// f32: `flash_fwd`, the FMA-pipe kernel of attention_tile.cuh (64-row
// blocks, 64-key tiles, 4 x 4 register tiles of f32 FMAs): the f32
// checks hold it to 1e-5 of the plain version, which TF32 would not.
#include "attention_wgmma.cuh"

namespace ptt {


template <typename T, int D, bool DROP>
struct FlashCtx {
  static constexpr bool kDropout = DROP;
  Dropout drop;
  const T* q;
  const T* k;
  const T* v;
  const float* bias;   // the additive mask, null when there is none
  long long qss, kss, vss, msq;
  int sq, off, row0, rows, key_end, causal;

  __device__ const T* q_row(int lr) const {
    const int r = row0 + lr;
    return r < sq ? q + (long long)r * qss : nullptr;
  }
  __device__ long long k_off(int pos) const { return (long long)pos * kss; }
  __device__ long long v_off(int pos) const { return (long long)pos * vss; }
  __device__ float mask(int lr, int pos, float s) const {
    const int r = min(row0 + lr, sq - 1);
    if (bias) s += bias[(long long)r * msq + pos];
    if (causal && pos > off + r) s = kMasked;
    return s;
  }
};

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ mask,
          T* __restrict__ out, float* __restrict__ lse, int H, int KVH,
          int Sq, int Sk, long long qsb, long long qss, long long qsh,
          long long ksb, long long kss, long long ksh, long long vsb,
          long long vss, long long vsh, long long msb, long long msh,
          long long msq, int causal, float scale, const long long* seed,
          unsigned thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int row0 = blockIdx.x * BR;

  FlashCtx<T, D, DROP> ctx;
  if constexpr (DROP) ctx.drop.init(seed, b, h, thresh, inv_keep);
  ctx.q = q + b * qsb + h * qsh;
  ctx.k = k + b * ksb + kvh * ksh;
  ctx.v = v + b * vsb + kvh * vsh;
  ctx.bias = mask ? mask + b * msb + h * msh : nullptr;
  ctx.qss = qss;
  ctx.kss = kss;
  ctx.vss = vss;
  ctx.msq = msq;
  ctx.sq = Sq;
  ctx.off = Sk - Sq;
  ctx.row0 = row0;
  ctx.rows = min(BR, Sq - row0);
  ctx.causal = causal;
  const int last = min(Sq - 1, row0 + BR - 1);
  ctx.key_end = causal ? min(Sk, ctx.off + last + 1) : Sk;

  RowState<D> st;
  attend_rows<T, D>(ctx, scale, smem, st);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float lsafe = st.l[i] == 0.f ? 1.f : st.l[i];
    T* o = out + (((long long)b * Sq + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) o[tx + 16 * c] = from_f<T>(st.acc[i][c] / lsafe);
    if (tx == 0) lse[((long long)b * H + h) * Sq + r] = st.m[i] + logf(lsafe);
  }
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

template <typename T, int D, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* out, float* lse, int B, int H,
                   int KVH, int Sq, int Sk, const long long* st,
                   int causal, float scale, const long long* seed,
                   unsigned thresh, float inv_keep, cudaStream_t stream) {
  const size_t smem = Tile<T, D>::kBytes;
  static bool smem_set = false;
  cudaError_t e = allow_smem(flash_fwd<T, D, DROP>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BR - 1) / BR, H, B);
  flash_fwd<T, D, DROP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, H, KVH, Sq,
      Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, scale, seed, thresh, inv_keep);
  return cudaGetLastError();
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

// The kernel of a dtype: f32 on the FMA pipe, bf16 / f16 on wgmma.
template <typename T, int D, bool DROP>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const float* mask, void* out, float* lse, int B,
                         int H, int KVH, int Sq, int Sk, const long long* st,
                         int causal, float scale, const long long* seed,
                         unsigned thresh, float inv_keep,
                         cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return launch<T, D, DROP>(q, k, v, mask, out, lse, B, H, KVH, Sq, Sk, st,
                              causal, scale, seed, thresh, inv_keep, stream);
  else
    return dispatch_wgmma<T, D, DROP>(q, k, v, mask, out, lse, B, H, KVH, Sq,
                                      Sk, st, causal, scale, seed, thresh,
                                      inv_keep, stream);
}

template <typename T, int D>
cudaError_t dispatch_drop(const void* q, const void* k, const void* v,
                          const float* mask, void* out, float* lse, int B,
                          int H, int KVH, int Sq, int Sk,
                          const long long* st, int causal, float scale,
                          const long long* seed, unsigned thresh,
                          float inv_keep, cudaStream_t stream) {
  if (seed)
    return launch_dtype<T, D, true>(q, k, v, mask, out, lse, B, H, KVH, Sq,
                                    Sk, st, causal, scale, seed, thresh,
                                    inv_keep, stream);
  return launch_dtype<T, D, false>(q, k, v, mask, out, lse, B, H, KVH, Sq,
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

// strides (elements): q b/s/h, k b/s/h, v b/s/h, mask b/h/q (0 where the
// mask broadcasts); dtype: 0 float32, 1 bfloat16, 2 float16; seed: a
// device int64 for dropout (null: none), thresh the keep threshold and
// inv_keep 1 / (1 - p).  Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const float* mask, void* out, float* lse, int B,
                        int H, int KVH, int Sq, int Sk, int D,
                        const long long* strides, int causal, float scale,
                        int dtype, const long long* seed, unsigned thresh,
                        float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return ptt::dispatch_d<float>(D, q, k, v, mask, out, lse, B, H, KVH,
                                    Sq, Sk, strides, causal, scale, seed,
                                    thresh, inv_keep, s);
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
