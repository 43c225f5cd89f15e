// Ragged paged append + attention for the serving engine's unified step.
//
// Replaces the TPU kernel `_ragged_kernel` / `_stream_pages_ragged`
// behind `ragged_paged_append_attend_raw`
// (paddle_tpu/ops/pallas/paged_attention.py).  One call serves a whole
// mixed prefill + decode batch, described by per-descriptor scalars
// (q_start, q_len, kv_len) and a page table per descriptor: descriptor s
// owns flat rows [q_start, q_start + q_len), which land at positions
// kv_len .. kv_len + q_len - 1 of its sequence, all inside one page.
// Descriptors' flat rows are disjoint (the engine lays them back to
// back); the output is out [S, P, H, D], rows j >= q_len zero.
//
// What bounds it on an H100: bytes, and most of them are zeros.  At the
// engine's shapes (S 136, P 128, 32 query heads, bf16) the output block
// is 142.6 MB of the 155 MB the bound counts; the live rows (a few
// decode rows and one 128-row prefill chunk) read a few MB of pages.
// So the design writes the zeros beside the attention, not before it,
// and keeps the attention's critical path (its longest sequence) short.
//
// Two launches, in stream order:
//   1. ragged_append — a block per (kv head, descriptor) copies the
//      descriptor's new K/V rows into their page slots (blocks of
//      descriptors without rows exit at once), and block 0 builds the
//      plan: the list of attention items (descriptor, kv head, 64-row
//      block, key split), read from the descriptors on the device (the
//      host reads no length: no sync).  The TPU grid runs in order, so a
//      prompt split over two descriptors of one call sees its first
//      chunk's page; CUDA blocks run in no order, so every append
//      finishes before any attention starts.
//   2. ragged_attend_mma (q and pools in one 16-bit type) or
//      ragged_attend_3xtf32 (f32 q or pools, pools of another float
//      type, int8 pools) — a persistent grid, every block resident: block
//      b takes items b, b + grid, ..., then claims 64 KB units of the
//      output rows without a query from a counter and writes them with
//      16-byte streaming stores.  Blocks without an item start on the
//      zeros at once, so the zeros run beside the attention, and a block
//      whose items ran long claims fewer units.
//      An item is one 64-row block of one kv head (4 warps x 16 rows: the
//      G query heads of q_len rows, G * q_len rows a kv head; a decode
//      row at group 4 is 4 rows, not a 64-row tile) over one span of its
//      keys: about 128 keys on the mma route, 256 on the 3xtf32 one (a
//      multiple of 64, at most 8 spans), so a long sequence's keys
//      spread over blocks (flash-decoding) and a block streams at most a
//      few tiles.  A prefill chunk's row blocks are split too on the
//      3xtf32 route, whose tiles cost several times the mma route's.
//      K and V tiles come through a 2-stage cp.async ring of 16-byte
//      loads, one tile ahead of the math.  A warp whose rows see no key
//      of a tile skips it (the causal prefill chunk).
//        mma: S = Q K^T and O += P V on mma.sync.m16n8k16 with f32
//        accumulators; Q stays in registers as A fragments, K and V^T
//        fragments come by ldmatrix from 16-byte padded rows (no bank
//        conflicts), P is rounded to 16 bits as the A operand of P V.
//        3xtf32: both products on mma.sync.m16n8k8 TF32, each f32
//        operand split into a TF32 high part and the TF32 rounding of
//        the rest (3xTF32: hi hi' + hi lo' + lo hi', about 2^-22 of a
//        product).  16-bit values and int8 codes are TF32 already and
//        are not split: int8 pools multiply S by the key's scale and P
//        by the value's scale in f32.  The A operand of P V takes the
//        accumulator's columns 2 t4, 2 t4 + 1 as its k slots t4, t4 + 4,
//        so V is read at those keys.  Q is staged in shared memory in
//        f32.
//      A row block with one split writes its output rows normalised;
//      with several, each split writes its rows' unnormalised f32 sums
//      and (max, sum) to scratch the wrapper allocates, fences them and
//      counts itself done on the row block's counter (the plan zeroed
//      it); the block that counts last merges the row block: its rows'
//      splits in split order, a lane a row and half its columns (the
//      same bits whichever block merges, on every launch).  The merge
//      runs beside the zeros, and the zeros are streaming stores, so the
//      pages and the splits' sums stay in L2.
//
// Int8 pools (`int8`): the pools hold int8 codes and the scale pools
// [KVH, n_pages, P] f32 one scale per token row.  The append launch
// quantizes each live row in a warp, as quantization/ops.py
// quantize_rows does (int8_kv.cuh: the same codes and scale bit for
// bit).  Float pools of another float type than q (the mixed-dtype
// mode): the append launch casts each new row to the pool type (round
// to nearest even, as Tensor.to does, so the pools equal the plain
// version's bit for bit).  Scores, sums and the softmax are f32 and the
// output is q's type in every mode, as the reference computes them.
#include "attention_wgmma.cuh"
#include "int8_kv.cuh"

namespace ptt {
namespace rg {

constexpr int kRows = 64;            // query rows of an item: 4 warps x 16
constexpr int kThreads = 128;
constexpr int kAppendThreads = 512;
constexpr int kMaxSplits = 8;        // splits of a row block's keys
constexpr int kZeroUnit = 4096;      // 16-byte chunks of a unit of zeros
constexpr int kMmaSpan = 128;        // keys a split aims at, by route
constexpr int kTf32Span = 256;

// What every launch derives from a descriptor's scalars.  A row block rb
// of a descriptor sees keys up to key_end(rb) (its last row's causal
// limit), cut into splits(ql, key_end) spans of span(ql, key_end) keys,
// an item each: about `target` keys a span, a multiple of 64, at most
// split_max spans.  On the mma route (`split_chunks` false) a descriptor
// of several row blocks (a prefill chunk) keeps each row block's keys
// whole: its row blocks already spread it over the SMs, and its tiles
// are cheap next to an item's fixed cost.
struct Geo {
  int G, P, maxp, split_max;
  bool split_chunks;
  int target;

  __device__ __forceinline__ int row_blocks(int ql) const {
    return (G * ql + kRows - 1) / kRows;
  }
  __device__ __forceinline__ int key_end(int kv, int ql, int rb) const {
    return min(kv + min(ql - 1, (kRows * rb + kRows - 1) / G) + 1,
               maxp * P);
  }
  __device__ __forceinline__ int span(int ql, int ke) const {
    const int n = split_chunks || row_blocks(ql) == 1
                      ? min(split_max, (ke + target - 1) / target)
                      : 1;
    return ((ke + n - 1) / n + 63) / 64 * 64;
  }
  __device__ __forceinline__ int splits(int ql, int ke) const {
    return (ke + span(ql, ke) - 1) / span(ql, ke);
  }
};

// Clamped descriptor scalars.
__device__ __forceinline__ int q_len_of(const int* q_len, int s, int P) {
  return min(max(__ldg(q_len + s), 0), P);
}
__device__ __forceinline__ int kv_len_of(const int* kv_len, int s) {
  return max(__ldg(kv_len + s), 0);
}

// An item: .x the descriptor, .y kv head | row block << 8 | split << 20.
__device__ __forceinline__ int2 pack_item(int s, int h, int rb, int j) {
  return make_int2(s, h | (rb << 8) | (j << 20));
}

// Block-wide: lists every item of descriptors [0, S) in descriptor, row
// block, split, kv head order (a warp a descriptor's items), zeroes each
// item's merge counter, counts the items (counters[0]) and zeroes the
// attention launch's counter of claimed units of zeros (counters[1]).
__device__ void build_plan(const int* q_len, const int* kv_len, int S,
                           int KVH, const Geo& geo, int2* items, int* merged,
                           int* counters) {
  __shared__ int scan[kAppendThreads];
  __shared__ int base;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) base = 0;
  for (int s0 = 0; s0 < S; s0 += kAppendThreads) {
    int units = 0;
    if (s0 + tid < S) {
      const int ql = q_len_of(q_len, s0 + tid, geo.P);
      const int kv = kv_len_of(kv_len, s0 + tid);
      for (int rb = 0; rb < geo.row_blocks(ql); ++rb)
        units += geo.splits(ql, geo.key_end(kv, ql, rb));
    }
    __syncthreads();                 // base is settled, scan is free
    scan[tid] = units * KVH;
    __syncthreads();
    for (int off = 1; off < kAppendThreads; off <<= 1) {
      const int v = tid >= off ? scan[tid - off] : 0;
      __syncthreads();
      scan[tid] += v;
      __syncthreads();
    }
    for (int d = warp; d < kAppendThreads && s0 + d < S;
         d += kAppendThreads / 32) {
      const int s = s0 + d;
      int at = base + (d ? scan[d - 1] : 0);
      const int ql = q_len_of(q_len, s, geo.P), kv = kv_len_of(kv_len, s);
      for (int rb = 0; rb < geo.row_blocks(ql); ++rb) {
        const int n = geo.splits(ql, geo.key_end(kv, ql, rb)) * KVH;
        for (int k = lane; k < n; k += 32) {
          items[at + k] = pack_item(s, k % KVH, rb, k / KVH);
          merged[at + k] = 0;
        }
        at += n;
      }
    }
    __syncthreads();                 // every thread has read base
    if (tid == kAppendThreads - 1) base += scan[tid];
  }
  __syncthreads();
  if (tid == 0) {
    counters[0] = base;
    counters[1] = 0;
  }
}

// 4 elements of one float type rounded to another (to nearest even, as
// Tensor.to rounds), one vector load and one vector store.
template <typename TS, typename TD>
__device__ __forceinline__ void cast4(const TS* src, TD* dst) {
  struct alignas(4 * sizeof(TS)) In { TS e[4]; };
  struct alignas(4 * sizeof(TD)) Out { TD e[4]; };
  const In in = *reinterpret_cast<const In*>(src);
  Out out;
#pragma unroll
  for (int i = 0; i < 4; ++i) out.e[i] = from_f<TD>(to_f(in.e[i]));
  *reinterpret_cast<Out*>(dst) = out;
}

// Block 0 builds the plan; block 1 + h + KVH s copies descriptor s's new
// K/V rows (q's type T) into kv head h's page slots (pool type TP):
// 16-byte copies in T, 4-element vectors cast through f32 into another
// float type, or (int8 pools) a warp a row quantizing codes and scale.
template <typename T, typename TP, int D>
__global__ void __launch_bounds__(kAppendThreads)
ragged_append(const T* __restrict__ k_new, const T* __restrict__ v_new,
              TP* __restrict__ k_pages, TP* __restrict__ v_pages,
              float* __restrict__ k_scales, float* __restrict__ v_scales,
              const int* __restrict__ q_start, const int* __restrict__ q_len,
              const int* __restrict__ kv_len, const int* __restrict__ tables,
              int2* __restrict__ items, int* __restrict__ merged,
              int* __restrict__ counters, int S, int KVH, int n_pages,
              Geo geo) {
  if (blockIdx.x == 0) {
    build_plan(q_len, kv_len, S, KVH, geo, items, merged, counters);
    return;
  }
  const int h = (blockIdx.x - 1) % KVH, s = (blockIdx.x - 1) / KVH;
  const int P = geo.P, maxp = geo.maxp;
  const int ql = q_len_of(q_len, s, P);
  if (ql == 0) return;
  const int kv = kv_len_of(kv_len, s), qs = q_start[s];
  const int* table = tables + (size_t)s * maxp;
  auto slot = [&](int r) -> long long {   // pool row of new row r, or -1
    const int pos = kv + r;
    if (pos / P >= maxp) return -1;
    const int page = table[pos / P];
    if (page < 0 || page >= n_pages) return -1;
    return ((long long)h * n_pages + page) * P + pos % P;
  };
  if constexpr (std::is_same<TP, int8_t>::value) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 4
    for (int r = warp; r < ql; r += kAppendThreads / 32) {
      const long long row = slot(r);
      if (row < 0) continue;
      const size_t src = ((size_t)(qs + r) * KVH + h) * D;
      quantize_row_warp<T, D>(k_new + src, k_pages + row * D,
                              k_scales + row, lane);
      quantize_row_warp<T, D>(v_new + src, v_pages + row * D,
                              v_scales + row, lane);
    }
  } else {
    // 16-byte copies in T; into another float type, 4 elements a step
    constexpr bool SAME = std::is_same<T, TP>::value;
    constexpr int VEC = SAME ? 16 / (int)sizeof(T) : 4;
    constexpr int CH = D / VEC;              // steps a row
#pragma unroll 4
    for (int idx = threadIdx.x; idx < ql * CH; idx += kAppendThreads) {
      const int r = idx / CH, c = idx % CH;
      const long long row = slot(r);
      if (row < 0) continue;
      const size_t dst = row * D + c * VEC;
      const size_t src = ((size_t)(qs + r) * KVH + h) * D + c * VEC;
      if constexpr (SAME) {
        *reinterpret_cast<uint4*>(k_pages + dst) =
            *reinterpret_cast<const uint4*>(k_new + src);
        *reinterpret_cast<uint4*>(v_pages + dst) =
            *reinterpret_cast<const uint4*>(v_new + src);
      } else {
        cast4(k_new + src, k_pages + dst);
        cast4(v_new + src, v_pages + dst);
      }
    }
  }
}

// -------------------------------------------------------- attention

// The K/V ring of a pool type: 2 stages of KT keys, each key row padded
// by 16 bytes (ldmatrix rows and the 3xtf32 fragment loads fall in
// distinct banks); int8 pools add the keys' K and V scales.
template <typename TP, int D>
struct Ring {
  static constexpr bool kInt8 = std::is_same<TP, int8_t>::value;
  static constexpr int KT = sizeof(TP) == 4 ? 32 : 64;   // keys a stage
  static constexpr int PITCH = D * (int)sizeof(TP) + 16;  // bytes a key
  static constexpr int TILE = KT * PITCH;                 // K (or V)
  static constexpr int SCALES = kInt8 ? KT * 4 : 0;
  static constexpr int STAGE = 2 * TILE + 2 * SCALES;
  static constexpr int kBytes = 2 * STAGE;
};
// the 3xtf32 route's f32 Q rows after the ring
template <int D>
struct QRows {
  static constexpr int PITCH = D + 4;                     // floats a row
  static constexpr int kBytes = kRows * PITCH * 4;
};

template <typename T, typename TP>
struct Args {
  const T* q;
  const TP* k;
  const TP* v;
  const float* ks;        // int8 pools: per-token scales, else null
  const float* vs;
  const int* q_start;
  const int* q_len;
  const int* kv_len;
  const int* tables;
  const int2* items;
  int* merged;            // an item's splits done (at its split 0's index)
  int* counters;          // [0] items, [1] units of zeros claimed
  T* out;
  float* part;            // [T, H, split_max, D] f32 sums of a split
  float2* ml;             // [T, H, split_max] (max, sum) of a split
  int S, H, KVH, n_pages;
  Geo geo;
  float scale_log2;       // softmax scale * log2(e)
};

// One item's rows, keys and warp.
struct Item {
  int s, kvh, j, qs, rows, row0, nsplit, k_begin, k_end;
  int warp, lane, g, t4;
  bool live;              // the warp has a row with a query
  int w_end;              // one past the last key the warp's rows see
  int lim[2];             // the last key rows g, g + 8 of the warp see

  template <typename A>
  __device__ __forceinline__ Item(const A& a, int2 w) {
    s = w.x;
    kvh = w.y & 255;
    const int rb = (w.y >> 8) & 4095;
    j = w.y >> 20;
    const Geo& geo = a.geo;
    const int ql = q_len_of(a.q_len, s, geo.P);
    const int kv = kv_len_of(a.kv_len, s);
    qs = __ldg(a.q_start + s);
    rows = geo.G * ql;
    row0 = kRows * rb;
    const int ke = geo.key_end(kv, ql, rb);
    nsplit = geo.splits(ql, ke);
    k_begin = j * geo.span(ql, ke);
    k_end = min(ke, k_begin + geo.span(ql, ke));
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t4 = lane & 3;
    const int wr0 = row0 + 16 * warp;
    live = wr0 < rows;
    w_end = kv + min(ql - 1, (wr0 + 15) / geo.G) + 1;
    lim[0] = kv + (wr0 + g) / geo.G;
    lim[1] = kv + (wr0 + g + 8) / geo.G;
  }
  // the flat row of the item's query row rr
  __device__ __forceinline__ int t_of(int rr, int G) const {
    return qs + rr / G;
  }
};

// Element offset of key pos's row in the pools (kv head kvh), or -1.
template <typename T, typename TP>
__device__ __forceinline__ long long key_row(const Args<T, TP>& a,
                                             const int* table, int kvh,
                                             int pos, int D) {
  const int P = a.geo.P, pi = pos / P;
  if (pi >= a.geo.maxp) return -1;
  const int page = __ldg(table + pi);
  if (page < 0 || page >= a.n_pages) return -1;
  return (((long long)kvh * a.n_pages + page) * P + pos % P) * D;
}

// Starts copying keys [t0, t0 + KT) (those below k_end; the rest zeros)
// of K, V (and their int8 scales) into stage st.
template <typename T, typename TP, int D>
__device__ __forceinline__ void load_stage(const Args<T, TP>& a,
                                           const Item& it, uint32_t st,
                                           int t0) {
  using R = Ring<TP, D>;
  constexpr int EPC = 16 / (int)sizeof(TP), CH = D / EPC;
  const int* table = a.tables + (size_t)it.s * a.geo.maxp;
  for (int i = threadIdx.x; i < R::KT * CH; i += kThreads) {
    const int key = i / CH, c = i % CH, pos = t0 + key;
    const long long off =
        pos < it.k_end ? key_row(a, table, it.kvh, pos, D) : -1;
    const bool ok = off >= 0;
    const long long e = ok ? off + c * EPC : 0;
    wg::cp16(st + key * R::PITCH + c * 16, a.k + e, ok);
    wg::cp16(st + R::TILE + key * R::PITCH + c * 16, a.v + e, ok);
  }
  if constexpr (R::kInt8) {
    for (int key = threadIdx.x; key < R::KT; key += kThreads) {
      const int pos = t0 + key;
      const long long off =
          pos < it.k_end ? key_row(a, table, it.kvh, pos, D) : -1;
      const bool ok = off >= 0;
      const long long r = ok ? off / D : 0;
      wg::cp4(st + 2 * R::TILE + key * 4, a.ks + r, ok);
      wg::cp4(st + 2 * R::TILE + R::SCALES + key * 4, a.vs + r, ok);
    }
  }
}

// The online softmax of a tile's scores s (the thread's rows g, g + 8;
// keys t0 + 8 jn + 2 t4 + {0, 1}): masks keys past k_end or past a row's
// causal limit, rescales l and acc, leaves p = 2^(s - m) in s.
template <int NJ, int NA>
__device__ __forceinline__ void online_softmax(float (&s)[NJ][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&acc)[NA][4],
                                               const Item& it, int t0,
                                               float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = t0 + 8 * jn + 2 * it.t4 + (e & 1);
      const float x = key < it.k_end && key <= it.lim[e >> 1]
                          ? s[jn][e] * scale_log2
                          : -INFINITY;
      s[jn][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float mu[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    mu[r] = m_new == -INFINITY ? 0.f : m_new;  // no key yet: p = 0
    alpha[r] = wg::ex2(m[r] - mu[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = wg::ex2(s[jn][e] - mu[e >> 1]);
      s[jn][e] = p;
      l[e >> 1] += p;
    }
#pragma unroll
  for (int n = 0; n < NA; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

// ---- mma route: 16-bit q over pools of its type

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 64-key tile of the warp's 16 rows: S = Q K^T (Q in A fragments
// qf), the softmax, O += P V.
template <typename T, int D>
__device__ __forceinline__ void tile_mma(uint32_t st,
                                         const uint32_t (&qf)[D / 16][4],
                                         float (&acc)[D / 8][4],
                                         float (&m)[2], float (&l)[2],
                                         const Item& it, int t0,
                                         float scale_log2) {
  using R = Ring<T, D>;
  const int lane = it.lane;
  float s[8][4];
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[jn][e] = 0.f;
  // K rows 16 np + (lane & 7) + 8 (lane >= 16), d 16 ks + 8 ((lane / 8) & 1):
  // b0, b1 of key tile 2 np, then of 2 np + 1
  const uint32_t kb = st + ((lane & 7) + ((lane >> 4) << 3)) * R::PITCH +
                      ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, kb + 16 * np * R::PITCH + 32 * ks);
      mma16<T>(s[2 * np], qf[ks], b[0], b[1]);
      mma16<T>(s[2 * np + 1], qf[ks], b[2], b[3]);
    }
  online_softmax<8, D / 8>(s, m, l, acc, it, t0, scale_log2);
  // V rows 16 kk + (lane & 15), columns 16 np + 8 (lane >= 16),
  // transposed: b0, b1 of column tile 2 np, then of 2 np + 1
  const uint32_t vb = st + R::TILE + (lane & 15) * R::PITCH + (lane >> 4) * 16;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {wg::pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                           wg::pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                           wg::pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           wg::pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, vb + 16 * kk * R::PITCH + 32 * np);
      mma16<T>(acc[2 * np], a, b[0], b[1]);
      mma16<T>(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// ---- 3xtf32 route: f32 q or pools, mixed float types, int8 pools

__device__ __forceinline__ void mma8(float (&c)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x as TF32 operand parts: hi (and lo when SPLIT; an exact TF32 value
// needs none)
template <bool SPLIT>
__device__ __forceinline__ void tf32_parts(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (SPLIT)
    wg::split_tf32(x, hi, lo);
  else
    hi = __float_as_uint(x);
}
// pool element (key, d) of a staged tile as f32 (an int8 code unscaled)
template <typename TP, int D>
__device__ __forceinline__ float pool_f(const unsigned char* tile, int key,
                                        int d) {
  return elem_f(*reinterpret_cast<const TP*>(
      tile + key * Ring<TP, D>::PITCH + d * (int)sizeof(TP)));
}

// One KT-key tile of the warp's 16 rows, Q in f32 rows sq (pitch
// QRows<D>::PITCH).  SQ: q is f32 (split); pools of f32 are split too.
template <typename TP, int D, bool SQ>
__device__ __forceinline__ void tile_tf32(const unsigned char* st,
                                          const float* sq,
                                          float (&acc)[D / 8][4],
                                          float (&m)[2], float (&l)[2],
                                          const Item& it, int t0,
                                          float scale_log2) {
  using R = Ring<TP, D>;
  constexpr int NJ = R::KT / 8;
  constexpr bool SK = std::is_same<TP, float>::value;
  const int g = it.g, t4 = it.t4;
  const unsigned char* kt = st;
  const unsigned char* vt = st + R::TILE;
  float s[NJ][4];
#pragma unroll
  for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[jn][e] = 0.f;
  const float* qa = sq + (16 * it.warp + g) * QRows<D>::PITCH;
  const float* qb = qa + 8 * QRows<D>::PITCH;
#pragma unroll 2
  for (int kq = 0; kq < D / 8; ++kq) {
    const int d = 8 * kq + t4;
    uint32_t ah[4], al[4];
    tf32_parts<SQ>(qa[d], ah[0], al[0]);
    tf32_parts<SQ>(qb[d], ah[1], al[1]);
    tf32_parts<SQ>(qa[d + 4], ah[2], al[2]);
    tf32_parts<SQ>(qb[d + 4], ah[3], al[3]);
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn) {
      uint32_t bh[2], bl[2];
      tf32_parts<SK>(pool_f<TP, D>(kt, 8 * jn + g, d), bh[0], bl[0]);
      tf32_parts<SK>(pool_f<TP, D>(kt, 8 * jn + g, d + 4), bh[1], bl[1]);
      if constexpr (SQ) mma8(s[jn], al, bh[0], bh[1]);
      if constexpr (SK) mma8(s[jn], ah, bl[0], bl[1]);
      mma8(s[jn], ah, bh[0], bh[1]);
    }
  }
  if constexpr (R::kInt8) {
    const float* ksc = reinterpret_cast<const float*>(st + 2 * R::TILE);
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jn][e] *= ksc[8 * jn + 2 * t4 + (e & 1)];
  }
  online_softmax<NJ, D / 8>(s, m, l, acc, it, t0, scale_log2);
#pragma unroll
  for (int kk = 0; kk < NJ; ++kk) {
    // k slot t4 <- key 2 t4, slot t4 + 4 <- key 2 t4 + 1
    float p[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
    const int k0 = 8 * kk + 2 * t4;
    if constexpr (R::kInt8) {
      const float* vsc =
          reinterpret_cast<const float*>(st + 2 * R::TILE + R::SCALES);
      p[0] *= vsc[k0];
      p[1] *= vsc[k0];
      p[2] *= vsc[k0 + 1];
      p[3] *= vsc[k0 + 1];
    }
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wg::split_tf32(p[i], ph[i], pl[i]);
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      uint32_t bh[2], bl[2];
      tf32_parts<SK>(pool_f<TP, D>(vt, k0, 8 * nn + g), bh[0], bl[0]);
      tf32_parts<SK>(pool_f<TP, D>(vt, k0 + 1, 8 * nn + g), bh[1], bl[1]);
      mma8(acc[nn], pl, bh[0], bh[1]);
      if constexpr (SK) mma8(acc[nn], ph, bl[0], bl[1]);
      mma8(acc[nn], ph, bh[0], bh[1]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y) {
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  else
    *reinterpret_cast<uint32_t*>(p) = wg::pack2<T>(x, y);
}

// The warp's live rows: normalised into out (one split), or the split's
// unnormalised sums and (max, sum) into scratch.
template <typename T, typename TP, int D>
__device__ __forceinline__ void store_rows(const Args<T, TP>& a,
                                           const Item& it,
                                           const float (&acc)[D / 8][4],
                                           const float (&m)[2], float (&l)[2]) {
  const int G = a.geo.G, H = a.H, P = a.geo.P;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int rr = it.row0 + 16 * it.warp + it.g + 8 * r;
    if (rr >= it.rows) continue;
    const int hq = it.kvh * G + rr % G;
    if (it.nsplit == 1) {
      const float inv = 1.f / l[r];
      T* o = a.out + (((size_t)it.s * P + rr / G) * H + hq) * D + 2 * it.t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2<T>(o + 8 * n, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    } else {
      const size_t at =
          ((size_t)it.t_of(rr, G) * H + hq) * a.geo.split_max + it.j;
      float* o = a.part + at * D + 2 * it.t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(o + 8 * n) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      if (it.t4 == 0) a.ml[at] = make_float2(m[r], l[r]);
    }
  }
}

// The item's rows from its splits' sums, by the block that finished the
// row block's last split: a lane a row (lane / 2) and half its columns,
// every row of a warp at once.  M = max m_j, w_j = 2^(m_j - M), out = sum
// w_j acc_j / sum w_j l_j over the splits in order, whichever block runs
// it: the same bits on every launch.
template <typename T, typename TP, int D>
__device__ __forceinline__ void merge_rows(const Args<T, TP>& a,
                                           const Item& it) {
  constexpr int C = D / 2;                     // columns a lane
  const int G = a.geo.G, lane = threadIdx.x & 31;
  const int rr = it.row0 + 16 * it.warp + (lane >> 1);
  if (rr >= it.rows) return;
  const int hq = it.kvh * G + rr % G, n = it.nsplit;
  const size_t at = ((size_t)it.t_of(rr, G) * a.H + hq) * a.geo.split_max;
  float2 ml[kMaxSplits];
  float mmax = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxSplits; ++j) {
    ml[j] = j < n ? __ldcg(a.ml + at + j) : make_float2(-INFINITY, 0.f);
    mmax = fmaxf(mmax, ml[j].x);
  }
  float w[kMaxSplits], sum = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxSplits; ++j) {
    w[j] = ml[j].x == -INFINITY ? 0.f : wg::ex2(ml[j].x - mmax);
    sum += w[j] * ml[j].y;
  }
  float o[C];
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxSplits; ++j) {
    if (j >= n) break;
    const float4* p = reinterpret_cast<const float4*>(
        a.part + (at + j) * D + (lane & 1) * C);
#pragma unroll
    for (int c = 0; c < C / 4; ++c) {
      const float4 v = __ldcg(p + c);
      o[4 * c] += w[j] * v.x;
      o[4 * c + 1] += w[j] * v.y;
      o[4 * c + 2] += w[j] * v.z;
      o[4 * c + 3] += w[j] * v.w;
    }
  }
  const float inv = 1.f / sum;
  T* dst = a.out + (((size_t)it.s * a.geo.P + rr / G) * a.H + hq) * D +
           (lane & 1) * C;
#pragma unroll
  for (int c = 0; c < C; c += 2) store2<T>(dst + c, o[c] * inv, o[c + 1] * inv);
}

// After a split of a row block with several: the block that finishes the
// row block's last split (its count at the split-0 item idx0) merges it.
// Each block fences its sums before counting; the last fences before
// reading (every block's sums are visible to it).
template <typename T, typename TP, int D>
__device__ __forceinline__ void merge_if_last(const Args<T, TP>& a,
                                              const Item& it, int idx0) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.merged + idx0, 1) == it.nsplit - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    merge_rows<T, TP, D>(a, it);
  }
}

// Zeros over out rows [q_len, P) of every descriptor (the rows without a
// query; all P of an unused descriptor), in units of kZeroUnit 16-byte
// chunks of a descriptor's block that blocks claim from a counter (the
// plan zeroed it): a block that spent long on its items claims fewer.
template <typename T>
__device__ __forceinline__ void zero_rows(T* out, const int* q_len,
                                          int* next, int S, int P, int H,
                                          int D) {
  __shared__ int claimed;
  const long long row16 = (long long)H * D * (int)sizeof(T) / 16;
  const long long desc16 = P * row16;
  const int per = (int)((desc16 + kZeroUnit - 1) / kZeroUnit);
  uint4* o = reinterpret_cast<uint4*>(out);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (;;) {
    if (threadIdx.x == 0) claimed = atomicAdd(next, 1);
    __syncthreads();
    const int u = claimed;
    __syncthreads();                 // read before the next claim
    if (u >= S * per) return;
    const int s = u / per, k = u % per;
    const long long lo = max((long long)k * kZeroUnit,
                             q_len_of(q_len, s, P) * row16);
    const long long hi = min((long long)(k + 1) * kZeroUnit, desc16);
    uint4* base = o + s * desc16;
#pragma unroll 4
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
      __stcs(base + i, zero);        // streamed: keep pages and sums in L2
  }
}

// The items of block b (b, b + grid, ...), then units of the zeros.
template <typename T, typename TP, int D, bool MMA>
__device__ __forceinline__ void attend(const Args<T, TP>& a,
                                       unsigned char* smem) {
  using R = Ring<TP, D>;
  const uint32_t ring = wg::smem_addr(smem);
  float* sq = reinterpret_cast<float*>(smem + R::kBytes);   // 3xtf32 only
  const int G = a.geo.G, H = a.H;
  const int n_items = a.counters[0];
  for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x) {
    const Item it(a, a.items[idx]);
    auto q_row = [&](int rr) -> const T* {    // row rr's q, or null
      return rr < it.rows ? a.q + ((size_t)it.t_of(rr, G) * H +
                                   it.kvh * G + rr % G) * D
                          : nullptr;
    };
    uint32_t qf[MMA ? D / 16 : 1][4];
    if constexpr (MMA) {
      // A fragments: rows g, g + 8 of the warp, columns 2 t4 (+ 8)
      const int rr = it.row0 + 16 * it.warp + it.g;
      const T* qa = it.live ? q_row(rr) : nullptr;
      const T* qb = it.live ? q_row(rr + 8) : nullptr;
      auto ld = [](const T* p, int c) -> uint32_t {
        return p ? *reinterpret_cast<const uint32_t*>(p + c) : 0u;
      };
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int c = 16 * ks + 2 * it.t4;
        qf[ks][0] = ld(qa, c);
        qf[ks][1] = ld(qb, c);
        qf[ks][2] = ld(qa, c + 8);
        qf[ks][3] = ld(qb, c + 8);
      }
    } else {
      // 16-byte loads, every one of a thread's issued before any store
      constexpr int E = 16 / (int)sizeof(T), CH = D / E;
      constexpr int N = kRows * CH / kThreads;
      uint4 v[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int i = threadIdx.x + k * kThreads;
        const T* qr = q_row(it.row0 + i / CH);
        v[k] = qr ? *reinterpret_cast<const uint4*>(qr + (i % CH) * E)
                  : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int i = threadIdx.x + k * kThreads;
        const T* e = reinterpret_cast<const T*>(&v[k]);
        float* d = sq + (i / CH) * QRows<D>::PITCH + (i % CH) * E;
#pragma unroll
        for (int c = 0; c < E; ++c) d[c] = to_f(e[c]);
      }
    }
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    const int nt = (it.k_end - it.k_begin + R::KT - 1) / R::KT;
    load_stage<T, TP, D>(a, it, ring, it.k_begin);
    wg::cp_commit();
    for (int i = 0; i < nt; ++i) {
      if (i + 1 < nt)
        load_stage<T, TP, D>(a, it, ring + ((i + 1) & 1) * R::STAGE,
                             it.k_begin + (i + 1) * R::KT);
      wg::cp_commit();
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();                 // tile i is in for every thread
      const int t0 = it.k_begin + i * R::KT;
      if (it.live && t0 < it.w_end) {
        if constexpr (MMA)
          tile_mma<T, D>(ring + (i & 1) * R::STAGE, qf, acc, m, l, it, t0,
                         a.scale_log2);
        else
          tile_tf32<TP, D, std::is_same<T, float>::value>(
              smem + (i & 1) * R::STAGE, sq, acc, m, l, it, t0,
              a.scale_log2);
      }
      __syncthreads();                 // stage i & 1 is free again
    }
    if (it.live) store_rows<T, TP, D>(a, it, acc, m, l);
    if (it.nsplit > 1) merge_if_last<T, TP, D>(a, it, idx - it.j * a.KVH);
  }
  zero_rows(a.out, a.q_len, a.counters + 1, a.S, a.geo.P, H, D);
}

// Two blocks an SM (shared memory allows two on the 3xtf32 route, and
// registers two on the mma route): the minimum keeps ptxas from capping
// registers at three blocks' worth and spilling.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
ragged_attend_mma(__grid_constant__ const Args<T, T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  attend<T, T, D, true>(a, smem);
}

template <typename T, typename TP, int D>
__global__ void __launch_bounds__(kThreads, 2)
ragged_attend_3xtf32(__grid_constant__ const Args<T, TP> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  attend<T, TP, D, false>(a, smem);
}

// The persistent grid of an attention kernel: every block resident.
template <typename K>
cudaError_t resident_grid(K kernel, size_t smem, int* grid) {
  if (*grid > 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return e;
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

struct Scratch {
  int2* items;
  int* merged;
  int* counters;
  float* part;
  float2* ml;
};

template <typename T, typename TP, int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_pages, void* v_pages, float* k_scales,
                   float* v_scales, const int* q_start, const int* q_len,
                   const int* kv_len, const int* tables, void* out,
                   Scratch sc, int S, int H, int KVH, int n_pages, Geo geo,
                   float scale, cudaStream_t stream) {
  constexpr bool INT8 = std::is_same<TP, int8_t>::value;
  constexpr bool MMA = std::is_same<T, TP>::value && sizeof(T) == 2;
  geo.split_chunks = !MMA;
  geo.target = MMA ? kMmaSpan : kTf32Span;
  ragged_append<T, TP, D><<<KVH * S + 1, kAppendThreads, 0, stream>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<TP*>(k_pages), static_cast<TP*>(v_pages), k_scales,
      v_scales, q_start, q_len, kv_len, tables, sc.items, sc.merged,
      sc.counters, S, KVH, n_pages, geo);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const Args<T, TP> a{static_cast<const T*>(q), static_cast<const TP*>(k_pages),
                      static_cast<const TP*>(v_pages),
                      INT8 ? k_scales : nullptr, INT8 ? v_scales : nullptr,
                      q_start, q_len, kv_len, tables, sc.items, sc.merged,
                      sc.counters,
                      static_cast<T*>(out), sc.part, sc.ml, S, H, KVH,
                      n_pages, geo, scale * wg::kLog2e};
  static bool smem_set = false;
  static int grid = 0;
  if constexpr (MMA) {
    constexpr size_t smem = Ring<T, D>::kBytes;
    e = allow_smem(ragged_attend_mma<T, D>, smem, &smem_set);
    if (e == cudaSuccess) e = resident_grid(ragged_attend_mma<T, D>, smem, &grid);
    if (e != cudaSuccess) return e;
    ragged_attend_mma<T, D><<<grid, kThreads, smem, stream>>>(a);
  } else {
    constexpr size_t smem = Ring<TP, D>::kBytes + QRows<D>::kBytes;
    e = allow_smem(ragged_attend_3xtf32<T, TP, D>, smem, &smem_set);
    if (e == cudaSuccess)
      e = resident_grid(ragged_attend_3xtf32<T, TP, D>, smem, &grid);
    if (e != cudaSuccess) return e;
    ragged_attend_3xtf32<T, TP, D><<<grid, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, typename TP>
cudaError_t dispatch_d(int D, const void* q, const void* k_new,
                       const void* v_new, void* k_pages, void* v_pages,
                       float* k_scales, float* v_scales, const int* q_start,
                       const int* q_len, const int* kv_len, const int* tables,
                       void* out, Scratch sc, int S, int H, int KVH,
                       int n_pages, Geo geo, float scale,
                       cudaStream_t stream) {
#define PTT_RAGGED_D(DD)                                                    \
  return launch<T, TP, DD>(q, k_new, v_new, k_pages, v_pages, k_scales,     \
                           v_scales, q_start, q_len, kv_len, tables, out,   \
                           sc, S, H, KVH, n_pages, geo, scale, stream)
  if (D == 64) PTT_RAGGED_D(64);
  if (D == 128) PTT_RAGGED_D(128);
#undef PTT_RAGGED_D
  return cudaErrorInvalidValue;
}

// The pools' type for q's type T: any of the three float types (the
// mixed-dtype mode when it is not T) or int8 (code 3).
template <typename T>
cudaError_t dispatch_pool(int pool, int D, const void* q, const void* k_new,
                          const void* v_new, void* k_pages, void* v_pages,
                          float* k_scales, float* v_scales,
                          const int* q_start, const int* q_len,
                          const int* kv_len, const int* tables, void* out,
                          Scratch sc, int S, int H, int KVH, int n_pages,
                          Geo geo, float scale, cudaStream_t st) {
#define PTT_RAGGED_POOL(TP)                                                  \
  return dispatch_d<T, TP>(D, q, k_new, v_new, k_pages, v_pages, k_scales,  \
                           v_scales, q_start, q_len, kv_len, tables, out, sc, \
                           S, H, KVH, n_pages, geo, scale, st)
  switch (pool) {
    case 0:
      PTT_RAGGED_POOL(float);
    case 1:
      PTT_RAGGED_POOL(__nv_bfloat16);
    case 2:
      PTT_RAGGED_POOL(__half);
    case 3:
      PTT_RAGGED_POOL(int8_t);
  }
#undef PTT_RAGGED_POOL
  return cudaErrorInvalidValue;
}

}  // namespace rg
}  // namespace ptt

extern "C" {

// dtype (q, new rows, out): 0 float32, 1 bfloat16, 2 float16.  pool: the
// pools' type, the same codes or 3 for int8 pools with f32 scale pools.
// Scratch (the wrapper's torch.empty): items int2 [items_cap], merged
// int [items_cap] and counters int [2] (the plan), part f32 [T, H,
// split_max, D] and ml
// float2 [T, H, split_max] (the splits' sums); split_max <= 8; items_cap
// >= KVH * S * ceil(G * P / 64) * split_max.  Returns a cudaError_t.
int ragged_paged_append_attend(const void* q, const void* k_new,
                               const void* v_new, void* k_pages,
                               void* v_pages, float* k_scales,
                               float* v_scales, const int* q_start,
                               const int* q_len, const int* kv_len,
                               const int* tables, void* out, void* items,
                               void* merged, void* counters, void* part,
                               void* ml, int S,
                               int H, int KVH, int n_pages, int P, int D,
                               int maxp, int split_max, float scale,
                               int dtype, int pool, void* stream) {
  using namespace ptt::rg;
  if (S <= 0) return cudaSuccess;
  if (KVH <= 0 || KVH > 255 || H % KVH || split_max <= 0 ||
      split_max > kMaxSplits || (H / KVH) * P > 64 * 4095)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch sc{static_cast<int2*>(items), static_cast<int*>(merged),
                   static_cast<int*>(counters),
                   static_cast<float*>(part), static_cast<float2*>(ml)};
  const Geo geo{H / KVH, P, maxp, split_max, false, 0};
  switch (dtype) {
    case 0:
      return dispatch_pool<float>(pool, D, q, k_new, v_new, k_pages, v_pages,
                                  k_scales, v_scales, q_start, q_len, kv_len,
                                  tables, out, sc, S, H, KVH, n_pages, geo,
                                  scale, st);
    case 1:
      return dispatch_pool<__nv_bfloat16>(
          pool, D, q, k_new, v_new, k_pages, v_pages, k_scales, v_scales,
          q_start, q_len, kv_len, tables, out, sc, S, H, KVH, n_pages, geo,
          scale, st);
    case 2:
      return dispatch_pool<__half>(pool, D, q, k_new, v_new, k_pages,
                                   v_pages, k_scales, v_scales, q_start,
                                   q_len, kv_len, tables, out, sc, S, H, KVH,
                                   n_pages, geo, scale, st);
  }
  return cudaErrorInvalidValue;
}

const char* ragged_paged_attention_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
