// Grouped (per-expert) matmuls of the MoE layer over the plan's sorted,
// tile-aligned row buffer: every tm-row tile belongs to one expert,
// named by tile_expert.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/grouped_matmul.py:
//   gmm      out[i] = lhs[i] @ w[e(i)], or @ w[e(i)]^T (transpose_w)
//            (_gmm_call);
//   gmm_glu  hs = silu(lhs @ wg[e]) * (lhs @ wu[e]), and with save_pre
//            the two products hg, hu (_gmm_glu_call);
//   gmm_dw   dw[e] = sum over the rows of expert e of lhs^T @ dout, zero
//            for an expert with no rows (_gmm_dw_call).
// The TPU kernels walk the row tiles in order and carry a sum across grid
// steps.  Here blocks run in any order: gmm and gmm_glu give a block one
// 128-row block of one tile and one column block, gmm_dw gives a block
// one (expert, k tile, n tile) of the output, which loops over that
// expert's rows and writes its tile once (no atomics: the same bits on
// every launch).
//
// The row layout on the device.  Expert e's tiles start at tile
// sum_{e' < e} ceil(counts[e'] / tm); a row of a tile past its expert's
// count is padding, and a tile past the last expert's is dead (the plan
// maps it to expert E - 1).  When counts is given, a block computes its
// padding rows as zeros whatever they hold, and a block with no routed
// row writes zeros and reads no weight: at a decode step, where 32 routed
// rows sit in 128-row tiles, the products cover the routed rows' 8-row
// (f32 rows) or 128-row (bf16) blocks, not every tile.  Each block finds
// its expert's first tile by summing counts (E loads, from L1).  Without
// counts every row is computed.  gmm_dw never reads a row past its
// expert's count.
//
// What bounds them on an H100: operations at the training shapes (4 x
// 4096 tokens x top-4 = 65,536 routed rows of m_pad 80,896 at tm 256,
// 60 experts: 65,536 x 1408 x 2048 x 2 = 0.378 TFLOP a projection, 0.382
// ms at 989 TFLOP/s, against about 0.9 ms of bytes at 3.35 TB/s); bytes
// at a decode step (each routed expert's 5.8 MB weight read once a
// projection).
//
// bf16 gmm and gmm_dw run on wgmma (`gmm_wgmma`, `dw_wgmma`), with the
// design of #10 (matmul_rope.cu).  A block owns a 128 x 256 output tile:
// two consumer warpgroups, each one m64n256 f32 accumulator (128
// registers a thread), and one producer warp that fills a 4-stage ring
// of 64-deep slices over TMA (tma_ring.cuh), a full and an empty
// mbarrier a stage: 192 KB of ring, one block an SM.  The tile was
// measured against a 128 x 128 one at two blocks an SM (one block's
// fill and epilogue hidden behind the other's products), which moves a
// third more operand bytes from L2 a FLOP and came out 7-19 % slower;
// and against persistent grids (PERF.md).  At N = 1408 the last column
// tile is half empty (1536 columns computed for 1408).
//   - gmm: lhs through a 2-D map [M, K] in [128][64] K-major boxes; w
//     through a 3-D map with the expert outermost, so a ragged K (or N)
//     edge zero-fills inside w[e] and never reads w[e + 1].  w [E, K, N]
//     lands as four [64 k][64 n] boxes, MN-major, read through wgmma's
//     transpose bit; w [E, N, K] (transpose_w, the dX products) as one
//     [256 n][64 k] box, K-major.  No transposed copy is made.  Blocks
//     walk the column tiles fastest, so a lhs tile serves every column
//     tile from L2 and w[e] (5.8 MB) stays in the 50 MB L2 across its
//     expert's row tiles.  A block with no routed row writes zeros and
//     starts no ring; the epilogue writes the rows past the count as
//     zeros (output row r depends on lhs row r alone, so this is the
//     product of zero rows).
//   - gmm_dw: D[k, n] += lhs[r, k] dout[r, n] over 64-row slices of the
//     expert's rows, both operands MN-major: two lhs [64 r][64 k] boxes,
//     one a warpgroup as its A, and four dout [64 r][64 n] boxes as B,
//     read through both transpose bits.  The last slice of an expert
//     overruns its count into padding rows, which TMA cannot mask by
//     row: once it lands, the consumers zero those rows of both operands
//     in shared memory, fence them to the async proxy and meet at a
//     barrier before wgmma reads them.  An expert with no rows gets a
//     zero tile and starts no ring.  The gate dW of the training shape is
//     60 x 16 x 6 blocks of about 17 slices each.
//   The epilogue rounds the accumulators to bf16 into the idle ring and
//   writes 16-byte stores.
// bf16 gmm_glu (`glu_wgmma`) takes the same ring: a block owns 128 rows x
// 128 columns of both products, two consumer warpgroups each with one
// m64n128 accumulator for the gate and one for up (128 registers a
// thread, as one m64n256), one producer warp; a stage holds the lhs
// [128][64] box and two [64 k][64 n] boxes each of wg[e] and wu[e]
// (MN-major, read through the transpose bit, 48 KB as gmm's).  N = 1408
// is exactly 11 column tiles.  Blocks walk the column tiles fastest; a
// block with no routed row writes zeros and starts no ring, and the
// epilogue computes silu(g) * u in f32 in registers (with save_pre also
// rounding g and u), stages up to three [128][128] bf16 tiles in the
// idle ring and writes them with 16-byte stores, padding rows as zeros.
// f32 rows (the serving path's f32 buffers against bf16 or f32 weights,
// and the f32 training checks) run on the FMA pipe in exact f32; the
// product is the plain version's, summed in another order.  gmm against
// w [E, K, N] (the serving path, three launches a layer a forward) is
// bound by the bytes of the experts it touches: at a mixed step of 544
// routed rows over 60 experts, about 9 rows a tile read a 5.8 MB expert
// weight each (0.35 GB a projection), and most of the 8,320 padded rows
// are padding or dead tiles.  So `gmm_rows_stream` gives a block one
// row tile and 64 columns (65 x 22 blocks at the mixed step's gate): a
// tile without routed rows writes its zeros with 16-byte stores and
// reads nothing; a live one streams w[e]'s [K, 64] slice once a group of
// up to 16 rows through a 6-stage cp.async ring of 64-deep slices (40
// KB of bf16 weights in flight a block, three blocks an SM), the rows'
// slice beside it, and each thread sums its 8 k of a slice into 16 x 4
// f32 accumulators (the groups' sums meet in shared memory at the end).
// More than 16 rows re-read the slice, from L2.  transpose_w, gmm_glu
// and gmm_dw (the f32 training checks) take 32 x 64 output tiles of
// 4 x 4 a thread.
#include "attention_wgmma.cuh"
#include "tma_ring.cuh"

namespace ptt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float silu_f(float g) {
  return g / (1.f + expf(-g));
}

// The expert layout of the plan.  live_rows: how many of the rows
// [r0, r0 + rows) of one tile (r0 inside tile r0 / tm) are routed rows;
// they are always the block's first rows.
struct Layout {
  const int* te;
  const int* counts;     // nullptr: every row is live
  int E, tm;

  __device__ __forceinline__ int first_tile(int e) const {
    int t = 0;
    for (int i = 0; i < e; ++i) t += (__ldg(counts + i) + tm - 1) / tm;
    return t;
  }

  __device__ __forceinline__ int live_rows(int r0, int rows) const {
    if (counts == nullptr) return rows;
    const int tile = r0 / tm;
    const int e = __ldg(te + tile);
    const int live = __ldg(counts + e) - (tile - first_tile(e)) * tm
                     - (r0 - tile * tm);
    return live < 0 ? 0 : (live < rows ? live : rows);
  }
};

// Zeros over rows [0, rows) x columns [0, cols) of a row-major tile.
template <typename T>
__device__ __forceinline__ void store_zeros(T* out, long long ld, int rows,
                                            int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
    out[(i / cols) * ld + i % cols] = T(0.f);
}

// ------------------------------------------------------ bf16 on wgmma

constexpr int kTileM = 128;                     // output tile rows: 2 x 64
constexpr int kTileN = 256;                     // output tile columns
constexpr int kDepth = 64;                      // rows of a ring slice
constexpr int kRing = 4;                        // stages
constexpr int kConsumers = 256;                 // two warpgroups
constexpr int kWThreads = kConsumers + 32;      // and the producer warp
constexpr int kBox = 64 * 64 * 2;               // a [64][64] box, 8 KB
constexpr int kWStage = 6 * kBox;               // A 16 KB, B 32 KB
constexpr int kEpiPitch = (kTileN + 8) * 2;     // bytes a row of the tile
constexpr size_t kWSmem = (size_t)kRing * kWStage + 2 * kRing * 8 + 1024;
static_assert(kTileM * kEpiPitch <= kRing * kWStage,
              "the epilogue tile must fit in the ring");

// Barrier over the two consumer warpgroups (id 0 is __syncthreads, 2 and
// 3 each warpgroup's own).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// 16-byte zero stores over rows [0, rows) x columns [0, cols) (cols %
// 8 == 0) of a row-major bf16 tile, by every thread of the block.
__device__ __forceinline__ void zero_tile(bf16* o, long long ld, int rows,
                                          int cols) {
  const int ch = cols / 8;
  for (int i = threadIdx.x; i < rows * ch; i += blockDim.x)
    *reinterpret_cast<uint4*>(o + (i / ch) * ld + (i % ch) * 8) =
        make_uint4(0, 0, 0, 0);
}

// [64][64] boxes that cover the columns [c0, c0 + 256) below n, at most 4
__device__ __forceinline__ int boxes_below(int c0, int n) {
  return min(4, (n - c0 + 63) / 64);
}

// The 1024-byte aligned ring (the 128-byte swizzle repeats every 1024)
// and its barriers after it: full[s] at full0 + 8 s, empty[s] at empty0 +
// 8 s.
__device__ __forceinline__ unsigned char* ring_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}
__device__ __forceinline__ void ring_init(uint32_t full0, uint32_t empty0) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full0 + 8 * s, 1);                  // the producer's arrival
      mbar_init(empty0 + 8 * s, kConsumers / 32);   // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The two warpgroups' m64n256 accumulators (warpgroup w: tile rows
// 64 w ..) rounded to bf16 through the idle ring and written to o (row
// pitch ld) with 16-byte stores: rows [live, rows) as zeros, rows past
// rows and columns past cols not at all.  Every consumer thread calls it.
__device__ __forceinline__ void store_tile(const float (&acc)[kTileN / 2],
                                           unsigned char* tile, bf16* o,
                                           long long ld, int rows, int live,
                                           int cols) {
  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int lr = 64 * w + 16 * warp + g;
  consumers_sync();          // both warpgroups' products have read the ring
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    *reinterpret_cast<uint32_t*>(tile + lr * kEpiPitch + 2 * c) =
        wg::pack2<bf16>(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tile + (lr + 8) * kEpiPitch + 2 * c) =
        wg::pack2<bf16>(acc[4 * j + 2], acc[4 * j + 3]);
  }
  wg::wg_barrier(2 + w);     // this warpgroup's 64 rows are in the tile
  constexpr int CH = kTileN / 8;
  for (int i = wt; i < 64 * CH; i += 128) {
    const int r = 64 * w + i / CH, c = (i % CH) * 8;
    if (r >= rows || c >= cols) continue;
    const uint4 v = r < live ? *reinterpret_cast<const uint4*>(
                                   tile + r * kEpiPitch + 2 * c)
                             : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(o + static_cast<long long>(r) * ld + c) = v;
  }
}

// out rows [r0, r0 + 128) x columns [n0, n0 + 256) = lhs rows @ w[e]
// (BT: @ w[e]^T).  tma: lhs [M, K], boxes [128][64]; tmw: w as
// [E][K][N] in [64][64] boxes, or (BT) [E][N][K] in [256][64] boxes.
template <bool BT>
__global__ void __launch_bounds__(kWThreads, 1)
gmm_wgmma(__grid_constant__ const CUtensorMap tma,
          __grid_constant__ const CUtensorMap tmw, Layout L,
          bf16* __restrict__ out, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = (N + kTileN - 1) / kTileN;
  const int n0 = (blockIdx.x % n_tiles) * kTileN;   // column tiles fastest
  const int r0 = (blockIdx.x / n_tiles) * kTileM;
  const int cols = min(kTileN, N - n0);
  const int live = L.live_rows(r0, kTileM);
  bf16* o = out + static_cast<long long>(r0) * N + n0;
  if (live == 0) {
    zero_tile(o, N, kTileM, cols);
    return;
  }
  const int e = __ldg(L.te + r0 / L.tm);
  unsigned char* smem = ring_base(smem_raw);
  const uint32_t ring = wg::smem_addr(smem);
  const uint32_t full0 = ring + kRing * kWStage, empty0 = full0 + 8 * kRing;
  const int KT = (K + kDepth - 1) / kDepth;
  ring_init(full0, empty0);

  const int tid = threadIdx.x;
  if (tid >= kConsumers) {           // the producer warp: one thread
    if (tid == kConsumers) {
      // w [E, K, N]: only the [64 k][64 n] boxes that hold a column
      // below N (the columns past N are never stored)
      const int nb = BT ? 4 : boxes_below(n0, N);
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kRing;
        if (kt >= kRing) mbar_wait(empty0 + 8 * s, (kt / kRing - 1) & 1);
        const uint32_t st = ring + s * kWStage, bar = full0 + 8 * s;
        mbar_expect_tx(bar, (2 + nb) * kBox);
        tma_load(st, &tma, kt * kDepth, r0, bar);
        if (BT) {
          tma_load(st + 2 * kBox, &tmw, kt * kDepth, n0, e, bar);
        } else {
          for (int j = 0; j < nb; ++j)
            tma_load(st + (2 + j) * kBox, &tmw, n0 + 64 * j, kt * kDepth, e,
                     bar);
        }
      }
    }
    return;
  }

  const int w = tid >> 7, lane = tid & 31;
  float acc[kTileN / 2];
#pragma unroll
  for (int i = 0; i < kTileN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kRing;
    mbar_wait(full0 + 8 * s, (kt / kRing) & 1);
    const uint32_t st = ring + s * kWStage;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      const uint64_t a = wg::desc_k<kTileM>(st + w * 64 * 128, kk);
      if (BT)
        wg::Wgmma<bf16, kTileN>::ss(
            acc, a, wg::desc_k<kTileN>(st + 2 * kBox, kk), 1);
      else
        wg::Wgmma<bf16, kTileN>::ss_mn(
            acc, a, wg::desc_mn<kDepth>(st + 2 * kBox, kk), 1);
    }
    wg::commit();
    wg::wait<1>();                   // the group of slice kt - 1 retired
    if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % kRing));
  }
  wg::wait<0>();
  wg::keep(acc);
  store_tile(acc, smem, o, N, kTileM, live, cols);
}

// dw[e] rows [k0, k0 + 128) x columns [n0, n0 + 256) = sum over expert
// e's rows of lhs^T @ dout.  tma: lhs [M, K], tmd: dout [M, N], both in
// [64 rows][64] boxes.
__global__ void __launch_bounds__(kWThreads, 1)
dw_wgmma(__grid_constant__ const CUtensorMap tma,
         __grid_constant__ const CUtensorMap tmd, Layout L,
         bf16* __restrict__ dw, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = (N + kTileN - 1) / kTileN;
  const int k_tiles = (K + kTileM - 1) / kTileM;
  const int n0 = (blockIdx.x % n_tiles) * kTileN;   // column tiles fastest
  const int k0 = (blockIdx.x / n_tiles % k_tiles) * kTileM;
  const int e = blockIdx.x / (n_tiles * k_tiles);
  const int rows = min(kTileM, K - k0), cols = min(kTileN, N - n0);
  bf16* o = dw + (static_cast<long long>(e) * K + k0) * N + n0;
  const int count = __ldg(L.counts + e);
  if (count == 0) {
    zero_tile(o, N, rows, cols);
    return;
  }
  const int row_begin = L.first_tile(e) * L.tm;
  const int S = (count + kDepth - 1) / kDepth;
  const int tail = count - (S - 1) * kDepth;        // rows of the last slice
  unsigned char* smem = ring_base(smem_raw);
  const uint32_t ring = wg::smem_addr(smem);
  const uint32_t full0 = ring + kRing * kWStage, empty0 = full0 + 8 * kRing;
  ring_init(full0, empty0);

  const int tid = threadIdx.x;
  if (tid >= kConsumers) {           // the producer warp: one thread
    if (tid == kConsumers) {
      // only the boxes that hold a k (n) below K (N): the rest is never
      // stored
      const int na = k0 + 64 < K ? 2 : 1, nb = boxes_below(n0, N);
      for (int sl = 0; sl < S; ++sl) {
        const int s = sl % kRing, r = row_begin + sl * kDepth;
        if (sl >= kRing) mbar_wait(empty0 + 8 * s, (sl / kRing - 1) & 1);
        const uint32_t st = ring + s * kWStage, bar = full0 + 8 * s;
        mbar_expect_tx(bar, (na + nb) * kBox);
        for (int j = 0; j < na; ++j)
          tma_load(st + j * kBox, &tma, k0 + 64 * j, r, bar);
        for (int j = 0; j < nb; ++j)
          tma_load(st + (2 + j) * kBox, &tmd, n0 + 64 * j, r, bar);
      }
    }
    return;
  }

  const int w = tid >> 7, wt = tid & 127, lane = tid & 31;
  float acc[kTileN / 2];
#pragma unroll
  for (int i = 0; i < kTileN / 2; ++i) acc[i] = 0.f;
  for (int sl = 0; sl < S; ++sl) {
    const int s = sl % kRing;
    mbar_wait(full0 + 8 * s, (sl / kRing) & 1);
    const uint32_t st = ring + s * kWStage;
    if (sl == S - 1 && tail < kDepth) {
      // rows [tail, 64) of the slice are past the count: zero them in
      // this warpgroup's lhs box and in dout boxes 2w, 2w + 1 (whole
      // 128-byte rows, whatever the swizzle), then hand them to wgmma's
      // proxy
      unsigned char* a = smem + s * kWStage + w * kBox;
      unsigned char* b = smem + s * kWStage + (2 + 2 * w) * kBox;
      for (int i = tail * 8 + wt; i < kDepth * 8; i += 128) {
        const uint4 z = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(a + i * 16) = z;
        *reinterpret_cast<uint4*>(b + i * 16) = z;
        *reinterpret_cast<uint4*>(b + kBox + i * 16) = z;
      }
      wg::fence_async_smem();
      consumers_sync();              // every dout box is clean
    }
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk)
      wg::Wgmma<bf16, kTileN>::ss_tt(
          acc, wg::desc_mn<kDepth>(st + w * kBox, kk),
          wg::desc_mn<kDepth>(st + 2 * kBox, kk), 1);
    wg::commit();
    wg::wait<1>();                   // the group of slice sl - 1 retired
    if (sl > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((sl - 1) % kRing));
  }
  wg::wait<0>();
  wg::keep(acc);
  store_tile(acc, smem, o, N, rows, rows, cols);
}

template <bool BT>
cudaError_t launch_gmm_wgmma(const void* lhs, const void* w, Layout L,
                             void* out, int M, int K, int N, int E,
                             cudaStream_t stream) {
  CUtensorMap tma, tmw;
  cudaError_t e = make_map(&tma, lhs, M, K, kTileM);
  if (e == cudaSuccess)
    e = BT ? make_map(&tmw, w, N, K, kTileN, E)
           : make_map(&tmw, w, K, N, kDepth, E);
  if (e != cudaSuccess) return e;
  static bool smem_set = false;
  e = allow_smem(gmm_wgmma<BT>, kWSmem, &smem_set);
  if (e != cudaSuccess) return e;
  const long long grid = static_cast<long long>(M / kTileM) *
                         ((N + kTileN - 1) / kTileN);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  gmm_wgmma<BT><<<static_cast<unsigned>(grid), kWThreads, kWSmem, stream>>>(
      tma, tmw, L, static_cast<bf16*>(out), K, N);
  return cudaGetLastError();
}

cudaError_t launch_dw_wgmma(const void* lhs, const void* dout, Layout L,
                            void* dw, int M, int K, int N, int E,
                            cudaStream_t stream) {
  CUtensorMap tma, tmd;
  cudaError_t e = make_map(&tma, lhs, M, K, kDepth);
  if (e == cudaSuccess) e = make_map(&tmd, dout, M, N, kDepth);
  if (e != cudaSuccess) return e;
  static bool smem_set = false;
  e = allow_smem(dw_wgmma, kWSmem, &smem_set);
  if (e != cudaSuccess) return e;
  const long long grid = static_cast<long long>(E) *
                         ((K + kTileM - 1) / kTileM) *
                         ((N + kTileN - 1) / kTileN);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  dw_wgmma<<<static_cast<unsigned>(grid), kWThreads, kWSmem, stream>>>(
      tma, tmd, L, static_cast<bf16*>(dw), K, N);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16 gmm_glu on wgmma

constexpr int kGluN = 128;                      // columns of each product
constexpr int kGluPitch = (kGluN + 8) * 2;      // bytes a row of a tile
static_assert(3 * kTileM * kGluPitch <= kRing * kWStage,
              "the three epilogue tiles must fit in the ring");

// The two warpgroups' m64n128 gate and up accumulators through the idle
// ring: hs = silu(g) * u (and with hg: hg = g, hu = u) rounded to bf16
// into up to three [128][128] tiles, written to o + 0, 1, 2 (row pitch
// ld) with 16-byte stores: rows [live, 128) as zeros, columns past cols
// not at all.  Every consumer thread calls it.
__device__ __forceinline__ void store_glu(const float (&ag)[kGluN / 2],
                                          const float (&au)[kGluN / 2],
                                          unsigned char* tiles,
                                          bf16* const (&o)[3], int n_out,
                                          long long ld, int live, int cols) {
  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  constexpr int kTile = kTileM * kGluPitch;
  consumers_sync();          // both warpgroups' products have read the ring
#pragma unroll
  for (int j = 0; j < kGluN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (64 * w + 16 * warp + g + 8 * h) * kGluPitch +
                     2 * (8 * j + 2 * t4);
      const float g0 = ag[4 * j + 2 * h], g1 = ag[4 * j + 2 * h + 1];
      const float u0 = au[4 * j + 2 * h], u1 = au[4 * j + 2 * h + 1];
      *reinterpret_cast<uint32_t*>(tiles + at) =
          wg::pack2<bf16>(silu_f(g0) * u0, silu_f(g1) * u1);
      if (n_out == 3) {
        *reinterpret_cast<uint32_t*>(tiles + kTile + at) =
            wg::pack2<bf16>(g0, g1);
        *reinterpret_cast<uint32_t*>(tiles + 2 * kTile + at) =
            wg::pack2<bf16>(u0, u1);
      }
    }
  wg::wg_barrier(2 + w);     // this warpgroup's 64 rows are in the tiles
  constexpr int CH = kGluN / 8;
  for (int t = 0; t < n_out; ++t)
    for (int i = wt; i < 64 * CH; i += 128) {
      const int r = 64 * w + i / CH, c = (i % CH) * 8;
      if (c >= cols) continue;
      const uint4 v = r < live ? *reinterpret_cast<const uint4*>(
                                     tiles + t * kTile + r * kGluPitch + 2 * c)
                               : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(o[t] + static_cast<long long>(r) * ld + c) =
          v;
    }
}

// hs rows [r0, r0 + 128) x columns [n0, n0 + 128) = silu(lhs rows @
// wg[e]) * (lhs rows @ wu[e]), and with hg / hu the two products.  tma:
// lhs [M, K] in [128][64] boxes; tmg, tmu: wg and wu as [E][K][N] in
// [64][64] boxes.
__global__ void __launch_bounds__(kWThreads, 1)
glu_wgmma(__grid_constant__ const CUtensorMap tma,
          __grid_constant__ const CUtensorMap tmg,
          __grid_constant__ const CUtensorMap tmu, Layout L,
          bf16* __restrict__ hs, bf16* __restrict__ hg,
          bf16* __restrict__ hu, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = (N + kGluN - 1) / kGluN;
  const int n0 = (blockIdx.x % n_tiles) * kGluN;    // column tiles fastest
  const int r0 = (blockIdx.x / n_tiles) * kTileM;
  const int cols = min(kGluN, N - n0);
  const int live = L.live_rows(r0, kTileM);
  const long long off = static_cast<long long>(r0) * N + n0;
  const int n_out = hg != nullptr ? 3 : 1;
  bf16* const o[3] = {hs + off, n_out == 3 ? hg + off : nullptr,
                      n_out == 3 ? hu + off : nullptr};
  if (live == 0) {
    for (int t = 0; t < n_out; ++t) zero_tile(o[t], N, kTileM, cols);
    return;
  }
  const int e = __ldg(L.te + r0 / L.tm);
  unsigned char* smem = ring_base(smem_raw);
  const uint32_t ring = wg::smem_addr(smem);
  const uint32_t full0 = ring + kRing * kWStage, empty0 = full0 + 8 * kRing;
  const int KT = (K + kDepth - 1) / kDepth;
  ring_init(full0, empty0);

  const int tid = threadIdx.x;
  if (tid >= kConsumers) {           // the producer warp: one thread
    if (tid == kConsumers) {
      // a stage: lhs [128][64] at box 0-1, wg at boxes 2-3, wu at 4-5;
      // only the [64 k][64 n] boxes that hold a column below N
      const int nb = min(2, (N - n0 + 63) / 64);
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kRing;
        if (kt >= kRing) mbar_wait(empty0 + 8 * s, (kt / kRing - 1) & 1);
        const uint32_t st = ring + s * kWStage, bar = full0 + 8 * s;
        mbar_expect_tx(bar, (2 + 2 * nb) * kBox);
        tma_load(st, &tma, kt * kDepth, r0, bar);
        for (int j = 0; j < nb; ++j) {
          tma_load(st + (2 + j) * kBox, &tmg, n0 + 64 * j, kt * kDepth, e,
                   bar);
          tma_load(st + (4 + j) * kBox, &tmu, n0 + 64 * j, kt * kDepth, e,
                   bar);
        }
      }
    }
    return;
  }

  const int w = tid >> 7, lane = tid & 31;
  float ag[kGluN / 2], au[kGluN / 2];
#pragma unroll
  for (int i = 0; i < kGluN / 2; ++i) ag[i] = au[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kRing;
    mbar_wait(full0 + 8 * s, (kt / kRing) & 1);
    const uint32_t st = ring + s * kWStage;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      const uint64_t a = wg::desc_k<kTileM>(st + w * 64 * 128, kk);
      wg::Wgmma<bf16, kGluN>::ss_mn(
          ag, a, wg::desc_mn<kDepth>(st + 2 * kBox, kk), 1);
      wg::Wgmma<bf16, kGluN>::ss_mn(
          au, a, wg::desc_mn<kDepth>(st + 4 * kBox, kk), 1);
    }
    wg::commit();
    wg::wait<1>();                   // the group of slice kt - 1 retired
    if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % kRing));
  }
  wg::wait<0>();
  wg::keep(ag);
  wg::keep(au);
  store_glu(ag, au, smem, o, n_out, N, live, cols);
}

cudaError_t launch_glu_wgmma(const void* lhs, const void* wg,
                             const void* wu, Layout L, void* hs, void* hg,
                             void* hu, int M, int K, int N, int E,
                             cudaStream_t stream) {
  CUtensorMap tma, tmg, tmu;
  cudaError_t e = make_map(&tma, lhs, M, K, kTileM);
  if (e == cudaSuccess) e = make_map(&tmg, wg, K, N, kDepth, E);
  if (e == cudaSuccess) e = make_map(&tmu, wu, K, N, kDepth, E);
  if (e != cudaSuccess) return e;
  static bool smem_set = false;
  e = allow_smem(glu_wgmma, kWSmem, &smem_set);
  if (e != cudaSuccess) return e;
  const long long grid = static_cast<long long>(M / kTileM) *
                         ((N + kGluN - 1) / kGluN);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  glu_wgmma<<<static_cast<unsigned>(grid), kWThreads, kWSmem, stream>>>(
      tma, tmg, tmu, L, static_cast<bf16*>(hs), static_cast<bf16*>(hg),
      static_cast<bf16*>(hu), K, N);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ f32

constexpr int kFM = 32, kFN = 64, kFK = 16, kFThreads = 128;

// acc[j] += A x B_j on the FMA pipe: A element (r, k) a[r * lda + k]
// (AT: a[k * lda + r]), live for r < a_rows; B_j element (k, n)
// b[j][k * ldb + n] (BT: b[j][n * ldb + k]), live for n < n_lim, widened
// to f32; dead elements load as zeros.  Thread (ty, tx) owns
// rows ty * 4 + i and columns tx + 16 * c of the 32 x 64 tile.
template <typename TB, bool AT, bool BT, int NB>
__device__ __forceinline__ void fma_mainloop(
    const float* __restrict__ a, long long lda, int a_rows,
    const TB* const* b, long long ldb, int n_lim, int k_begin, int k_end,
    float (&acc)[NB][4][4]) {
  __shared__ float sa[kFK][kFM + 1];
  __shared__ float sb[NB][kFK][kFN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = k_begin; k0 < k_end; k0 += kFK) {
    for (int i = tid; i < kFK * kFM; i += kFThreads) {
      int r, k;
      if (!AT) { r = i / kFK; k = i % kFK; }
      else { k = i / kFM; r = i % kFM; }
      const bool ok = r < a_rows && k0 + k < k_end;
      sa[k][r] = !ok ? 0.f
                     : AT ? a[static_cast<long long>(k0 + k) * lda + r]
                          : a[r * lda + k0 + k];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
      for (int i = tid; i < kFK * kFN; i += kFThreads) {
        int n, k;
        if (!BT) { k = i / kFN; n = i % kFN; }
        else { n = i / kFK; k = i % kFK; }
        const bool ok = n < n_lim && k0 + k < k_end;
        sb[j][k][n] = !ok ? 0.f
                          : to_f(BT ? b[j][n * ldb + k0 + k]
                                    : b[j][static_cast<long long>(k0 + k)
                                           * ldb + n]);
      }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float bv = sb[j][k][tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i][c] = fmaf(av[i], bv,
                                                          acc[j][i][c]);
        }
    }
    __syncthreads();
  }
}

// f32 rows x w[e] [K, N], streamed: a block owns one row tile and kRN
// columns, and streams w[e]'s [K, kRN] slice once a group of kRG live
// rows through a ring of kRK-deep slices (cp.async, RingOf<TB>::kStages
// stages: 40 KB of bf16 weights in flight a block, three blocks an SM).
// Thread t owns the columns 4 (t % kRQ) .. + 3 and the kKP k from
// kKP (t / kRQ) of each slice; the kKG k groups' sums meet in shared
// memory at the end.
constexpr int kRN = 64, kRK = 64, kRG = 16, kRThreads = 128;
constexpr int kRQ = kRN / 4;                 // column quads
constexpr int kKG = kRThreads / kRQ;         // k groups
constexpr int kKP = kRK / kKG;               // k a group, a slice
static_assert(kKP % 4 == 0, "a k group reads its rows' k as float4s");

template <typename TB>
struct RingOf {
  static constexpr int kStages = sizeof(TB) == 2 ? 6 : 4;
  static constexpr int kA = kRG * kRK * 4;              // rows [16][64] f32
  static constexpr int kStage = kA + kRK * kRN * (int)sizeof(TB);
  static constexpr int kSmem = kStages * kStage;        // 72 KB / 80 KB
  static_assert(kKG * kRG * kRN * 4 <= kSmem, "the k groups' sums must fit");
};

__device__ __forceinline__ void widen4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void widen4(const bf16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// out rows [0, rows) x columns [0, cols) (row pitch N) = the rows of a
// (row pitch K) @ we (row pitch N), rows <= kRG: the K stream of one
// group.  Rows past `rows` are neither read nor written.
template <typename TB>
__device__ __forceinline__ void stream_group(unsigned char* smem,
                                             const float* __restrict__ a,
                                             const TB* __restrict__ we,
                                             float* __restrict__ o, int rows,
                                             int cols, int K, int N) {
  using R = RingOf<TB>;
  constexpr int EPC = 16 / (int)sizeof(TB);      // weights a 16-byte copy
  constexpr int WCH = kRN / EPC;                  // copies a weight row
  const int tid = threadIdx.x, cq = tid % kRQ, kg = tid / kRQ;
  const int KT = (K + kRK - 1) / kRK;
  auto load = [&](int kt) {
    unsigned char* st = smem + (kt % R::kStages) * R::kStage;
    const int k0 = kt * kRK;
    for (int c = tid; c < rows * (kRK / 4); c += kRThreads) {
      const int r = c / (kRK / 4), kc = (c % (kRK / 4)) * 4;
      const bool ok = k0 + kc < K;
      wg::cp16(wg::smem_addr(st + (r * kRK + kc) * 4),
               ok ? a + (long long)r * K + k0 + kc : a, ok);
    }
    for (int c = tid; c < kRK * WCH; c += kRThreads) {
      const int kr = c / WCH, nc = (c % WCH) * EPC;
      const bool ok = k0 + kr < K && nc < cols;
      wg::cp16(wg::smem_addr(st + R::kA + (kr * kRN + nc) * sizeof(TB)),
               ok ? we + (long long)(k0 + kr) * N + nc : we, ok);
    }
  };
  float acc[kRG][4];
#pragma unroll
  for (int r = 0; r < kRG; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll
  for (int s = 0; s < R::kStages - 1; ++s) {
    if (s < KT) load(s);
    wg::cp_commit();                 // an empty group keeps the count
  }
  for (int kt = 0; kt < KT; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(R::kStages - 2)
                 : "memory");
    __syncthreads();                 // slice kt is in; slice kt - 1 is read
    if (kt + R::kStages - 1 < KT) load(kt + R::kStages - 1);
    wg::cp_commit();
    const unsigned char* st = smem + (kt % R::kStages) * R::kStage;
    const float* sa = reinterpret_cast<const float*>(st) + kKP * kg;
    const TB* sw = reinterpret_cast<const TB*>(st + R::kA) +
                   kKP * kg * kRN + 4 * cq;
    float wv[kKP][4];
#pragma unroll
    for (int j = 0; j < kKP; ++j) widen4(sw + j * kRN, wv[j]);
#pragma unroll
    for (int r = 0; r < kRG; ++r) {
      if (r >= rows) break;          // uniform over the block
      float x[kKP];
#pragma unroll
      for (int j = 0; j < kKP; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(sa + r * kRK + j);
        x[j] = v.x; x[j + 1] = v.y; x[j + 2] = v.z; x[j + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kKP; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(x[j], wv[j][c], acc[r][c]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();                   // the ring is idle
  float* sum = reinterpret_cast<float*>(smem);   // [kKG][kRG][kRN]
#pragma unroll
  for (int r = 0; r < kRG; ++r) {
    if (r >= rows) break;
    *reinterpret_cast<float4*>(sum + (kg * kRG + r) * kRN + 4 * cq) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  for (int i = tid; i < rows * (kRN / 4); i += kRThreads) {
    const int r = i / (kRN / 4), c = (i % (kRN / 4)) * 4;
    if (c >= cols) continue;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kKG; ++q) {
      const float4 u =
          *reinterpret_cast<const float4*>(sum + (q * kRG + r) * kRN + c);
      t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
    }
    *reinterpret_cast<float4*>(o + (long long)r * N + c) = t;
  }
  __syncthreads();                   // the sums are read before the next ring
}

// f32 rows x w[e] [K, N] (the serving path's f32 buffers against bf16 or
// f32 expert stacks): block (row tile, column block of kRN), column
// blocks fastest.  Rows past the tile's live rows, and a tile with none
// (it reads no weight), are written as zeros with 16-byte stores; the
// live rows stream w[e] in groups of kRG.
template <typename TB>
__global__ void __launch_bounds__(kRThreads, 3)
gmm_rows_stream(const float* __restrict__ lhs, const TB* __restrict__ w,
                Layout L, float* __restrict__ out, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = (N + kRN - 1) / kRN;
  const int n0 = (blockIdx.x % nb) * kRN;
  const int r0 = (blockIdx.x / nb) * L.tm;
  const int cols = min(kRN, N - n0);
  const int live = L.live_rows(r0, L.tm);
  float* o = out + (long long)r0 * N + n0;
  const int ch = cols / 4;
  for (int i = threadIdx.x; i < (L.tm - live) * ch; i += kRThreads)
    *reinterpret_cast<float4*>(o + (long long)(live + i / ch) * N +
                               (i % ch) * 4) = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live == 0) return;
  const long long e = __ldg(L.te + r0 / L.tm);
  const TB* we = w + e * K * N + n0;
  for (int g0 = 0; g0 < live; g0 += kRG)
    stream_group<TB>(smem, lhs + (long long)(r0 + g0) * K, we,
                     o + (long long)g0 * N, min(kRG, live - g0), cols, K, N);
}

template <typename TB>
cudaError_t launch_rows_stream(const float* lhs, const void* w, Layout L,
                               float* out, int M, int K, int N,
                               cudaStream_t stream) {
  static bool smem_set = false;
  cudaError_t e =
      allow_smem(gmm_rows_stream<TB>, RingOf<TB>::kSmem, &smem_set);
  if (e != cudaSuccess) return e;
  const long long grid =
      static_cast<long long>(M / L.tm) * ((N + kRN - 1) / kRN);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  gmm_rows_stream<TB><<<static_cast<unsigned>(grid), kRThreads,
                        RingOf<TB>::kSmem, stream>>>(
      lhs, static_cast<const TB*>(w), L, out, K, N);
  return cudaGetLastError();
}

// f32 rows x w[e]^T (w [E, N, K]): the transpose_w gmm of the f32 checks
template <typename TB>
__global__ void __launch_bounds__(kFThreads)
gmm_t_f32(const float* __restrict__ lhs, const TB* __restrict__ w, Layout L,
          float* __restrict__ out, int M, int K, int N) {
  const int r0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int rows = min(kFM, M - r0), cols = min(kFN, N - n0);
  const int live = L.live_rows(r0, rows);
  float* o = out + static_cast<long long>(r0) * N + n0;
  if (live == 0) {
    store_zeros(o, N, rows, cols);
    return;
  }
  const long long e = __ldg(L.te + r0 / L.tm);
  const TB* we = w + e * K * N;
  const TB* bj[1] = {we + static_cast<long long>(n0) * K};
  float acc[1][4][4] = {};
  fma_mainloop<TB, false, true, 1>(lhs + static_cast<long long>(r0) * K, K,
                                   live, bj, K, cols, 0, K, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = ty * 4 + i, col = tx + 16 * c;
      if (r < rows && col < cols)
        o[static_cast<long long>(r) * N + col] = acc[0][i][c];
    }
}

template <typename TB>
__global__ void __launch_bounds__(kFThreads)
glu_f32(const float* __restrict__ lhs, const TB* __restrict__ wg,
        const TB* __restrict__ wu, Layout L, float* __restrict__ hs,
        float* __restrict__ hg, float* __restrict__ hu, int M, int K,
        int N) {
  const int r0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int rows = min(kFM, M - r0), cols = min(kFN, N - n0);
  const int live = L.live_rows(r0, rows);
  const long long off = static_cast<long long>(r0) * N + n0;
  if (live == 0) {
    store_zeros(hs + off, N, rows, cols);
    if (hg != nullptr) {
      store_zeros(hg + off, N, rows, cols);
      store_zeros(hu + off, N, rows, cols);
    }
    return;
  }
  const long long e = __ldg(L.te + r0 / L.tm);
  const TB* bj[2] = {wg + e * K * N + n0, wu + e * K * N + n0};
  float acc[2][4][4] = {};
  fma_mainloop<TB, false, false, 2>(lhs + static_cast<long long>(r0) * K, K,
                                    live, bj, N, cols, 0, K, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = ty * 4 + i, col = tx + 16 * c;
      if (r >= rows || col >= cols) continue;
      const long long idx = off + static_cast<long long>(r) * N + col;
      const float g = acc[0][i][c], u = acc[1][i][c];
      hs[idx] = silu_f(g) * u;
      if (hg != nullptr) {
        hg[idx] = g;
        hu[idx] = u;
      }
    }
}

__global__ void __launch_bounds__(kFThreads)
dw_f32(const float* __restrict__ lhs, const float* __restrict__ dout,
       Layout L, float* __restrict__ dw, int K, int N) {
  const int e = blockIdx.z;
  const int k0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int rows = min(kFM, K - k0), cols = min(kFN, N - n0);
  const int row_begin = L.first_tile(e) * L.tm;
  const int row_end = row_begin + __ldg(L.counts + e);
  const float* bj[1] = {dout + n0};
  float acc[1][4][4] = {};
  fma_mainloop<float, true, false, 1>(lhs + k0, K, rows, bj, N, cols,
                                      row_begin, row_end, acc);
  float* o = dw + (static_cast<long long>(e) * K + k0) * N + n0;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = ty * 4 + i, col = tx + 16 * c;
      if (r < rows && col < cols)
        o[static_cast<long long>(r) * N + col] = acc[0][i][c];
    }
}

inline unsigned blocks(int n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

}  // namespace ptt

extern "C" {

// Dtype codes: 0 float32, 1 bfloat16.  lhs [M, K] row-major; tile_expert
// [M / tm] and counts [E] int32 (counts may be null: no row is skipped).
// bfloat16 needs bfloat16 weights, tm % 128 == 0, K % 8 == 0, N % 8 == 0
// and 16-byte aligned operands; float32 rows take float32 or bfloat16
// weights and tm % 32 == 0.  Each returns a cudaError_t.

// out [M, N] = row tile i of lhs @ w[tile_expert[i]], w [E, K, N]; or
// w [E, N, K] contracted on its last axis when transpose_w.
int gmm(const void* lhs, const void* w, const int* tile_expert,
        const int* counts, void* out, int M, int K, int N, int E, int tm,
        int transpose_w, int a_dtype, int w_dtype, void* stream) {
  using namespace ptt;
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || E <= 0 || tm <= 0 || M % tm) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L{tile_expert, counts, E, tm};
  if (a_dtype == 1 && w_dtype == 1) {
    if (tm % kTileM || K % 8 || N % 8) return cudaErrorInvalidValue;
    return transpose_w
               ? launch_gmm_wgmma<true>(lhs, w, L, out, M, K, N, E, s)
               : launch_gmm_wgmma<false>(lhs, w, L, out, M, K, N, E, s);
  }
  if (a_dtype != 0 || tm % kFM || N % 4 || (w_dtype != 0 && w_dtype != 1))
    return cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(lhs);
  float* o = static_cast<float*>(out);
  if (!transpose_w) {
    if (K % 4 || N % (w_dtype == 0 ? 4 : 8)) return cudaErrorInvalidValue;
    return w_dtype == 0 ? launch_rows_stream<float>(a, w, L, o, M, K, N, s)
                        : launch_rows_stream<bf16>(a, w, L, o, M, K, N, s);
  }
  const dim3 grid(blocks(N, kFN), blocks(M, kFM));
  if (w_dtype == 0)
    gmm_t_f32<float><<<grid, kFThreads, 0, s>>>(
        a, static_cast<const float*>(w), L, o, M, K, N);
  else
    gmm_t_f32<bf16><<<grid, kFThreads, 0, s>>>(
        a, static_cast<const bf16*>(w), L, o, M, K, N);
  return cudaGetLastError();
}

// hs [M, N] = silu(lhs @ wg[e]) * (lhs @ wu[e]), wg/wu [E, K, N]; hg and
// hu (both null, or both set) receive the two products.
int gmm_glu(const void* lhs, const void* wg, const void* wu,
            const int* tile_expert, const int* counts, void* hs, void* hg,
            void* hu, int M, int K, int N, int E, int tm, int a_dtype,
            int w_dtype, void* stream) {
  using namespace ptt;
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || E <= 0 || tm <= 0 || M % tm || (hg == nullptr) !=
      (hu == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L{tile_expert, counts, E, tm};
  if (a_dtype == 1 && w_dtype == 1) {
    if (tm % kTileM || K % 8 || N % 8) return cudaErrorInvalidValue;
    return launch_glu_wgmma(lhs, wg, wu, L, hs, hg, hu, M, K, N, E, s);
  }
  if (a_dtype != 0 || tm % kFM) return cudaErrorInvalidValue;
  const dim3 grid(blocks(N, kFN), blocks(M, kFM));
  const float* a = static_cast<const float*>(lhs);
  if (w_dtype == 0)
    glu_f32<float><<<grid, kFThreads, 0, s>>>(
        a, static_cast<const float*>(wg), static_cast<const float*>(wu), L,
        static_cast<float*>(hs), static_cast<float*>(hg),
        static_cast<float*>(hu), M, K, N);
  else if (w_dtype == 1)
    glu_f32<bf16><<<grid, kFThreads, 0, s>>>(
        a, static_cast<const bf16*>(wg), static_cast<const bf16*>(wu), L,
        static_cast<float*>(hs), static_cast<float*>(hg),
        static_cast<float*>(hu), M, K, N);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// dw [E, K, N] = per expert, lhs_e^T @ dout_e over the expert's rows
// (lhs [M, K], dout [M, N], one dtype); zeros for an expert with none.
int gmm_dw(const void* lhs, const void* dout, const int* counts, void* dw,
           int M, int K, int N, int E, int tm, int dtype, void* stream) {
  using namespace ptt;
  if (K <= 0 || N <= 0 || E <= 0) return cudaSuccess;
  if (tm <= 0 || M < 0 || counts == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L{nullptr, counts, E, tm};
  if (dtype == 1) {
    if (K % 8 || N % 8) return cudaErrorInvalidValue;
    return launch_dw_wgmma(lhs, dout, L, dw, M, K, N, E, s);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  const dim3 grid(blocks(N, kFN), blocks(K, kFM), E);
  dw_f32<<<grid, kFThreads, 0, s>>>(static_cast<const float*>(lhs),
                                    static_cast<const float*>(dout), L,
                                    static_cast<float*>(dw), K, N);
  return cudaGetLastError();
}

const char* grouped_matmul_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
