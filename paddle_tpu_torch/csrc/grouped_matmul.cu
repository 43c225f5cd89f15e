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
// expert's rows and writes its tile once (no atomics).
//
// The row layout on the device.  Expert e's tiles start at tile
// sum_{e' < e} ceil(counts[e'] / tm); a row of a tile past its expert's
// count is padding, and a tile past the last expert's is dead (the plan
// maps it to expert E - 1).  When counts is given, a block reads its
// padding rows as zeros, and a block with no routed row writes zeros and
// reads no weight: at a decode step, where 32 routed rows sit in 128-row
// tiles, the products cover the routed rows' 8-row (f32 rows) or
// 128-row (bf16) blocks, not every tile.  Each block finds its expert's first
// tile by summing counts (E loads, from L1).  Without counts every row
// is computed.
//
// bf16 rows and weights: mma.sync.aligned.m16n8k16 (bf16 in, f32
// accumulate), 8 warps (4 x 2), k steps of 32 through a 3-stage cp.async
// ring in shared memory (rows padded by 16 bytes, so ldmatrix reads are
// free of bank conflicts).  gmm: 128 x 128 output tile, a warp 32 x 64.
// gmm_glu: 128 x 64 of each of the gate and up products, one lhs tile
// feeding both accumulators, so registers stay at one 128 x 128 tile's;
// the silu(g) * u epilogue runs in f32 in registers.  gmm_dw: the A
// operand is lhs^T, read from the [rows][k] tile with ldmatrix.trans.
// B fragments come from ldmatrix.trans of a [k][n] tile, or from ldmatrix
// of a [n][k] tile when transpose_w reads w[e] as [N, K].
// f32 rows (the serving path's f32 buffers against bf16 or f32 weights,
// and the f32 training checks) run on the FMA pipe in exact f32; the
// product is the plain version's, summed in another order.  gmm against
// w [E, K, N] (the serving path) takes blocks of 8 rows x 256 columns:
// a tile of a decode step holds a few routed rows, so a block of live
// rows streams its expert's weight columns once, one 8-byte (bf16) or
// 16-byte (f32) load a thread for 32 FMAs, and the block's four k
// groups are summed in shared memory.  transpose_w, gmm_glu and gmm_dw
// (the f32 training checks) take 32 x 64 output tiles of 4 x 4 a thread.
//
// What bounds them on an H100: operations for the training shapes
// (80,896 x 2048 x 1408 per projection, about 0.47 TFLOP, 0.47 ms at 989
// TFLOP/s); bytes for a decode step (each routed expert's 5.8 MB weight
// read once a projection).  mma.sync reaches a fraction of the wgmma
// rate, and the f32 path runs on the FMA pipe; wgmma with TMA, and bf16
// hi/lo operands for the f32 rows, are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

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

// ----------------------------------------------------------------- bf16

constexpr int kBM = 128, kBK = 32, kStages = 3, kThreads = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;          // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared-memory geometry of one stage: the A tile (kBM rows x kBK, or
// stored k-major as kBK x kBM when AT) and NB B tiles (kBK x BN, or
// stored n-major as BN x kBK when BT), rows padded by 8 elements.
template <bool AT, bool BT, int NB> struct Tile {
  static constexpr int BN = 128 / NB;          // columns of each product
  static constexpr int WN = BN / 2;            // columns a warp owns
  static constexpr int NT = WN / 8;            // n8 tiles a warp owns
  static constexpr int AP = (AT ? kBM : kBK) + 8;
  static constexpr int AR = AT ? kBK : kBM;
  static constexpr int BP = (BT ? kBK : BN) + 8;
  static constexpr int BR = BT ? BN : kBK;
  static constexpr int A_ELEMS = AR * AP;
  static constexpr int B_ELEMS = BR * BP;
  static constexpr int STAGE = A_ELEMS + NB * B_ELEMS;
  static constexpr int SMEM = kStages * STAGE * 2;
};

// acc[j] += A x B_j over the contraction range [k_begin, k_end).
// A element (r, k): AT ? a[k * lda + r] : a[r * lda + k], live for
// r < a_rows; B_j element (k, n): BT ? b[j][n * ldb + k] :
// b[j][k * ldb + n], live for n < n_lim.  Dead elements load as zeros.
// Every contiguous run is a multiple of 8 elements (16 bytes).
template <bool AT, bool BT, int NB>
__device__ __forceinline__ void mma_mainloop(
    bf16* smem, const bf16* __restrict__ a, long long lda, int a_rows,
    const bf16* const* b, long long ldb, int n_lim, int k_begin, int k_end,
    float (&acc)[NB][2][Tile<AT, BT, NB>::NT][4]) {
  using T = Tile<AT, BT, NB>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;

  auto load_stage = [&](int stage, int k0) {
    bf16* sa = smem + stage * T::STAGE;
    if (!AT) {
#pragma unroll
      for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
        const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
        const bool ok = r < a_rows && k0 + kc < k_end;
        cp_async16(sa + r * T::AP + kc, ok ? a + r * lda + k0 + kc : a, ok);
      }
    } else {
#pragma unroll
      for (int c = tid; c < kBK * kBM / 8; c += kThreads) {
        const int kr = c / (kBM / 8), rc = (c % (kBM / 8)) * 8;
        const bool ok = k0 + kr < k_end && rc < a_rows;
        cp_async16(sa + kr * T::AP + rc,
                   ok ? a + static_cast<long long>(k0 + kr) * lda + rc : a,
                   ok);
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      bf16* sb = sa + T::A_ELEMS + j * T::B_ELEMS;
      if (!BT) {
#pragma unroll
        for (int c = tid; c < kBK * T::BN / 8; c += kThreads) {
          const int kr = c / (T::BN / 8), nc = (c % (T::BN / 8)) * 8;
          const bool ok = k0 + kr < k_end && nc < n_lim;
          cp_async16(sb + kr * T::BP + nc,
                     ok ? b[j] + static_cast<long long>(k0 + kr) * ldb + nc
                        : b[j], ok);
        }
      } else {
#pragma unroll
        for (int c = tid; c < T::BN * kBK / 8; c += kThreads) {
          const int nr = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
          const bool ok = nr < n_lim && k0 + kc < k_end;
          cp_async16(sb + nr * T::BP + kc,
                     ok ? b[j] + nr * ldb + k0 + kc : b[j], ok);
        }
      }
    }
  };

  const int KT = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, k_begin + s * kBK);
    cp_async_commit();                // an empty group keeps the count
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();     // k tile kt has landed
    __syncthreads();                  // ... for every thread; and the
                                      // stage refilled below is drained
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, k_begin + next * kBK);
    cp_async_commit();
    const bf16* sa = smem + (kt % kStages) * T::STAGE;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16;
        if (!AT)
          ldmatrix_x4(af[mt], sa + (r + (lane & 15)) * T::AP + kk
                                  + (lane >> 4) * 8);
        else
          ldmatrix_x4_trans(af[mt],
                            sa + (kk + (lane & 7) + ((lane >> 4) << 3))
                                     * T::AP
                               + r + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const bf16* sb = sa + T::A_ELEMS + j * T::B_ELEMS;
        uint32_t bfr[T::NT][2];
#pragma unroll
        for (int np = 0; np < T::NT / 2; ++np) {
          const int c = wn * T::WN + np * 16;
          uint32_t t[4];
          if (!BT)
            ldmatrix_x4_trans(t, sb + (kk + (lane & 15)) * T::BP + c
                                     + (lane >> 4) * 8);
          else
            ldmatrix_x4(t, sb + (c + (lane & 7) + ((lane >> 4) << 3))
                                    * T::BP
                               + kk + ((lane >> 3) & 1) * 8);
          bfr[2 * np][0] = t[0];
          bfr[2 * np][1] = t[1];
          bfr[2 * np + 1][0] = t[2];
          bfr[2 * np + 1][1] = t[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt)
            mma_bf16(acc[j][mt][nt], af[mt], bfr[nt]);
      }
    }
  }
  cp_async_wait<0>();
}

// Zeros over rows [0, rows) x columns [0, cols) of a row-major tile.
template <typename T>
__device__ __forceinline__ void store_zeros(T* out, long long ld, int rows,
                                            int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
    out[(i / cols) * ld + i % cols] = T(0.f);
}

// The thread's accumulator element (mt, nt, h): row and column in the
// block's output tile.
template <int WN>
__device__ __forceinline__ void acc_pos(int mt, int nt, int h, int* r,
                                        int* c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  *r = (warp >> 1) * 32 + mt * 16 + (lane >> 2) + h * 8;
  *c = (warp & 1) * WN + nt * 8 + (lane & 3) * 2;
}

template <bool BT>
__global__ void __launch_bounds__(kThreads, 2)
gmm_bf16(const bf16* __restrict__ lhs, const bf16* __restrict__ w,
         Layout L, bf16* __restrict__ out, int M, int K, int N) {
  using T = Tile<false, BT, 1>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r0 = blockIdx.y * kBM, n0 = blockIdx.x * T::BN;
  const int rows = min(kBM, M - r0), cols = min(T::BN, N - n0);
  const int live = L.live_rows(r0, rows);
  bf16* o = out + static_cast<long long>(r0) * N + n0;
  if (live == 0) {
    store_zeros(o, N, rows, cols);
    return;
  }
  const long long e = __ldg(L.te + r0 / L.tm);
  const bf16* we = w + e * K * N;
  const bf16* bj[1] = {BT ? we + static_cast<long long>(n0) * K : we + n0};
  float acc[1][2][T::NT][4] = {};
  mma_mainloop<false, BT, 1>(reinterpret_cast<bf16*>(smem_raw),
                             lhs + static_cast<long long>(r0) * K, K, live,
                             bj, BT ? K : N, cols, 0, K, acc);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r, c;
        acc_pos<T::WN>(mt, nt, h, &r, &c);
        if (r < rows && c < cols)
          *reinterpret_cast<__nv_bfloat162*>(o + static_cast<long long>(r)
                                             * N + c) =
              __floats2bfloat162_rn(acc[0][mt][nt][2 * h],
                                    acc[0][mt][nt][2 * h + 1]);
      }
}

__global__ void __launch_bounds__(kThreads, 2)
glu_bf16(const bf16* __restrict__ lhs, const bf16* __restrict__ wg,
         const bf16* __restrict__ wu, Layout L, bf16* __restrict__ hs,
         bf16* __restrict__ hg, bf16* __restrict__ hu, int M, int K, int N) {
  using T = Tile<false, false, 2>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r0 = blockIdx.y * kBM, n0 = blockIdx.x * T::BN;
  const int rows = min(kBM, M - r0), cols = min(T::BN, N - n0);
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
  const bf16* bj[2] = {wg + e * K * N + n0, wu + e * K * N + n0};
  float acc[2][2][T::NT][4] = {};
  mma_mainloop<false, false, 2>(reinterpret_cast<bf16*>(smem_raw),
                                lhs + static_cast<long long>(r0) * K, K,
                                live, bj, N, cols, 0, K, acc);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r, c;
        acc_pos<T::WN>(mt, nt, h, &r, &c);
        if (r >= rows || c >= cols) continue;
        const long long i = off + static_cast<long long>(r) * N + c;
        const float g0 = acc[0][mt][nt][2 * h], g1 = acc[0][mt][nt][2 * h + 1];
        const float u0 = acc[1][mt][nt][2 * h], u1 = acc[1][mt][nt][2 * h + 1];
        *reinterpret_cast<__nv_bfloat162*>(hs + i) =
            __floats2bfloat162_rn(silu_f(g0) * u0, silu_f(g1) * u1);
        if (hg != nullptr) {
          *reinterpret_cast<__nv_bfloat162*>(hg + i) =
              __floats2bfloat162_rn(g0, g1);
          *reinterpret_cast<__nv_bfloat162*>(hu + i) =
              __floats2bfloat162_rn(u0, u1);
        }
      }
}

// dw[e][k0.., n0..] = sum over expert e's rows of lhs^T @ dout
__global__ void __launch_bounds__(kThreads, 2)
dw_bf16(const bf16* __restrict__ lhs, const bf16* __restrict__ dout,
        Layout L, bf16* __restrict__ dw, int K, int N) {
  using T = Tile<true, false, 1>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.z;
  const int k0 = blockIdx.y * kBM, n0 = blockIdx.x * T::BN;
  const int rows = min(kBM, K - k0), cols = min(T::BN, N - n0);
  const int row_begin = L.first_tile(e) * L.tm;
  const int row_end = row_begin + __ldg(L.counts + e);
  const bf16* bj[1] = {dout + n0};
  float acc[1][2][T::NT][4] = {};
  mma_mainloop<true, false, 1>(reinterpret_cast<bf16*>(smem_raw), lhs + k0,
                               K, rows, bj, N, cols, row_begin, row_end,
                               acc);
  bf16* o = dw + (static_cast<long long>(e) * K + k0) * N + n0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r, c;
        acc_pos<T::WN>(mt, nt, h, &r, &c);
        if (r < rows && c < cols)
          *reinterpret_cast<__nv_bfloat162*>(o + static_cast<long long>(r)
                                             * N + c) =
              __floats2bfloat162_rn(acc[0][mt][nt][2 * h],
                                    acc[0][mt][nt][2 * h + 1]);
      }
}

template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

// ------------------------------------------------------------------ f32

constexpr int kFM = 32, kFN = 64, kFK = 16, kFThreads = 128;

// acc[j] += A x B_j on the FMA pipe, A and the B_j read as in
// mma_mainloop (f32 A; B_j in TB, widened to f32).  Thread (ty, tx) owns
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

constexpr int kSR = 8, kSN = 256, kSK = 512, kSThreads = 256;

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// f32 rows x w[e] [K, N] in blocks of kSR rows x kSN columns.  Thread t
// owns columns 4 (t % 64) .. + 3 and the k of its group t / 64 (every
// 4th k of a chunk); the rows' chunk of kSK values sits in shared
// memory, which then holds the four groups' partial sums.
template <typename TB>
__global__ void __launch_bounds__(kSThreads)
gmm_rows_f32(const float* __restrict__ lhs, const TB* __restrict__ w,
             Layout L, float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float buf[4 * kSR * kSN];
  const int r0 = blockIdx.y * kSR, n0 = blockIdx.x * kSN;
  const int rows = min(kSR, M - r0), cols = min(kSN, N - n0);
  const int live = L.live_rows(r0, rows);
  float* o = out + static_cast<long long>(r0) * N + n0;
  if (live == 0) {
    store_zeros(o, N, rows, cols);
    return;
  }
  const long long e = __ldg(L.te + r0 / L.tm);
  const TB* we = w + e * K * N + n0;
  const int tid = threadIdx.x, kg = tid / 64, c0 = (tid % 64) * 4;
  float acc[kSR][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSK) {
    const int kc = min(kSK, K - k0);
    __syncthreads();                  // the last chunk's readers are done
    for (int i = tid; i < kSR * kSK; i += kSThreads) {
      const int r = i / kSK, k = i % kSK;
      buf[i] = r < live && k < kc
                   ? lhs[static_cast<long long>(r0 + r) * K + k0 + k] : 0.f;
    }
    __syncthreads();
    if (c0 < cols) {
#pragma unroll 4
      for (int k = kg; k < kc; k += 4) {
        float wv[4];
        load4(we + static_cast<long long>(k0 + k) * N + c0, wv);
#pragma unroll
        for (int r = 0; r < kSR; ++r) {
          const float a = buf[r * kSK + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a, wv[c], acc[r][c]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSR; ++r)
    *reinterpret_cast<float4*>(buf + (kg * kSR + r) * kSN + c0) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int i = tid; i < kSR * kSN; i += kSThreads) {
    const int r = i / kSN, c = i % kSN;
    if (r < rows && c < cols)
      o[static_cast<long long>(r) * N + c] =
          buf[r * kSN + c] + buf[(kSR + r) * kSN + c]
          + buf[(2 * kSR + r) * kSN + c] + buf[(3 * kSR + r) * kSN + c];
  }
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
    if (tm % kBM || K % 8 || N % 8) return cudaErrorInvalidValue;
    const dim3 grid(blocks(N, 128), blocks(M, kBM));
    static bool ok_n = false, ok_t = false;
    cudaError_t e;
    if (transpose_w) {
      if ((e = allow_smem(gmm_bf16<true>, Tile<false, true, 1>::SMEM,
                          &ok_t)) != cudaSuccess) return e;
      gmm_bf16<true><<<grid, kThreads, Tile<false, true, 1>::SMEM, s>>>(
          static_cast<const bf16*>(lhs), static_cast<const bf16*>(w), L,
          static_cast<bf16*>(out), M, K, N);
    } else {
      if ((e = allow_smem(gmm_bf16<false>, Tile<false, false, 1>::SMEM,
                          &ok_n)) != cudaSuccess) return e;
      gmm_bf16<false><<<grid, kThreads, Tile<false, false, 1>::SMEM, s>>>(
          static_cast<const bf16*>(lhs), static_cast<const bf16*>(w), L,
          static_cast<bf16*>(out), M, K, N);
    }
    return cudaGetLastError();
  }
  if (a_dtype != 0 || tm % kFM || N % 4 || (w_dtype != 0 && w_dtype != 1))
    return cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(lhs);
  float* o = static_cast<float*>(out);
  if (!transpose_w) {
    const dim3 grid(blocks(N, kSN), blocks(M, kSR));
    if (w_dtype == 0)
      gmm_rows_f32<float><<<grid, kSThreads, 0, s>>>(
          a, static_cast<const float*>(w), L, o, M, K, N);
    else
      gmm_rows_f32<bf16><<<grid, kSThreads, 0, s>>>(
          a, static_cast<const bf16*>(w), L, o, M, K, N);
    return cudaGetLastError();
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
    if (tm % kBM || K % 8 || N % 8) return cudaErrorInvalidValue;
    using T = Tile<false, false, 2>;
    static bool ok = false;
    const cudaError_t e = allow_smem(glu_bf16, T::SMEM, &ok);
    if (e != cudaSuccess) return e;
    const dim3 grid(blocks(N, T::BN), blocks(M, kBM));
    glu_bf16<<<grid, kThreads, T::SMEM, s>>>(
        static_cast<const bf16*>(lhs), static_cast<const bf16*>(wg),
        static_cast<const bf16*>(wu), L, static_cast<bf16*>(hs),
        static_cast<bf16*>(hg), static_cast<bf16*>(hu), M, K, N);
    return cudaGetLastError();
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
    using T = Tile<true, false, 1>;
    static bool ok = false;
    const cudaError_t e = allow_smem(dw_bf16, T::SMEM, &ok);
    if (e != cudaSuccess) return e;
    const dim3 grid(blocks(N, T::BN), blocks(K, kBM), E);
    dw_bf16<<<grid, kThreads, T::SMEM, s>>>(
        static_cast<const bf16*>(lhs), static_cast<const bf16*>(dout), L,
        static_cast<bf16*>(dw), K, N);
    return cudaGetLastError();
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
