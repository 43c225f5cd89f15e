// One q or k projection with the rotary embedding applied to its output
// tile: out[B, S, n_heads, D] = rope(round(x @ W)).
//
// Replaces the TPU kernel `_matmul_rope_k`
// (paddle_tpu/ops/pallas/fused_train.py, body `_mmr_kernel_body`).  A
// block owns a tile of rows times whole heads (the rotation pairs column
// c with c +- D/2 inside the head, so it never leaves the block).  The
// product accumulates in f32 and is rounded to the input dtype; the tile
// then goes through shared memory, and every element is rotated in f32,
// y*cos + rotate_half(y)*sin with each product and the sum rounded as
// PyTorch rounds them (no FMA), and written once in the input dtype.  The
// tables are read in their own dtype (bf16 or f32) and widened in
// registers, which is exact, so the wrapper casts nothing.  Each row
// takes its table row from its own position, row % S, so a tile may span
// a batch boundary.
//
// What bounds it on an H100: operations.  At the training shape, q is
// 2 x 8192 x 4096 x 4096 = 275 GFLOP (0.278 ms at 989 TFLOP/s) and k
// 68.7 GFLOP, against 64 MiB + 32 MiB of input and 64 MiB of output.
// So the product belongs on the tensor cores at their full rate: wgmma.
//
// bf16: `matmul_rope_wgmma` (attention_wgmma.cuh).  A block tile is 128
// rows x 128 columns: one head at D 128, two at D 64.  Two consumer
// warpgroups each own 64 rows as one m64n128 f32 accumulator (64
// registers a thread).  A 256-column tile (two heads at D 128) would
// read each x tile from L2 half as often, at 128 accumulator registers
// a thread and an epilogue tile twice the size beside a ring of 3
// stages; the 128-column tile is the simpler first design, the larger
// one stays open (PERF.md).  One producer warp fills a 4-stage ring of
// 64-deep k slices with TMA (x [128][64] K-major; W [64][128] as two
// [64][64] boxes, MN-major, read through wgmma's transpose bit: no
// transposed copy of W), each stage with a full and an empty mbarrier;
// the consumers wait on the full barrier of the slice they read, keep
// one wgmma group in flight, and free a stage once the group that read
// it retires.  The tensor maps (tma_ring.cuh) are built per call on the
// host (x and W move), zero-filling the ragged M and K edges (K % 8 == 0
// for the 16-byte row pitch).  The
// epilogue rounds the accumulator to bf16 into a padded shared tile,
// rotates 8 columns a thread against their partners and the tables, and
// writes 16-byte stores.  Blocks walk the column tiles (heads) fastest,
// so an x tile serves every head from L2 while it is hot and W (32 MiB
// for q) stays in the 50 MB L2.
// float32: the product runs on the FMA pipe in exact f32 (64 rows x D
// columns, 4 x D/16 outputs a thread), for the f32 reference checks.
#include "attention_wgmma.cuh"
#include "tma_ring.cuh"

namespace ptt {

typedef __nv_bfloat16 bf16;

// Rotate the tile (rows m0.., columns of one head starting at col0) held
// in shared memory with row pitch PITCH, and write it out.
template <typename T, typename TT, typename ST, int BM, int D, int PITCH>
__device__ __forceinline__ void rope_store(const ST* tile, T* out,
                                           const TT* cos, const TT* sin,
                                           int m0, int M, int S, int N,
                                           int col0) {
  constexpr int kHalf = D / 2;
  for (int idx = threadIdx.x; idx < BM * D; idx += blockDim.x) {
    const int rr = idx / D, c = idx % D;
    const int row = m0 + rr;
    if (row >= M) break;            // rows grow with idx: the rest are out
    const long long t = static_cast<long long>(row % S) * D + c;
    const float y = to_f(tile[rr * PITCH + c]);
    const float p = c < kHalf ? -to_f(tile[rr * PITCH + c + kHalf])
                              : to_f(tile[rr * PITCH + c - kHalf]);
    const float o = __fadd_rn(__fmul_rn(y, to_f(cos[t])),
                              __fmul_rn(p, to_f(sin[t])));
    out[static_cast<long long>(row) * N + col0 + c] = from_f<T>(o);
  }
}

// ----------------------------------------------------------------- bf16

constexpr int kTileM = 128, kTileN = 128, kDepth = 64, kStages = 4;
constexpr int kConsumers = 256;                 // two warpgroups
constexpr int kMmrThreads = kConsumers + 32;    // and the producer warp
constexpr int kSliceA = kTileM * kDepth * 2;    // x slice [128][64]
constexpr int kBoxB = kDepth * 64 * 2;          // W box [64][64]
constexpr int kStage = kSliceA + 2 * kBoxB;
constexpr int kOutPitch = (kTileN + 8) * 2;     // bytes a row of the tile
constexpr size_t kMmrSmem =
    (size_t)kStages * kStage + (size_t)kTileM * kOutPitch +
    2 * kStages * 8 + 1024;

// 8 table values from 16-byte aligned t, widened to f32
__device__ __forceinline__ void load8(const bf16* t, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(t);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = wg::unpack2<bf16>(w[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* t, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(t);
  const float4 b = *reinterpret_cast<const float4*>(t + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <int D, typename TT>
__global__ void __launch_bounds__(kMmrThreads, 1)
matmul_rope_wgmma(__grid_constant__ const CUtensorMap tmx,
                  __grid_constant__ const CUtensorMap tmw,
                  const TT* __restrict__ cos, const TT* __restrict__ sin,
                  bf16* __restrict__ out, int M, int K, int N, int S) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* tile = smem + kStages * kStage;
  const uint32_t ring = wg::smem_addr(smem);
  const uint32_t full0 = ring + kStages * kStage + kTileM * kOutPitch;
  const uint32_t empty0 = full0 + 8 * kStages;
  const int n_tiles = (N + kTileN - 1) / kTileN;
  const int n0 = (blockIdx.x % n_tiles) * kTileN;   // heads fastest
  const int m0 = (blockIdx.x / n_tiles) * kTileM;
  const int KT = (K + kDepth - 1) / kDepth;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);               // the producer's arrival
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {           // the producer warp: one thread
    if (tid == kConsumers) {
      // a W tile of one head at D 64 (the last of an odd count) loads
      // one box: the columns past N are never stored
      const bool two = n0 + 64 < N;
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty0 + 8 * s, (kt / kStages - 1) & 1);
        const uint32_t st = ring + s * kStage, bar = full0 + 8 * s;
        mbar_expect_tx(bar, kSliceA + (two ? 2 : 1) * kBoxB);
        tma_load(st, &tmx, kt * kDepth, m0, bar);
        tma_load(st + kSliceA, &tmw, n0, kt * kDepth, bar);
        if (two)
          tma_load(st + kSliceA + kBoxB, &tmw, n0 + 64, kt * kDepth, bar);
      }
    }
    return;
  }

  const int w = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[kTileN / 2];
#pragma unroll
  for (int i = 0; i < kTileN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
    const uint32_t st = ring + s * kStage;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk)
      wg::Wgmma<bf16, kTileN>::ss_mn(
          acc, wg::desc_k<kTileM>(st + w * 64 * 128, kk),
          wg::desc_mn<kDepth>(st + kSliceA, kk), 1);
    wg::commit();
    wg::wait<1>();                   // the group of slice kt - 1 retired
    if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % kStages));
  }
  wg::wait<0>();
  wg::keep(acc);

  // the product rounded to bf16 into this warpgroup's rows of the tile
  const int lr = 64 * w + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    *reinterpret_cast<uint32_t*>(tile + lr * kOutPitch + 2 * c) =
        wg::pack2<bf16>(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tile + (lr + 8) * kOutPitch + 2 * c) =
        wg::pack2<bf16>(acc[4 * j + 2], acc[4 * j + 3]);
  }
  wg::wg_barrier(1 + w);
  // rotate 8 columns a thread against their partners c +- D/2 (same row,
  // same head) and write them with one 16-byte store
  constexpr int kHalf = D / 2, CH = kTileN / 8;
  for (int i = wt; i < 64 * CH; i += 128) {
    const int r = 64 * w + i / CH, c = (i % CH) * 8;
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    const int cl = c % D;            // the column within its head
    const bool lo = cl < kHalf;
    const uint4 yu = *reinterpret_cast<const uint4*>(tile + r * kOutPitch +
                                                     2 * c);
    const uint4 pu = *reinterpret_cast<const uint4*>(
        tile + r * kOutPitch + 2 * (lo ? c + kHalf : c - kHalf));
    const long long t = static_cast<long long>(row % S) * D + cl;
    float cv[8], sv[8];
    load8(cos + t, cv);
    load8(sin + t, sv);
    const uint32_t yw[4] = {yu.x, yu.y, yu.z, yu.w};
    const uint32_t pw[4] = {pu.x, pu.y, pu.z, pu.w};
    uint32_t ow[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 y = wg::unpack2<bf16>(yw[e]), p = wg::unpack2<bf16>(pw[e]);
      const float p0 = lo ? -p.x : p.x, p1 = lo ? -p.y : p.y;
      ow[e] = wg::pack2<bf16>(
          __fadd_rn(__fmul_rn(y.x, cv[2 * e]), __fmul_rn(p0, sv[2 * e])),
          __fadd_rn(__fmul_rn(y.y, cv[2 * e + 1]),
                    __fmul_rn(p1, sv[2 * e + 1])));
    }
    *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * N + col) =
        make_uint4(ow[0], ow[1], ow[2], ow[3]);
  }
}

template <int D, typename TT>
cudaError_t launch_bf16(const void* x, const void* w, const void* cos,
                        const void* sin, void* out, int M, int K,
                        int n_heads, int S, cudaStream_t stream) {
  const int N = n_heads * D;
  CUtensorMap tmx, tmw;
  cudaError_t e = make_map(&tmx, x, M, K, kTileM);
  if (e == cudaSuccess) e = make_map(&tmw, w, K, N, kDepth);
  if (e != cudaSuccess) return e;
  static bool smem_set = false;
  e = allow_smem(matmul_rope_wgmma<D, TT>, kMmrSmem, &smem_set);
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>((M + kTileM - 1) / kTileM) *
                           ((N + kTileN - 1) / kTileN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  matmul_rope_wgmma<D, TT><<<static_cast<unsigned>(blocks), kMmrThreads,
                             kMmrSmem, stream>>>(
      tmx, tmw, static_cast<const TT*>(cos), static_cast<const TT*>(sin),
      static_cast<bf16*>(out), M, K, N, S);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ f32

constexpr int kFM = 64, kFK = 16, kThreads = 256;

template <int D, typename TT>
__global__ void __launch_bounds__(kThreads)
matmul_rope_f32(const float* __restrict__ x, const float* __restrict__ w,
                const TT* __restrict__ cos, const TT* __restrict__ sin,
                float* __restrict__ out, int M, int K, int n_heads, int S) {
  constexpr int kTN = D / 16;          // columns a thread owns, 16 apart
  constexpr int kTM = 4;               // rows a thread owns, adjacent
  constexpr int kCP = D + 1;           // output tile pitch
  __shared__ float sa[kFK][kFM];       // x tile, k-major
  __shared__ float sb[kFK][D];
  __shared__ float tile[kFM * kCP];
  const int N = n_heads * D;
  const int head = blockIdx.x % n_heads;
  const int m0 = (blockIdx.x / n_heads) * kFM;
  const int n0 = head * D;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int i = tid; i < kFM * kFK; i += kThreads) {
      const int r = i / kFK, k = i % kFK;
      sa[k][r] = m0 + r < M && k0 + k < K
                     ? x[static_cast<long long>(m0 + r) * K + k0 + k] : 0.f;
    }
    for (int i = tid; i < kFK * D; i += kThreads) {
      const int k = i / D, n = i % D;
      sb[k][n] = k0 + k < K ? w[static_cast<long long>(k0 + k) * N + n0 + n]
                            : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = sa[k][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = sb[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      tile[(ty * kTM + i) * kCP + tx + 16 * j] = acc[i][j];
  __syncthreads();
  rope_store<float, TT, float, kFM, D, kCP>(tile, out, cos, sin, m0, M, S,
                                           N, n0);
}

template <int D, typename TT>
cudaError_t launch_f32(const void* x, const void* w, const void* cos,
                       const void* sin, void* out, int M, int K,
                       int n_heads, int S, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>((M + kFM - 1) / kFM) * n_heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  matmul_rope_f32<D, TT><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const TT*>(cos), static_cast<const TT*>(sin),
      static_cast<float*>(out), M, K, n_heads, S);
  return cudaGetLastError();
}

// The kernel of a dtype (bf16 on wgmma, f32 on the FMA pipe), a head
// dim and a table dtype.
template <typename TT>
cudaError_t dispatch(const void* x, const void* w, const void* cos,
                     const void* sin, void* out, int M, int K, int n_heads,
                     int D, int S, int dtype, cudaStream_t s) {
  if (dtype == 1 && K % 8 == 0) {
    if (D == 64)
      return launch_bf16<64, TT>(x, w, cos, sin, out, M, K, n_heads, S, s);
    if (D == 128)
      return launch_bf16<128, TT>(x, w, cos, sin, out, M, K, n_heads, S, s);
  }
  if (dtype == 0) {
    if (D == 64)
      return launch_f32<64, TT>(x, w, cos, sin, out, M, K, n_heads, S, s);
    if (D == 128)
      return launch_f32<128, TT>(x, w, cos, sin, out, M, K, n_heads, S, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace ptt

extern "C" {

// x [M, K] and w [K, n_heads * D] contiguous in one dtype (0 float32,
// 1 bfloat16), cos/sin [S, D] contiguous in table_dtype (0 float32,
// 1 bfloat16), out [M, n_heads * D] in x's dtype; row m takes table row
// m % S.  D is 64 or 128; bfloat16 needs K % 8 == 0 and 16-byte aligned
// x, w and tables.  Returns a cudaError_t.
int matmul_rope(const void* x, const void* w, const void* cos,
                const void* sin, void* out, int M, int K, int n_heads,
                int D, int S, int dtype, int table_dtype, void* stream) {
  if (M <= 0) return cudaSuccess;
  if (K <= 0 || n_heads <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 0)
    return ptt::dispatch<float>(x, w, cos, sin, out, M, K, n_heads, D, S,
                                dtype, s);
  if (table_dtype == 1)
    return ptt::dispatch<ptt::bf16>(x, w, cos, sin, out, M, K, n_heads, D,
                                    S, dtype, s);
  return cudaErrorInvalidValue;
}

const char* matmul_rope_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
