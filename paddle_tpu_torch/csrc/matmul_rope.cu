// One q or k projection with the rotary embedding applied to its output
// tile: out[B, S, n_heads, D] = rope(round(x @ W)).
//
// Replaces the TPU kernel `_matmul_rope_k`
// (paddle_tpu/ops/pallas/fused_train.py, body `_mmr_kernel_body`).  A
// block owns a tile of rows times one head's D columns, so the rotation,
// which pairs column c with c +- D/2 inside the head, never leaves the
// block.  The product accumulates in f32 and is rounded to the input
// dtype; the tile then goes through shared memory, and every element is
// rotated in f32 against the f32 tables, y*cos + rotate_half(y)*sin with
// each product and the sum rounded as PyTorch rounds them (no FMA), and
// written once in the input dtype.  Each row takes its table row from its
// own position, row % S, so a tile may span a batch boundary.
//
// bf16: the product runs on the tensor cores with
// mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate).  Block tile 128
// rows x D columns, 8 warps (4 x 2, each 32 rows x D/2 columns), k steps
// of 32 through a 3-stage cp.async ring in shared memory (rows padded by
// 16 bytes so the ldmatrix reads are free of bank conflicts); A fragments
// come from ldmatrix, B fragments from ldmatrix.trans of the [k][n] tile.
// float32: the product runs on the FMA pipe in exact f32 (64 rows x D
// columns, 4 x D/16 outputs a thread), for the f32 reference checks.
//
// What bounds it on an H100: operations.  At the training shape, q is
// 2 x 8192 x 4096 x 4096 = 275 GFLOP (0.278 ms at 989 TFLOP/s) and k
// 68.7 GFLOP, against 64 MiB + 32 MiB of input and 64 MiB of output.
// Blocks walk the heads fastest, so one x tile serves every head from L2
// while it is hot and W (32 MiB for q) stays in the 50 MB L2.  mma.sync
// reaches a fraction of the wgmma rate; wgmma with TMA is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rotate the tile (rows m0.., columns of one head starting at col0) held
// in shared memory with row pitch PITCH, and write it out.
template <typename T, typename ST, int BM, int D, int PITCH>
__device__ __forceinline__ void rope_store(const ST* tile, T* out,
                                           const float* cos,
                                           const float* sin, int m0, int M,
                                           int S, int N, int col0) {
  constexpr int kHalf = D / 2;
  for (int idx = threadIdx.x; idx < BM * D; idx += blockDim.x) {
    const int rr = idx / D, c = idx % D;
    const int row = m0 + rr;
    if (row >= M) break;            // rows grow with idx: the rest are out
    const long long t = static_cast<long long>(row % S) * D + c;
    const float y = to_f(tile[rr * PITCH + c]);
    const float p = c < kHalf ? -to_f(tile[rr * PITCH + c + kHalf])
                              : to_f(tile[rr * PITCH + c - kHalf]);
    const float o = __fadd_rn(__fmul_rn(y, cos[t]), __fmul_rn(p, sin[t]));
    out[static_cast<long long>(row) * N + col0 + c] = from_f<T>(o);
  }
}

// ----------------------------------------------------------------- bf16

constexpr int kBM = 128, kBK = 32, kStages = 3, kThreads = 256;
constexpr int kAPitch = kBK + 8;       // bf16 elements a row of the A tile

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

template <int D> struct MmaTile {
  static constexpr int kBPitch = D + 8;       // bf16 elements a B row
  static constexpr int kA = kBM * kAPitch;
  static constexpr int kB = kBK * kBPitch;
  static constexpr int kStage = kA + kB;
  static constexpr int kSmemBytes = kStages * kStage * 2;
  static_assert(kBM * kBPitch <= kStages * kStage, "epilogue tile fits");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
matmul_rope_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ cos,
                 const float* __restrict__ sin, bf16* __restrict__ out,
                 int M, int K, int n_heads, int S) {
  using Tile = MmaTile<D>;
  constexpr int kBP = Tile::kBPitch;
  constexpr int kWN = D / 2;          // columns a warp owns
  constexpr int kNT = kWN / 8;        // n8 tiles a warp owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int N = n_heads * D;
  const int head = blockIdx.x % n_heads;
  const int m0 = (blockIdx.x / n_heads) * kBM;
  const int n0 = head * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;

  auto load_stage = [&](int stage, int k0) {
    bf16* sa = smem + stage * Tile::kStage;
    bf16* sb = sa + Tile::kA;
#pragma unroll
    for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + kc < K;
      cp_async16(sa + r * kAPitch + kc,
                 ok ? x + static_cast<long long>(m0 + r) * K + k0 + kc : x,
                 ok);
    }
#pragma unroll
    for (int c = tid; c < kBK * D / 8; c += kThreads) {
      const int r = c / (D / 8), nc = (c % (D / 8)) * 8;
      const bool ok = k0 + r < K;
      cp_async16(sb + r * kBP + nc,
                 ok ? w + static_cast<long long>(k0 + r) * N + n0 + nc : w,
                 ok);
    }
  };

  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s * kBK);
    cp_async_commit();                // an empty group keeps the count
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();     // k tile kt has landed
    __syncthreads();                  // ... for every thread; and the
                                      // stage refilled below is drained
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, next * kBK);
    cp_async_commit();
    const bf16* sa = smem + (kt % kStages) * Tile::kStage;
    const bf16* sb = sa + Tile::kA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[kNT][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], sa + (wm * 32 + mt * 16 + (lane & 15)) * kAPitch
                               + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t t[4];
        ldmatrix_x4_trans(t, sb + (kk + (lane & 15)) * kBP + wn * kWN
                                 + np * 16 + (lane >> 4) * 8);
        b[2 * np][0] = t[0];
        b[2 * np][1] = t[1];
        b[2 * np + 1][0] = t[2];
        b[2 * np + 1][1] = t[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring becomes the output tile

  // round the f32 sums to bf16 (the product's output dtype) into the tile
  bf16* tile = smem;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int r = wm * 32 + mt * 16 + g;
      const int c = wn * kWN + nt * 8 + t4 * 2;
      *reinterpret_cast<__nv_bfloat162*>(tile + r * kBP + c) =
          __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * kBP + c) =
          __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  rope_store<bf16, bf16, kBM, D, kBP>(tile, out, cos, sin, m0, M, S, N, n0);
}

template <int D>
cudaError_t launch_bf16(const void* x, const void* w, const float* cos,
                        const float* sin, void* out, int M, int K,
                        int n_heads, int S, cudaStream_t stream) {
  static bool configured = false;
  const int smem = MmaTile<D>::kSmemBytes;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_rope_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long blocks =
      static_cast<long long>((M + kBM - 1) / kBM) * n_heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  matmul_rope_bf16<D><<<static_cast<unsigned>(blocks), kThreads, smem,
                        stream>>>(static_cast<const bf16*>(x),
                                  static_cast<const bf16*>(w), cos, sin,
                                  static_cast<bf16*>(out), M, K, n_heads, S);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ f32

constexpr int kFM = 64, kFK = 16;

template <int D>
__global__ void __launch_bounds__(kThreads)
matmul_rope_f32(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ cos, const float* __restrict__ sin,
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
  rope_store<float, float, kFM, D, kCP>(tile, out, cos, sin, m0, M, S, N, n0);
}

template <int D>
cudaError_t launch_f32(const void* x, const void* w, const float* cos,
                       const float* sin, void* out, int M, int K,
                       int n_heads, int S, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>((M + kFM - 1) / kFM) * n_heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  matmul_rope_f32<D><<<static_cast<unsigned>(blocks), kThreads, 0,
                       stream>>>(static_cast<const float*>(x),
                                 static_cast<const float*>(w), cos, sin,
                                 static_cast<float*>(out), M, K, n_heads, S);
  return cudaGetLastError();
}

}  // namespace ptt

extern "C" {

// x [M, K] and w [K, n_heads * D] contiguous in one dtype (0 float32,
// 1 bfloat16), cos/sin [S, D] contiguous float32, out [M, n_heads * D]
// in x's dtype; row m takes table row m % S.  D is 64 or 128; bfloat16
// needs K % 8 == 0 and 16-byte aligned x and w.  Returns a cudaError_t.
int matmul_rope(const void* x, const void* w, const float* cos,
                const float* sin, void* out, int M, int K, int n_heads,
                int D, int S, int dtype, void* stream) {
  if (M <= 0) return cudaSuccess;
  if (K <= 0 || n_heads <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && K % 8 == 0) {
    if (D == 64) return ptt::launch_bf16<64>(x, w, cos, sin, out, M, K, n_heads, S, s);
    if (D == 128) return ptt::launch_bf16<128>(x, w, cos, sin, out, M, K, n_heads, S, s);
  }
  if (dtype == 0) {
    if (D == 64) return ptt::launch_f32<64>(x, w, cos, sin, out, M, K, n_heads, S, s);
    if (D == 128) return ptt::launch_f32<128>(x, w, cos, sin, out, M, K, n_heads, S, s);
  }
  return cudaErrorInvalidValue;
}

const char* matmul_rope_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
