// FlashAttention-2 forward with an additive mask, causal masking and GQA.
//
// Replaces the TPU kernel `_fwd_kernel` behind `_fwd`
// (paddle_tpu/ops/pallas/flash_attention.py) for the forward pass: the
// serving engine's synchronous prefill calls it once per layer and chunk
// with q [1, P, H, D] against the sequence's gathered pages and an f32
// additive position mask [1, 1, P, maxp * P].
//
// Grid (query tiles of 64 rows, H, B).  A block loads its 64 query rows
// once (pre-scaled by 1/sqrt(D)), then streams K/V tiles of 64 keys of kv
// head h / G through shared memory with an f32 online softmax
// (attention_tile.cuh).  The mask is added to the scaled score; causal
// masking maps query row i to key position off + i with off = Sk - Sq and
// stops the key loop after the block's last visible key.  Inputs are
// [B, S, H, D] with any batch/sequence/head strides (D contiguous), so
// the engine's gathered pages enter without a transposing copy; the
// output is contiguous [B, Sq, H, D] and the log-sum-exp [B, H, Sq] f32.
//
// What bounds it on an H100: operations.  At the prefill shape (Sq 128,
// Sk 2048, G 4 query heads per kv head) the work is 4 * Sq * Sk * D
// flops per head against 4 * Sk * D bytes of bf16 K/V per kv head — about
// 500 flops per byte, above the card's bf16 ridge of about 295.  This
// first revision runs the products on the f32 FMA pipe, far below the
// tensor-core rate; reading each K/V tile once per 64 query rows keeps
// the bytes near the minimum, and tensor cores (wgmma) are the next step.
#include "attention_tile.cuh"

namespace ptt {

template <typename T, int D>
struct FlashCtx {
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ mask,
          T* __restrict__ out, float* __restrict__ lse, int H, int KVH,
          int Sq, int Sk, long long qsb, long long qss, long long qsh,
          long long ksb, long long kss, long long ksh, long long vsb,
          long long vss, long long vsh, long long msb, long long msh,
          long long msq, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int row0 = blockIdx.x * BR;

  FlashCtx<T, D> ctx;
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* out, float* lse, int B, int H,
                   int KVH, int Sq, int Sk, const long long* st,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = Tile<T, D>::kBytes;
  static bool smem_set = false;
  cudaError_t e = allow_smem(flash_fwd<T, D>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BR - 1) / BR, H, B);
  flash_fwd<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, H, KVH, Sq,
      Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const float* mask, void* out, float* lse, int B,
                       int H, int KVH, int Sq, int Sk, const long long* st,
                       int causal, float scale, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, mask, out, lse, B, H, KVH, Sq, Sk, st,
                         causal, scale, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, mask, out, lse, B, H, KVH, Sq, Sk, st,
                          causal, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace ptt

extern "C" {

// strides (elements): q b/s/h, k b/s/h, v b/s/h, mask b/h/q (0 where the
// mask broadcasts); dtype: 0 float32, 1 bfloat16, 2 float16.
// Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const float* mask, void* out, float* lse, int B,
                        int H, int KVH, int Sq, int Sk, int D,
                        const long long* strides, int causal, float scale,
                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return ptt::dispatch_d<float>(D, q, k, v, mask, out, lse, B, H, KVH,
                                    Sq, Sk, strides, causal, scale, s);
    case 1:
      return ptt::dispatch_d<__nv_bfloat16>(D, q, k, v, mask, out, lse, B, H,
                                            KVH, Sq, Sk, strides, causal,
                                            scale, s);
    case 2:
      return ptt::dispatch_d<__half>(D, q, k, v, mask, out, lse, B, H, KVH,
                                     Sq, Sk, strides, causal, scale, s);
  }
  return cudaErrorInvalidValue;
}

const char* flash_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
