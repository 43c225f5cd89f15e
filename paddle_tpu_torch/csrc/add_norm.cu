// Fused residual add + RMSNorm or LayerNorm over the last axis.
//
// Replaces the TPU kernel `_add_norm_call`
// (paddle_tpu/ops/pallas/fused_train.py) with its two bodies,
// `_add_rms_kernel_body` and `_add_ln_kernel_body`: for every row,
// h = r + x in x's dtype, then y = norm(h) * w (+ b).  The roundings are
// the plain version's (`add_rms_norm_reference`,
// `add_layer_norm_reference` in ops/fused_train.py): statistics in f32,
// the normalised value rounded to h's dtype, then the scale (and the
// shift) applied in the promoted output dtype, each step rounded as
// PyTorch rounds it.  The products and sums of those steps use the
// __f*_rn intrinsics so that nvcc contracts none of them into an FMA.
//
// One block of 256 threads per row.  A row of up to 8192 elements lives
// in registers (at most 32 a thread), so x and r are read once and h and
// y written once; the block reduces its sums with warp shuffles.  With
// H % 8 == 0 and 16-byte aligned operands each thread moves 8 elements a
// load (16 bytes of bf16); otherwise one element at a time.
//
// What bounds it on an H100: bytes.  At the training shape (8192 rows of
// 4096 bf16) it reads x and r and writes h and y, 4 x 64 MiB, for about
// 6 flops an element: 0.080 ms at 3.35 TB/s.  The design point is that
// single pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {

constexpr int kThreads = 256;
constexpr int kMaxH = 8192;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: the value a T tensor holds
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int VEC> struct Io;

template <> struct Io<1> {
  template <typename T>
  __device__ static void load(const T* p, float* f) { f[0] = to_f(*p); }
  template <typename T>
  __device__ static void store(T* p, const float* f) { *p = from_f<T>(f[0]); }
};

template <> struct Io<8> {
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static void load(const float* p, float* f) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  __device__ static void store(__nv_bfloat16* p, const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
  __device__ static void store(float* p, const float* f) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

// the sum of v over the block, in every thread
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                       // red may hold an earlier sum
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < kThreads / 32 ? red[threadIdx.x & 31] : 0.f;
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// T: x, r and h; W: weight and bias; O: y (the promoted dtype)
template <typename T, typename W, typename O, bool LN, bool BIAS, int VEC>
__global__ void __launch_bounds__(kThreads)
add_norm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                const W* __restrict__ w, const W* __restrict__ b,
                T* __restrict__ h, O* __restrict__ y, int H, float eps) {
  constexpr int kIters = kMaxH / (kThreads * VEC);
  __shared__ float red[kThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * H;
  float v[kIters][VEC];
  float acc = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = (it * kThreads + threadIdx.x) * VEC;
    if (i < H) {
      float a[VEC], c[VEC];
      Io<VEC>::load(x + base + i, a);
      Io<VEC>::load(r + base + i, c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[it][j] = round_to<T>(__fadd_rn(c[j], a[j]));    // h = r + x
        acc += LN ? v[it][j] : v[it][j] * v[it][j];
      }
      Io<VEC>::store(h + base + i, v[it]);
    }
  }
  const float inv_h = 1.f / static_cast<float>(H);
  float mean = 0.f;
  float stat = block_sum(acc, red);
  if (LN) {
    mean = stat * inv_h;
    float acc2 = 0.f;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = (it * kThreads + threadIdx.x) * VEC;
      if (i < H) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = v[it][j] - mean;
          acc2 += d * d;
        }
      }
    }
    stat = block_sum(acc2, red);
  }
  const float rstd = rsqrtf(stat * inv_h + eps);
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = (it * kThreads + threadIdx.x) * VEC;
    if (i < H) {
      float wf[VEC], bf[VEC], o[VEC];
      Io<VEC>::load(w + i, wf);
      if (BIAS) Io<VEC>::load(b + i, bf);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float n = LN ? __fmul_rn(__fsub_rn(v[it][j], mean), rstd)
                           : __fmul_rn(v[it][j], rstd);
        o[j] = round_to<O>(__fmul_rn(round_to<T>(n), wf[j]));
        if (BIAS) o[j] = round_to<O>(__fadd_rn(o[j], bf[j]));
      }
      Io<VEC>::store(y + base + i, o);
    }
  }
}

template <typename T, typename W, bool LN, bool BIAS, int VEC>
cudaError_t launch(const void* x, const void* r, const void* w,
                   const void* b, void* h, void* y, long long rows, int H,
                   float eps, cudaStream_t s) {
  // y is bf16 only when both operands are: torch.promote_types
  using O = typename std::conditional<
      std::is_same<T, __nv_bfloat16>::value &&
          std::is_same<W, __nv_bfloat16>::value,
      __nv_bfloat16, float>::type;
  add_norm_kernel<T, W, O, LN, BIAS, VEC>
      <<<static_cast<unsigned>(rows), kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(r),
          static_cast<const W*>(w), static_cast<const W*>(b),
          static_cast<T*>(h), static_cast<O*>(y), H, eps);
  return cudaGetLastError();
}

template <typename T, typename W, bool LN, bool BIAS>
cudaError_t by_vec(int vec, const void* x, const void* r, const void* w,
                   const void* b, void* h, void* y, long long rows, int H,
                   float eps, cudaStream_t s) {
  if (vec == 8)
    return launch<T, W, LN, BIAS, 8>(x, r, w, b, h, y, rows, H, eps, s);
  return launch<T, W, LN, BIAS, 1>(x, r, w, b, h, y, rows, H, eps, s);
}

template <typename T, typename W>
cudaError_t by_body(int ln, int has_bias, int vec, const void* x,
                    const void* r, const void* w, const void* b, void* h,
                    void* y, long long rows, int H, float eps,
                    cudaStream_t s) {
  if (!ln) return by_vec<T, W, false, false>(vec, x, r, w, b, h, y, rows, H, eps, s);
  if (has_bias) return by_vec<T, W, true, true>(vec, x, r, w, b, h, y, rows, H, eps, s);
  return by_vec<T, W, true, false>(vec, x, r, w, b, h, y, rows, H, eps, s);
}

}  // namespace ptt

extern "C" {

// ln: 0 RMSNorm, 1 LayerNorm (b may be null: no bias).  dtypes: 0 float32,
// 1 bfloat16; x, r, h share x_dtype, w and b share w_dtype, y is
// bfloat16 when both are, else float32.  All operands contiguous; rows of
// H <= 8192 elements; vec 8 needs H % 8 == 0 and 16-byte aligned
// pointers, vec 1 takes anything.  Returns a cudaError_t.
int add_norm(int ln, const void* x, const void* r, const void* w,
             const void* b, void* h, void* y, long long rows, int H,
             float eps, int x_dtype, int w_dtype, int vec, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (H <= 0 || H > ptt::kMaxH || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hb = b != nullptr;
  if (x_dtype == 0 && w_dtype == 0)
    return ptt::by_body<float, float>(ln, hb, vec, x, r, w, b, h, y, rows, H, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return ptt::by_body<float, __nv_bfloat16>(ln, hb, vec, x, r, w, b, h, y, rows, H, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return ptt::by_body<__nv_bfloat16, float>(ln, hb, vec, x, r, w, b, h, y, rows, H, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return ptt::by_body<__nv_bfloat16, __nv_bfloat16>(ln, hb, vec, x, r, w, b, h, y, rows, H, eps, s);
  return cudaErrorInvalidValue;
}

const char* add_norm_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
