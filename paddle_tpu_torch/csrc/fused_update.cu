// Fused global-norm clip + optimizer update over one flat leaf, in place.
//
// Replaces the TPU kernel `_fused_update_kernel`
// (paddle_tpu/ops/pallas/fused_train.py), whose body is `_update_math`:
// SGD, Momentum (plain or Nesterov) and Adam with L2 decay or AdamW with
// decoupled decay.  One pass reads p (f32, bf16 or f16), g and the f32
// slots, computes in f32 exactly as `_update_math` does, op for op and
// without contraction into FMAs (the __f*_rn intrinsics), and writes p
// (rounded to nearest even into its dtype) and the slots back in place —
// the counterpart of the TPU kernel's input_output_aliases.  The clip
// scale is folded in as `_clip_fold_f32` does: g * scale rounded to g's
// dtype and back to f32, the rounding the unfused clip -> update chain
// makes.  lr, the step count and the clip scale arrive as a device f32[3]
// (the TPU kernel's SMEM scalars), so a train step never syncs the host;
// Adam's bias corrections are 1 - powf(beta, step) per thread.
//
// What bounds it on an H100: bytes.  Adam on bf16 parameters moves 22
// bytes per element (p 2 + 2, g 2, m 4 + 4, v 4 + 4) for about 20 flops;
// the design point is one read and one write of each, with 16-byte loads
// and stores (8 elements per thread per iteration) in a grid-stride loop.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

constexpr int kThreads = 256;
constexpr int kVec = 8;                 // elements per thread per iteration

enum Kind { kSgd = 0, kMomentum = 1, kAdam = 2 };

struct Hyper {
  float wd;          // weight decay (0: none)
  int decoupled;     // AdamW-style: new_p -= lr * wd * p
  float mu;          // momentum
  int nesterov;
  float b1, omb1;    // beta1, 1 - beta1 (rounded from double, as JAX does)
  float b2, omb2;
  float eps;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// 8 elements of T <-> f32, as 16-byte (2-byte types) or 2 x 16-byte
// (f32) accesses.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float out[kVec]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = to_f(e[i]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float in[kVec]) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(in[0], in[1], in[2], in[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(in[4], in[5], in[6], in[7]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < kVec; ++i) e[i] = from_f<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// `_update_math` on one element, op for op (no FMA contraction).
template <int KIND>
__device__ __forceinline__ void update_one(float& pf, float gf, float& s0,
                                           float& s1, float lr, float bc1,
                                           float bc2, const Hyper& hp) {
  if (hp.wd != 0.f && !hp.decoupled) gf = __fadd_rn(gf, __fmul_rn(hp.wd, pf));
  if (KIND == kSgd) {
    pf = __fsub_rn(pf, __fmul_rn(lr, gf));
  } else if (KIND == kMomentum) {
    const float v = __fadd_rn(__fmul_rn(hp.mu, s0), gf);
    s0 = v;
    if (hp.nesterov)
      pf = __fsub_rn(pf, __fmul_rn(lr, __fadd_rn(gf, __fmul_rn(hp.mu, v))));
    else
      pf = __fsub_rn(pf, __fmul_rn(lr, v));
  } else {
    const float m = __fadd_rn(__fmul_rn(hp.b1, s0), __fmul_rn(hp.omb1, gf));
    const float v = __fadd_rn(__fmul_rn(hp.b2, s1),
                              __fmul_rn(hp.omb2, __fmul_rn(gf, gf)));
    s0 = m;
    s1 = v;
    const float mhat = __fdiv_rn(m, bc1);
    const float vhat = __fdiv_rn(v, bc2);
    float np = __fsub_rn(pf, __fdiv_rn(__fmul_rn(lr, mhat),
                                       __fadd_rn(__fsqrt_rn(vhat), hp.eps)));
    if (hp.wd != 0.f && hp.decoupled)
      np = __fsub_rn(np, __fmul_rn(__fmul_rn(lr, hp.wd), pf));
    pf = np;
  }
}

template <int KIND, typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
fused_update(TP* __restrict__ p, const TG* __restrict__ g,
             float* __restrict__ s0, float* __restrict__ s1, long long n,
             const float* __restrict__ scal, int has_clip, Hyper hp) {
  const float lr = scal[0], step = scal[1], clip = scal[2];
  float bc1 = 1.f, bc2 = 1.f;
  if (KIND == kAdam) {
    bc1 = __fsub_rn(1.f, powf(hp.b1, step));
    bc2 = __fsub_rn(1.f, powf(hp.b2, step));
  }
  const long long nvec = n / kVec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long iv = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       iv < nvec; iv += stride) {
    const long long o = iv * kVec;
    float pf[kVec], gf[kVec], a[kVec], c[kVec];
    load8(p + o, pf);
    load8(g + o, gf);
    if (KIND != kSgd) load8(s0 + o, a);
    if (KIND == kAdam) load8(s1 + o, c);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float gi = gf[i];
      if (has_clip) gi = to_f(from_f<TG>(__fmul_rn(gi, clip)));
      update_one<KIND>(pf[i], gi, a[i], c[i], lr, bc1, bc2, hp);
    }
    store8(p + o, pf);
    if (KIND != kSgd) store8(s0 + o, a);
    if (KIND == kAdam) store8(s1 + o, c);
  }
  // the ragged tail (n % 8 elements), one thread each
  const long long i = nvec * kVec + (long long)blockIdx.x * blockDim.x +
                      threadIdx.x;
  if (i < n) {
    float pf = to_f(p[i]), gi = to_f(g[i]);
    float a = KIND != kSgd ? s0[i] : 0.f, c = KIND == kAdam ? s1[i] : 0.f;
    if (has_clip) gi = to_f(from_f<TG>(__fmul_rn(gi, clip)));
    update_one<KIND>(pf, gi, a, c, lr, bc1, bc2, hp);
    p[i] = from_f<TP>(pf);
    if (KIND != kSgd) s0[i] = a;
    if (KIND == kAdam) s1[i] = c;
  }
}

template <int KIND, typename TP, typename TG>
cudaError_t launch(void* p, const void* g, float* s0, float* s1, long long n,
                   const float* scal, int has_clip, const Hyper& hp,
                   cudaStream_t stream) {
  const long long nvec = n / kVec;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  fused_update<KIND, TP, TG><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<TP*>(p), static_cast<const TG*>(g), s0, s1, n, scal,
      has_clip, hp);
  return cudaGetLastError();
}

template <int KIND, typename TP>
cudaError_t by_grad(int g_dtype, void* p, const void* g, float* s0,
                    float* s1, long long n, const float* scal, int has_clip,
                    const Hyper& hp, cudaStream_t s) {
  switch (g_dtype) {
    case 0: return launch<KIND, TP, float>(p, g, s0, s1, n, scal, has_clip, hp, s);
    case 1: return launch<KIND, TP, __nv_bfloat16>(p, g, s0, s1, n, scal, has_clip, hp, s);
    case 2: return launch<KIND, TP, __half>(p, g, s0, s1, n, scal, has_clip, hp, s);
  }
  return cudaErrorInvalidValue;
}

template <int KIND>
cudaError_t by_param(int p_dtype, int g_dtype, void* p, const void* g,
                     float* s0, float* s1, long long n, const float* scal,
                     int has_clip, const Hyper& hp, cudaStream_t s) {
  switch (p_dtype) {
    case 0: return by_grad<KIND, float>(g_dtype, p, g, s0, s1, n, scal, has_clip, hp, s);
    case 1: return by_grad<KIND, __nv_bfloat16>(g_dtype, p, g, s0, s1, n, scal, has_clip, hp, s);
    case 2: return by_grad<KIND, __half>(g_dtype, p, g, s0, s1, n, scal, has_clip, hp, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace ptt

extern "C" {

// kind: 0 sgd, 1 momentum, 2 adam; dtypes: 0 float32, 1 bfloat16,
// 2 float16.  p, g, s0 (velocity or moment1), s1 (moment2) are flat,
// contiguous, 16-byte aligned, n elements each (unused slots may be null);
// scal: device f32 [lr, step, clip scale].  Returns a cudaError_t.
int fused_update(int kind, int p_dtype, int g_dtype, void* p, const void* g,
                 float* s0, float* s1, long long n, const float* scal,
                 int has_clip, float wd, int decoupled, float mu,
                 int nesterov, float b1, float omb1, float b2, float omb2,
                 float eps, void* stream) {
  if (n <= 0) return cudaSuccess;
  const ptt::Hyper hp{wd, decoupled, mu, nesterov, b1, omb1, b2, omb2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case ptt::kSgd:
      return ptt::by_param<ptt::kSgd>(p_dtype, g_dtype, p, g, s0, s1, n, scal, has_clip, hp, s);
    case ptt::kMomentum:
      return ptt::by_param<ptt::kMomentum>(p_dtype, g_dtype, p, g, s0, s1, n, scal, has_clip, hp, s);
    case ptt::kAdam:
      return ptt::by_param<ptt::kAdam>(p_dtype, g_dtype, p, g, s0, s1, n, scal, has_clip, hp, s);
  }
  return cudaErrorInvalidValue;
}

const char* fused_update_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
