// Single-token paged attention for the split decode path: kernel #7
// (append + attend) and kernel #6 (attend only).
//
// Replaces the TPU kernels `_decode_append_kernel` behind
// `paged_decode_append_attend_raw` and `_decode_kernel` behind
// `paged_attention_raw` (paddle_tpu/ops/pallas/paged_attention.py).
// One block per (sequence b, kv head): with `append` it first writes the
// sequence's new K/V row at position lens[b] (in int8 mode quantized in
// the block, int8_kv.cuh: codes and the per-token scale), then, after
// __syncthreads, its G query heads attend over lens[b] (+ 1) tokens,
// streaming the sequence's pages.  A sequence with no token to attend
// (#6, lens == 0) gets zeros.  Pad rows of the engine's batch carry
// table 0 and length 0: they append into the reserved pad page 0, which
// no live row reads.
//
// What bounds it on an H100: bytes.  Each (sequence, kv head) reads its
// K and V pages once (2 * len * D elements) for G query rows, so there
// are about 2G flops a byte read.  The design keeps every byte read once,
// with 16-byte loads: a key row is split over L = D * sizeof(pool) / 16
// lanes, so a warp reads 32 / L keys at a time, and the 8 warps of a
// block take interleaved keys.  Each lane keeps the online-softmax state
// of its keys (running max, sum, and its slice of the G accumulators) in
// registers; the lanes of a warp and then the warps merge their states
// at the end (shuffles, then shared memory).  Int8 pages dequantize in
// registers: the K scale multiplies the score, the V scale folds into the
// probability, as the TPU kernel does.  Scores and products are f32
// FMAs (no tensor cores: G <= 8 rows a block).  No split of a sequence
// over several blocks yet: B * KVH blocks (64 at the Llama serving
// shape) leave most SMs idle, which PERF.md records.
#include <type_traits>

#include "attention_tile.cuh"
#include "int8_kv.cuh"

namespace ptt {

constexpr int DEC_NT = 256;
constexpr int DEC_NW = DEC_NT / 32;

template <typename TQ, typename TP, int D, int G>
__global__ void __launch_bounds__(DEC_NT)
paged_decode(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
             const TQ* __restrict__ v_new, TP* k_pages, TP* v_pages,
             float* k_scales, float* v_scales, const int* __restrict__ tables,
             const int* __restrict__ lens, TQ* __restrict__ out, int H,
             int KVH, int n_pages, int P, int maxp, float scale, int append) {
  constexpr bool INT8 = std::is_same<TP, int8_t>::value;
  constexpr int VEC = 16 / (int)sizeof(TP);   // pool elements per lane
  constexpr int L = D / VEC;                   // lanes per key row
  constexpr int KPW = 32 / L;                  // keys per warp step
  __shared__ float sm_m[DEC_NW][G], sm_l[DEC_NW][G];
  __shared__ float sm_acc[DEC_NW][G][D];

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* table = tables + (size_t)b * maxp;
  int len = lens[b];

  if (append) {
    const int pos = len;
    const int page = pos / P < maxp ? table[pos / P] : -1;
    if (warp < 2 && page >= 0 && page < n_pages) {
      const size_t row = ((size_t)kvh * n_pages + page) * P + pos % P;
      const TQ* src = (warp == 0 ? k_new : v_new) + ((size_t)b * KVH + kvh) * D;
      TP* dst = (warp == 0 ? k_pages : v_pages) + row * D;
      if constexpr (INT8) {
        quantize_row_warp<TQ, D>(src, dst, (warp == 0 ? k_scales : v_scales) + row,
                                 lane);
      } else {
        for (int i = lane; i < D; i += 32) dst[i] = src[i];
      }
    }
    len += 1;
    __syncthreads();   // the appended row is read below by other warps
  }

  const int sub = lane / L, cl = lane % L;
  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const TQ* qr = q + ((size_t)b * H + kvh * G + g) * D + cl * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) qv[g][i] = elem_f(qr[i]) * scale;
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  for (int t0 = 0; t0 < len; t0 += DEC_NW * KPW) {
    const int t = t0 + warp * KPW + sub;
    const int page = (t < len && t / P < maxp) ? table[t / P] : -1;
    const bool valid = page >= 0 && page < n_pages;
    float kf[VEC], vf[VEC];
    float ks = 1.f, vs = 1.f;
    if (valid) {
      const size_t row = ((size_t)kvh * n_pages + page) * P + t % P;
      const uint4 ku = *reinterpret_cast<const uint4*>(k_pages + row * D + cl * VEC);
      const uint4 vu = *reinterpret_cast<const uint4*>(v_pages + row * D + cl * VEC);
      unpack16<TP>(ku, kf);
      unpack16<TP>(vu, vf);
      if constexpr (INT8) {
        ks = k_scales[row];
        vs = v_scales[row];
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
    }
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[g] = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) s[g] = fmaf(qv[g][i], kf[i], s[g]);
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
    if (valid) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float sg = s[g] * ks;
        const float mn = fmaxf(m[g], sg);
        const float alpha = expf(m[g] - mn);
        const float p = expf(sg - mn);
        l[g] = l[g] * alpha + p;
        const float pv = p * vs;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(pv, vf[i], acc[g][i] * alpha);
        m[g] = mn;
      }
    }
  }

  // merge the lane groups of the warp (the same columns, other keys)
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float a = m[g] == -INFINITY ? 0.f : expf(m[g] - mn);
      const float c = mo == -INFINITY ? 0.f : expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        acc[g][i] = acc[g][i] * a + ao * c;
      }
      m[g] = mn;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][g][cl * VEC + i] = acc[g][i];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps; a row that saw no key writes zeros
  for (int idx = threadIdx.x; idx < G * D; idx += DEC_NT) {
    const int g = idx / D, c = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < DEC_NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < DEC_NW; ++w) {
        const float e = sm_m[w][g] == -INFINITY ? 0.f : expf(sm_m[w][g] - mx);
        lsum += sm_l[w][g] * e;
        a += sm_acc[w][g][c] * e;
      }
    }
    out[((size_t)b * H + kvh * G + g) * D + c] = from_f<TQ>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename TQ, typename TP, int D, int G>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_pages, void* v_pages, float* k_scales,
                   float* v_scales, const int* tables, const int* lens,
                   void* out, int B, int H, int KVH, int n_pages, int P,
                   int maxp, float scale, int append, cudaStream_t stream) {
  paged_decode<TQ, TP, D, G><<<dim3(B, KVH), DEC_NT, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k_new),
      static_cast<const TQ*>(v_new), static_cast<TP*>(k_pages),
      static_cast<TP*>(v_pages), k_scales, v_scales, tables, lens,
      static_cast<TQ*>(out), H, KVH, n_pages, P, maxp, scale, append);
  return cudaGetLastError();
}

template <typename TQ, typename TP, int D>
cudaError_t dispatch_g(int G, const void* q, const void* k_new,
                       const void* v_new, void* k_pages, void* v_pages,
                       float* k_scales, float* v_scales, const int* tables,
                       const int* lens, void* out, int B, int H, int KVH,
                       int n_pages, int P, int maxp, float scale, int append,
                       cudaStream_t st) {
#define PTT_DEC_CASE(GG)                                                      \
  case GG:                                                                    \
    return launch<TQ, TP, D, GG>(q, k_new, v_new, k_pages, v_pages, k_scales, \
                                 v_scales, tables, lens, out, B, H, KVH,      \
                                 n_pages, P, maxp, scale, append, st);
  switch (G) {
    PTT_DEC_CASE(1)
    PTT_DEC_CASE(2)
    PTT_DEC_CASE(4)
    PTT_DEC_CASE(8)
  }
#undef PTT_DEC_CASE
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TP>
cudaError_t dispatch_d(int D, int G, const void* q, const void* k_new,
                       const void* v_new, void* k_pages, void* v_pages,
                       float* k_scales, float* v_scales, const int* tables,
                       const int* lens, void* out, int B, int H, int KVH,
                       int n_pages, int P, int maxp, float scale, int append,
                       cudaStream_t st) {
  if (D == 64)
    return dispatch_g<TQ, TP, 64>(G, q, k_new, v_new, k_pages, v_pages,
                                  k_scales, v_scales, tables, lens, out, B, H,
                                  KVH, n_pages, P, maxp, scale, append, st);
  if (D == 128)
    return dispatch_g<TQ, TP, 128>(G, q, k_new, v_new, k_pages, v_pages,
                                   k_scales, v_scales, tables, lens, out, B, H,
                                   KVH, n_pages, P, maxp, scale, append, st);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t dispatch_pool(int int8, int D, int G, const void* q,
                          const void* k_new, const void* v_new, void* k_pages,
                          void* v_pages, float* k_scales, float* v_scales,
                          const int* tables, const int* lens, void* out, int B,
                          int H, int KVH, int n_pages, int P, int maxp,
                          float scale, int append, cudaStream_t st) {
  if (int8)
    return dispatch_d<TQ, int8_t>(D, G, q, k_new, v_new, k_pages, v_pages,
                                  k_scales, v_scales, tables, lens, out, B, H,
                                  KVH, n_pages, P, maxp, scale, append, st);
  return dispatch_d<TQ, TQ>(D, G, q, k_new, v_new, k_pages, v_pages, k_scales,
                            v_scales, tables, lens, out, B, H, KVH, n_pages, P,
                            maxp, scale, append, st);
}

}  // namespace ptt

extern "C" {

// dtype (q, new rows, out): 0 float32, 1 bfloat16, 2 float16.  int8: the
// pools are int8 with f32 scale pools (else float pools in q's dtype).
// append: 1 for kernel #7 (k_new/v_new appended first), 0 for #6.
// Returns a cudaError_t.
int paged_decode_attention(const void* q, const void* k_new, const void* v_new,
                           void* k_pages, void* v_pages, float* k_scales,
                           float* v_scales, const int* tables, const int* lens,
                           void* out, int B, int H, int KVH, int n_pages,
                           int P, int D, int maxp, float scale, int dtype,
                           int int8, int append, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  const int G = H / KVH;
  switch (dtype) {
    case 0:
      return ptt::dispatch_pool<float>(int8, D, G, q, k_new, v_new, k_pages,
                                       v_pages, k_scales, v_scales, tables,
                                       lens, out, B, H, KVH, n_pages, P, maxp,
                                       scale, append, st);
    case 1:
      return ptt::dispatch_pool<__nv_bfloat16>(
          int8, D, G, q, k_new, v_new, k_pages, v_pages, k_scales, v_scales,
          tables, lens, out, B, H, KVH, n_pages, P, maxp, scale, append, st);
    case 2:
      return ptt::dispatch_pool<__half>(int8, D, G, q, k_new, v_new, k_pages,
                                        v_pages, k_scales, v_scales, tables,
                                        lens, out, B, H, KVH, n_pages, P, maxp,
                                        scale, append, st);
  }
  return cudaErrorInvalidValue;
}

const char* paged_decode_attention_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
