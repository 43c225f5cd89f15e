// Single-token paged attention for the split decode path: kernel #7
// (append + attend) and kernel #6 (attend only).
//
// Replaces the TPU kernels `_decode_append_kernel` behind
// `paged_decode_append_attend_raw` and `_decode_kernel` behind
// `paged_attention_raw` (paddle_tpu/ops/pallas/paged_attention.py): row
// b's G query heads of kv head h attend over the first lens[b] (+ 1
// with append) tokens of its sequence's pages.  With `append` the row's
// new K/V is first written at position lens[b] (cast to the pool type,
// round to nearest even as Tensor.to does, or in int8 mode quantized
// per token, int8_kv.cuh: codes and scale bit for bit as the plain
// version), and the query attends the row as the pool then holds it.
// A row with no token to attend (#6, lens == 0) gets zeros.  Pad rows
// of the engine's batch carry table 0 and length 0: they append into
// the reserved pad page 0, which no live row reads.
//
// What bounds it on an H100: bytes.  Each (row, kv head) reads its K and
// V tokens once (2 len D elements) for G <= 8 query heads: about 2G
// flops a byte, far below the FMA pipe's ridge, so the math stays on
// the FMA pipe and the design is about keeping enough bytes in flight.
// At the serving shape (8 rows of 0-2047 keys, 8 kv heads) there are 64
// (row, kv head) pairs for 132 SMs, and the longest row alone is 2048
// keys: the first design, a block a pair walking its keys in dependent
// 16-key steps, took 15x its bound (0.104 ms, PERF.md).
//
// Design (`paged_decode_split`, flash-decoding): a block takes one span
// of SPAN keys (128; 64 for f32 pools at D 128) of one (row, kv head);
// the grid is (ceil(maxp P / SPAN), KVH, B) from host-known bounds, and
// a block past its row's keys exits at once (the host reads no length).
//   1. The block whose span holds position lens[b] appends the new row
//      (#7), fences it (for the async proxy too) and syncs.  Then warp 0
//      issues TMA bulk copies of the span's K and V rows (and int8
//      scales) into shared memory, one a run of rows on one page (a
//      128-key span of 128-key pages: one 32 KB copy each of K and V),
//      K's bytes on one mbarrier and V's on another, while every lane
//      loads q, scaled, into registers.  The scores start when K is in,
//      while V still comes.  (Copies of a lane's 16-byte chunks by
//      cp.async, all issued at once, took 0.0231 ms against the bulk
//      copies' 0.0194 at the serving shape: PERF.md.)
//   2. Scores: a lane takes VEC = min(8, 16 / sizeof(pool)) elements of
//      a key row, a row is L = D / VEC lanes and a lane group takes KL
//      keys; a key's G partial dot products are summed over the group's
//      lanes by a reduce-scatter (G - 1 + log2(L / G) shuffles where
//      G <= L), and the scores (x the key's scale in int8) land in
//      shared memory.
//   3. A warp a query head: the span's max and sum, probabilities in
//      place.  4. P V: a lane group its keys' V chunks (x the value's
//      scale in int8), summed over the warp's groups by shuffles and over
//      the warps in shared memory (the K area, free by then).
//   5. A row of one span writes its output normalised.  With several,
//      each span writes its unnormalised f32 sums and (max, sum) to the
//      wrapper's scratch, fences them and counts itself on the (row, kv
//      head) counter; the block that counts last merges the spans in
//      span order (the same bits whichever block merges, on every
//      launch): each output keeps a running max, numerator and
//      denominator over the spans, with the loads of 8 spans in flight
//      together.  It resets the counter to 0.  The counters are
//      a buffer the wrapper keeps per device, zeroed once when it is
//      allocated: every launch leaves them zero, so no launch zeroes
//      them.
//
// Mixed-dtype mode: float pools of another float type TP than q's TQ
// (the serving benches run f32 q over bf16 pools).  The pools' rows come
// by the same bulk copies in TP; q is widened to f32 before the scale;
// output in q's type.  Scores, sums and the softmax are f32 in every
// mode.
#include <type_traits>

#include "attention_wgmma.cuh"
#include "int8_kv.cuh"
#include "tma_ring.cuh"

namespace ptt {
namespace pd {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 128;           // keys a span aims at

// The geometry of pool type TP at head dim D: VEC elements a lane's chunk
// of a key row (at most 8, so q's G x VEC registers stay few; 8 bytes
// of int8 codes, 16 of a float type), L lanes a key row, NG lane groups
// a block, KL keys a group (at most 8), SPAN keys a block.
template <typename TP, int D>
struct Geo {
  static constexpr int VEC = 16 / (int)sizeof(TP) < 8 ? 16 / (int)sizeof(TP)
                                                      : 8;
  static constexpr int CB = VEC * (int)sizeof(TP);   // bytes a chunk
  static constexpr int L = D / VEC;
  static constexpr int NG = kThreads / L;
  static constexpr int KL = kSpan / NG < 8 ? kSpan / NG : 8;
  static constexpr int SPAN = NG * KL;
  static constexpr int ROW = D * (int)sizeof(TP);    // bytes a key row
  static_assert(L <= 32 && KL >= 1, "a key row fits a warp");
};

// Shared memory of one instantiation: the K rows (then the warps'
// partial P V sums), the V rows, the int8 scales, scores.
template <typename TP, int D, int G>
struct Smem {
  using Ge = Geo<TP, D>;
  static constexpr int KB = Ge::SPAN * Ge::ROW;
  static constexpr int ACC = kWarps * G * D * 4;
  static constexpr int A = KB > ACC ? KB : ACC;
  static constexpr int VOFF = A, SCOFF = VOFF + KB;
  static constexpr int SSOFF = SCOFF + 2 * Ge::SPAN * 4;
  static constexpr size_t kBytes = SSOFF + (size_t)G * Ge::SPAN * 4;
};

template <typename TQ, typename TP>
struct Args {
  const TQ *q, *k_new, *v_new;
  TP *k_pages, *v_pages;
  float *k_scales, *v_scales;
  const int *tables, *lens;
  TQ* out;
  float* part;           // [B, KVH, nsp, G, D] sums, then [.., G] (m, l)
  int* counters;         // [B, KVH], zero between launches
  int B, H, KVH, n_pages, P, maxp, nsp;
  float scale;
  int append;
};

// Sums v[0, N0) over the L lanes of a lane group (xor offsets below
// O * 2 = L): a reduce-scatter, the lane with bit O set keeping the
// upper half at each step while halves remain, then plain sums.  After
// it the lane holds the sums of entries [(cl >> R) NF, (cl >> R) NF +
// NF) in v[0, NF), NF = max(1, N0 / L), R = log2(max(1, L / N0)).
template <int N0, int N, int O>
__device__ __forceinline__ void group_sum(float (&v)[N0], int cl) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = (cl & O) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      group_sum<N0, N / 2, O / 2>(v, cl);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      group_sum<N0, 1, O / 2>(v, cl);
    }
  }
}

// Blocks an SM is asked to hold (the register cap ptxas works to): q's
// G x VEC registers a lane set it, three blocks where they are few (the
// shared memory of a 128-key span of 16-bit pools holds three).
template <typename TP, int G>
__host__ __device__ constexpr int min_blocks() {
  return G * Geo<TP, 128>::VEC <= 32 ? 3 : G * Geo<TP, 128>::VEC <= 64 ? 2 : 1;
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing its bytes on the barrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Adds bytes to the barrier's expected transfer count (no arrival).
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// A lane's chunk of a key row in shared memory, widened to f32.
template <typename TP, int VEC>
__device__ __forceinline__ void load_chunk(const unsigned char* p,
                                           float (&f)[VEC]) {
  if constexpr (VEC * sizeof(TP) == 16) {
    unpack16<TP>(*reinterpret_cast<const uint4*>(p), f);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const TP* e = reinterpret_cast<const TP*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = elem_f(e[i]);
  }
}

// VEC elements of q from p, widened to f32 and scaled, in 16- or 8-byte
// loads.
template <typename TQ, int VEC>
__device__ __forceinline__ void load_scaled(const TQ* p, float scale,
                                            float (&out)[VEC]) {
  constexpr int BYTES = VEC * (int)sizeof(TQ);
  constexpr int W = BYTES % 16 == 0 ? 16 : 8;     // bytes a load
  static_assert(BYTES % W == 0, "q chunk of whole loads");
  constexpr int E = W / (int)sizeof(TQ);          // elements a load
#pragma unroll
  for (int k = 0; k < BYTES / W; ++k) {
    if constexpr (W == 16) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[k];
      const TQ* e = reinterpret_cast<const TQ*>(&u);
#pragma unroll
      for (int i = 0; i < E; ++i) out[k * E + i] = elem_f(e[i]) * scale;
    } else {
      const uint2 u = reinterpret_cast<const uint2*>(p)[k];
      const TQ* e = reinterpret_cast<const TQ*>(&u);
#pragma unroll
      for (int i = 0; i < E; ++i) out[k * E + i] = elem_f(e[i]) * scale;
    }
  }
}

template <typename TQ, typename TP, int D, int G>
__global__ void __launch_bounds__(kThreads, (min_blocks<TP, G>()))
paged_decode_split(const Args<TQ, TP> a) {
  using Ge = Geo<TP, D>;
  using Sm = Smem<TP, D, G>;
  constexpr bool INT8 = std::is_same<TP, int8_t>::value;
  constexpr int VEC = Ge::VEC, L = Ge::L, NG = Ge::NG, KL = Ge::KL;
  constexpr int SPAN = Ge::SPAN, ROW = Ge::ROW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sacc = reinterpret_cast<float*>(smem);            // after scores
  float* ssc = reinterpret_cast<float*>(smem + Sm::SCOFF); // k, v scales
  float* ss = reinterpret_cast<float*>(smem + Sm::SSOFF);  // [SPAN][G]
  __shared__ float sm_m[G], sm_l[G];
  __shared__ int last;

  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = a.lens[b] + a.append;             // keys attended
  const int nsplit = max(1, (len + SPAN - 1) / SPAN);
  if (sp >= nsplit) return;
  const int t0 = sp * SPAN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* table = a.tables + (size_t)b * a.maxp;
  const size_t bk = (size_t)b * a.KVH + kvh;

  // 1. the append, in the block whose span holds it
  if (a.append && len - 1 >= t0 && len - 1 < t0 + SPAN) {
    const int pos = len - 1;
    const int page = pos / a.P < a.maxp ? table[pos / a.P] : -1;
    if (warp < 2 && page >= 0 && page < a.n_pages) {
      const size_t row = ((size_t)kvh * a.n_pages + page) * a.P + pos % a.P;
      const TQ* src = (warp == 0 ? a.k_new : a.v_new) + bk * D;
      TP* dst = (warp == 0 ? a.k_pages : a.v_pages) + row * D;
      if constexpr (INT8) {
        quantize_row_warp<TQ, D>(src, dst,
                                 (warp == 0 ? a.k_scales : a.v_scales) + row,
                                 lane);
      } else {
        for (int i = lane; i < D; i += 32) dst[i] = from_f<TP>(elem_f(src[i]));
      }
      __threadfence();
      // the bulk copies below read it through the async proxy
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
    }
    __syncthreads();             // the copies below read the new row
  }

  // the span's K and V rows (and int8 scales) into shared memory by TMA
  // bulk copies, a run of rows on one page each, K's on one barrier and
  // V's on the other: warp 0, a lane a run (each copy's bytes expected
  // before lane 0 arrives); int8 scale runs rounded up to 4 keys (16
  // bytes; P % 4 == 0 keeps them on the page).  Rows past the row's end
  // or off its pages are not copied: their keys are masked below.
  const int sub = lane / L, cl = lane % L, grp = warp * (32 / L) + sub;
  const uint32_t sbase = wg::smem_addr(smem);
  __shared__ __align__(8) unsigned long long bars[2];
  const uint32_t bar = wg::smem_addr(bars);
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    const int t_end = min(min(t0 + SPAN, len), a.maxp * a.P);
    const int p0 = t0 / a.P;
    const int runs = t_end > t0 ? (t_end - 1) / a.P - p0 + 1 : 0;
    for (int l = lane; l < runs; l += 32) {
      const int s0 = max(t0, (p0 + l) * a.P);
      const int n = min((p0 + l + 1) * a.P, t_end) - s0, off = s0 - t0;
      const int page = table[p0 + l];
      if (page < 0 || page >= a.n_pages) continue;
      const size_t row = ((size_t)kvh * a.n_pages + page) * a.P + s0 % a.P;
      const int sb = INT8 ? ((n + 3) & ~3) * 4 : 0;
      mbar_expect(bar, n * ROW + sb);
      mbar_expect(bar + 8, n * ROW + sb);
      bulk_copy(sbase + off * ROW, a.k_pages + row * D, n * ROW, bar);
      bulk_copy(sbase + Sm::VOFF + off * ROW, a.v_pages + row * D, n * ROW,
                bar + 8);
      if constexpr (INT8) {
        bulk_copy(sbase + Sm::SCOFF + off * 4, a.k_scales + row, sb, bar);
        bulk_copy(sbase + Sm::SCOFF + (SPAN + off) * 4, a.v_scales + row,
                  sb, bar + 8);
      }
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(bar);
      mbar_arrive(bar + 8);
    }
  }
  bool ok[KL];                           // the group's keys attended
#pragma unroll
  for (int j = 0; j < KL; ++j) {
    const int t = t0 + grp + NG * j;
    const int page = (t < len && t / a.P < a.maxp) ? table[t / a.P] : -1;
    ok[j] = page >= 0 && page < a.n_pages;
  }

  // q, scaled, in registers: lane cl's chunk of each head
  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_scaled<TQ, VEC>(a.q + ((size_t)b * a.H + kvh * G + g) * D + cl * VEC,
                         a.scale, qv[g]);

  // 2. scores of the group's keys grp + NG j: a key's G partial dots,
  // summed over the group's lanes; a key past the row's end scores -inf
  {
    constexpr int NF = G / L > 0 ? G / L : 1;     // sums a lane holds
    constexpr int RD = L / G > 1 ? L / G : 1;     // lanes holding each
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      if (j == 0) mbar_wait(bar, 0);    // K (and its scales) is in
      const int r = grp + NG * j;
      float kf[VEC];
      load_chunk<TP, VEC>(smem + r * ROW + cl * Ge::CB, kf);
      float sg[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        sg[g] = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) sg[g] = fmaf(qv[g][i], kf[i], sg[g]);
      }
      group_sum<G, G, L / 2>(sg, cl);
      const float ks = INT8 ? ssc[r] : 1.f;
      if (cl % RD == 0) {
#pragma unroll
        for (int m = 0; m < NF; ++m)
          ss[r * G + (cl / RD) * NF + m] = ok[j] ? sg[m] * ks : -INFINITY;
      }
    }
  }
  __syncthreads();

  // 3. the span's max and sum a query head, probabilities in place
  if (warp < G) {
    float* row = ss + warp;      // the head's scores, G floats apart
    float x[SPAN / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < SPAN / 32; ++i) {
      x[i] = row[(lane + 32 * i) * G];
      mx = fmaxf(mx, x[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < SPAN / 32; ++i) {
      const float p = x[i] == -INFINITY ? 0.f : expf(x[i] - mx);
      row[(lane + 32 * i) * G] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      sm_m[warp] = mx;
      sm_l[warp] = sum;
    }
  }
  __syncthreads();

  // 4. P V: the group's keys, summed over the warp's groups, then a
  // warp's partial sums into the K area
  float acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
#pragma unroll
  for (int j = 0; j < KL; ++j) {
    if (j == 0) mbar_wait(bar + 8, 0);  // V (and its scales) is in
    if (!ok[j]) continue;        // no copy wrote the row: skip what it holds
    const int r = grp + NG * j;
    float vf[VEC];
    load_chunk<TP, VEC>(smem + Sm::VOFF + r * ROW + cl * Ge::CB, vf);
    const float vs = INT8 ? ssc[SPAN + r] : 1.f;
    float pr[G];                          // the key's G probabilities
    if constexpr (G % 4 == 0) {
#pragma unroll
      for (int g = 0; g < G; g += 4)
        *reinterpret_cast<float4*>(pr + g) =
            *reinterpret_cast<const float4*>(ss + r * G + g);
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) pr[g] = ss[r * G + g];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = pr[g] * vs;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
    }
  }
#pragma unroll
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
  if (sub == 0) {                // the K area is free since step 3
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        *reinterpret_cast<float4*>(sacc + (warp * G + g) * D + cl * VEC + i) =
            make_float4(acc[g][i], acc[g][i + 1], acc[g][i + 2],
                        acc[g][i + 3]);
  }
  __syncthreads();

  // 5. one span: the output; several: this span's sums, then the merge
  // by the block that counts last
  const size_t orow = ((size_t)b * a.H + kvh * G) * D;
  const size_t at = bk * a.nsp + sp;
  float* psum = a.part;
  float2* pml = reinterpret_cast<float2*>(
      a.part + (size_t)a.B * a.KVH * a.nsp * G * D);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, c = i % D;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += sacc[(w * G + g) * D + c];
    if (nsplit == 1)
      a.out[orow + i] = from_f<TQ>(x / fmaxf(sm_l[g], 1e-30f));
    else
      psum[at * G * D + i] = x;
  }
  if (nsplit == 1) return;
  if (tid < G) pml[at * G + tid] = make_float2(sm_m[tid], sm_l[tid]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.counters + bk, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the merge, in span order: each output's running max, numerator and
  // denominator over the spans' (max, sum) and sums (an empty span, max
  // -inf, adds nothing), the loads of 8 spans in flight together
  const size_t at0 = bk * a.nsp;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = -INFINITY, num = 0.f, den = 0.f;
#pragma unroll 8
    for (int k = 0; k < nsplit; ++k) {
      const float2 ml = __ldcg(pml + (at0 + k) * G + g);
      const float x = __ldcg(psum + (at0 + k) * G * D + i);
      const float mn = fmaxf(mx, ml.x);
      const float c = mx == mn ? 1.f : expf(mx - mn);
      const float w = ml.x == -INFINITY ? 0.f : expf(ml.x - mn);
      num = num * c + x * w;
      den = den * c + ml.y * w;
      mx = mn;
    }
    a.out[orow + i] = from_f<TQ>(num / fmaxf(den, 1e-30f));
  }
  if (tid == 0) a.counters[bk] = 0;       // for the next launch
}

template <typename TQ, typename TP, int D, int G>
cudaError_t launch(const Args<TQ, TP>& a, cudaStream_t stream) {
  constexpr size_t smem = Smem<TP, D, G>::kBytes;
  // int8 scale runs are whole 16-byte units of a page
  if (std::is_same<TP, int8_t>::value && a.P % 4 != 0)
    return cudaErrorInvalidValue;
  static bool smem_set = false;
  cudaError_t e = allow_smem(paged_decode_split<TQ, TP, D, G>, smem,
                             &smem_set);
  if (e != cudaSuccess) return e;
  paged_decode_split<TQ, TP, D, G>
      <<<dim3(a.nsp, a.KVH, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TP, int D>
cudaError_t dispatch_g(int G, const Args<TQ, TP>& a, cudaStream_t st) {
  switch (G) {
    case 1:
      return launch<TQ, TP, D, 1>(a, st);
    case 2:
      return launch<TQ, TP, D, 2>(a, st);
    case 4:
      return launch<TQ, TP, D, 4>(a, st);
    case 8:
      return launch<TQ, TP, D, 8>(a, st);
  }
  return cudaErrorInvalidValue;
}

// The pointers and sizes of the C entry point, typed by (TQ, TP).
struct Raw {
  const void *q, *k_new, *v_new;
  void *k_pages, *v_pages;
  float *k_scales, *v_scales;
  const int *tables, *lens;
  void *out;
  float* part;
  int* counters;
  int B, H, KVH, n_pages, P, D, maxp;
  float scale;
  int append;
};

template <typename TP>
constexpr int span_of(int D) {
  return D == 64 ? Geo<TP, 64>::SPAN : Geo<TP, 128>::SPAN;
}

template <typename TQ, typename TP>
cudaError_t dispatch_d(const Raw& r, cudaStream_t st) {
  const int span = span_of<TP>(r.D);
  const Args<TQ, TP> a{
      static_cast<const TQ*>(r.q), static_cast<const TQ*>(r.k_new),
      static_cast<const TQ*>(r.v_new), static_cast<TP*>(r.k_pages),
      static_cast<TP*>(r.v_pages), r.k_scales, r.v_scales, r.tables, r.lens,
      static_cast<TQ*>(r.out), r.part, r.counters, r.B, r.H, r.KVH,
      r.n_pages, r.P, r.maxp, (r.maxp * r.P + span - 1) / span, r.scale,
      r.append};
  const int G = r.H / r.KVH;
  if (r.D == 64) return dispatch_g<TQ, TP, 64>(G, a, st);
  if (r.D == 128) return dispatch_g<TQ, TP, 128>(G, a, st);
  return cudaErrorInvalidValue;
}

// The pools' type for q's type TQ: any of the three float types (the
// mixed-dtype mode when it is not TQ) or int8 (code 3).
template <typename TQ>
cudaError_t dispatch_pool(int pool, const Raw& r, cudaStream_t st) {
  switch (pool) {
    case 0:
      return dispatch_d<TQ, float>(r, st);
    case 1:
      return dispatch_d<TQ, __nv_bfloat16>(r, st);
    case 2:
      return dispatch_d<TQ, __half>(r, st);
    case 3:
      return dispatch_d<TQ, int8_t>(r, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace pd
}  // namespace ptt

extern "C" {

// Keys a block's span takes for pools of code `pool` at head dim D (0
// for what the kernel does not take): the wrapper sizes the scratch,
// ceil(maxp P / span) spans a (row, kv head).
int paged_decode_span(int D, int pool) {
  using namespace ptt::pd;
  if (D != 64 && D != 128) return 0;
  switch (pool) {
    case 0:
      return span_of<float>(D);
    case 1:
      return span_of<__nv_bfloat16>(D);
    case 2:
      return span_of<__half>(D);
    case 3:
      return span_of<int8_t>(D);
  }
  return 0;
}

// dtype (q, new rows, out): 0 float32, 1 bfloat16, 2 float16.  pool: the
// pools' type, the same codes or 3 for int8 pools with f32 scale pools.
// append: 1 for kernel #7 (k_new/v_new appended first), 0 for #6.
// part: f32 scratch of B H nsp (D + 2) elements (nsp = ceil(maxp P /
// span)); counters: B KVH ints, zero on entry, left zero.  Returns a
// cudaError_t.
int paged_decode_attention(const void* q, const void* k_new, const void* v_new,
                           void* k_pages, void* v_pages, float* k_scales,
                           float* v_scales, const int* tables, const int* lens,
                           void* out, float* part, int* counters, int B, int H,
                           int KVH, int n_pages, int P, int D, int maxp,
                           float scale, int dtype, int pool, int append,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  const ptt::pd::Raw r{q, k_new, v_new, k_pages, v_pages, k_scales,
                       v_scales, tables, lens, out, part, counters, B, H,
                       KVH, n_pages, P, D, maxp, scale, append};
  switch (dtype) {
    case 0:
      return ptt::pd::dispatch_pool<float>(pool, r, st);
    case 1:
      return ptt::pd::dispatch_pool<__nv_bfloat16>(pool, r, st);
    case 2:
      return ptt::pd::dispatch_pool<__half>(pool, r, st);
  }
  return cudaErrorInvalidValue;
}

const char* paged_decode_attention_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
