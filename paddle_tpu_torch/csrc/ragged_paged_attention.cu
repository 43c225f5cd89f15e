// Ragged paged append + attention for the serving engine's unified step.
//
// Replaces the TPU kernel `_ragged_kernel` / `_stream_pages_ragged`
// behind `ragged_paged_append_attend_raw`
// (paddle_tpu/ops/pallas/paged_attention.py).  One call serves a whole
// mixed prefill + decode batch, described by per-descriptor scalars
// (q_start, q_len, kv_len) and a page table per descriptor: descriptor s
// owns flat rows [q_start, q_start + q_len), which land at positions
// kv_len .. kv_len + q_len - 1 of its sequence, all inside one page.
//
// Two launches, in stream order:
//   1. ragged_append  — grid (KVH, S): scatter every live row's new K/V
//      into its page slot, and zero the output rows that have no query
//      (row >= q_len, and every row of a q_len == 0 descriptor), so the
//      engine's (descriptor, offset) gather never reads uninitialised
//      memory.  The TPU grid runs in order, so a prompt split over two
//      descriptors of one call sees its first chunk's page; CUDA blocks
//      run in no order, so all appends finish before any attention starts.
//   2. ragged_attend  — grid (row tiles, KVH, S): a block owns 64 of the
//      descriptor's q_len * G query rows (G query heads per kv head share
//      every K/V tile it loads) and streams the sequence's pages up to the
//      last position those rows may see, with the causal-within-chunk mask
//      kv_pos <= kv_len + row.  Tiles without a query row exit at once.
//
// Int8 pools (`int8`): the pools hold int8 codes and the scale pools
// [KVH, n_pages, P] f32 one scale per token row.  The append launch
// (ragged_append_int8) quantizes each live row in a warp, as
// quantization/ops.py quantize_rows does (int8_kv.cuh: the same codes
// and scale bit for bit), and writes codes and scale; the attend launch
// dequantizes K/V tiles as it stages them into shared memory
// (attention_tile.cuh, f32 tiles).  q, the new rows and the output keep
// the model's dtype.
//
// Float pools of another float type than q (the mixed-dtype mode; the
// serving benches run f32 q over bf16 pools): the append launch
// casts each new row to the pool type as it writes it (round to nearest
// even, as Tensor.to does, so the pools equal the plain version's bit
// for bit), and the attend launch stages the pool-typed tiles and widens
// them to f32 (attention_tile.cuh's `Pool`).  Scores and accumulation
// are f32 and the output is q's type in every mode, as the reference
// computes them (paged_attention.py `_ragged_kernel` widens q before
// the scale and the pages as it reads them).
//
// What bounds it on an H100: bytes.  The output block [S, P, H, D] is
// written whole (142.6 MB in bf16 at the engine's default shapes, most of
// it zeros), and decode rows read every page of their sequence once per
// kv head for G = 4 query rows.  The design writes the zeros from the
// append launch, which holds no shared memory and so fills the SMs, with
// 16-byte stores; reads each page once per block with 16-byte loads;
// keeps scores and probabilities in shared memory and registers
// (attention_tile.cuh); skips pages past the rows' last visible position
// and row groups without a query.
#include "attention_tile.cuh"
#include "int8_kv.cuh"

namespace ptt {

// Zero descriptor s's output rows r >= ql of kv head h's G query heads,
// with 16-byte stores (D * sizeof(T) is a multiple of 16).
template <typename T>
__device__ __forceinline__ void zero_rows_without_query(T* out, int s, int h,
                                                        int ql, int H, int KVH,
                                                        int P, int D) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int G = H / KVH, rch = G * D / VEC;  // chunks per row of G heads
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int idx = threadIdx.x; idx < (P - ql) * rch; idx += blockDim.x) {
    const int r = ql + idx / rch, c = idx % rch;
    *reinterpret_cast<uint4*>(out + (((size_t)s * P + r) * H + h * G) * D + c * VEC) = zero;
  }
}

// One block per (kv head, descriptor): copy the descriptor's new K/V rows
// (q's type T) into their page slots (pool type TP), then zero the
// output rows of this kv head's G query heads that have no query (rows
// >= q_len; all P rows of an unused descriptor).  No shared memory, so
// blocks fill the SMs.  Pools in T: 16-byte loads and stores (D *
// sizeof(T) is a multiple of 16); pools in another float type: one
// element at a time, cast through f32.
template <typename T, typename TP>
__global__ void __launch_bounds__(256)
ragged_append(const T* __restrict__ k_new, const T* __restrict__ v_new,
              TP* __restrict__ k_pages, TP* __restrict__ v_pages,
              const int* __restrict__ q_start, const int* __restrict__ q_len,
              const int* __restrict__ kv_len, const int* __restrict__ tables,
              T* __restrict__ out, int H, int KVH, int n_pages, int P, int D,
              int maxp) {
  constexpr bool SAME = std::is_same<T, TP>::value;
  constexpr int VEC = SAME ? 16 / (int)sizeof(T) : 1;
  const int h = blockIdx.x, s = blockIdx.y;
  const int ql = min(max(q_len[s], 0), P);
  const int ch = D / VEC;                    // copies per row
  if (ql > 0) {
    const int kv = kv_len[s], qs = q_start[s];
    for (int idx = threadIdx.x; idx < ql * ch; idx += blockDim.x) {
      const int r = idx / ch, c = idx % ch;
      const int pos = kv + r;
      if (pos / P >= maxp) continue;
      const int page = tables[(size_t)s * maxp + pos / P];
      if (page < 0 || page >= n_pages) continue;
      const size_t dst = (((size_t)h * n_pages + page) * P + pos % P) * D + c * VEC;
      const size_t src = ((size_t)(qs + r) * KVH + h) * D + c * VEC;
      if constexpr (SAME) {
        *reinterpret_cast<uint4*>(k_pages + dst) = *reinterpret_cast<const uint4*>(k_new + src);
        *reinterpret_cast<uint4*>(v_pages + dst) = *reinterpret_cast<const uint4*>(v_new + src);
      } else {
        k_pages[dst] = from_f<TP>(to_f(k_new[src]));
        v_pages[dst] = from_f<TP>(to_f(v_new[src]));
      }
    }
  }
  zero_rows_without_query(out, s, h, ql, H, KVH, P, D);
}

// One block per (kv head, descriptor), int8 pools: each warp quantizes
// the descriptor's new K and V rows r = warp, warp + 8, ... into their
// page slots (codes and the per-token scale), then the block zeroes the
// output rows without a query as ragged_append does.
template <typename T, int D>
__global__ void __launch_bounds__(256)
ragged_append_int8(const T* __restrict__ k_new, const T* __restrict__ v_new,
                   int8_t* __restrict__ k_pages, int8_t* __restrict__ v_pages,
                   float* __restrict__ k_scales, float* __restrict__ v_scales,
                   const int* __restrict__ q_start, const int* __restrict__ q_len,
                   const int* __restrict__ kv_len, const int* __restrict__ tables,
                   T* __restrict__ out, int H, int KVH, int n_pages, int P,
                   int maxp) {
  const int h = blockIdx.x, s = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ql = min(max(q_len[s], 0), P);
  const int kv = kv_len[s], qs = q_start[s];
  for (int r = warp; r < ql; r += blockDim.x >> 5) {
    const int pos = kv + r;
    if (pos / P >= maxp) continue;
    const int page = tables[(size_t)s * maxp + pos / P];
    if (page < 0 || page >= n_pages) continue;
    const size_t row = ((size_t)h * n_pages + page) * P + pos % P;
    const size_t src = ((size_t)(qs + r) * KVH + h) * D;
    quantize_row_warp<T, D>(k_new + src, k_pages + row * D, k_scales + row, lane);
    quantize_row_warp<T, D>(v_new + src, v_pages + row * D, v_scales + row, lane);
  }
  zero_rows_without_query(out, s, h, ql, H, KVH, P, D);
}

template <typename T, int D, typename TP>
struct RaggedCtx {
  using Pool = TP;
  static constexpr bool kInt8 = std::is_same<TP, int8_t>::value;
  const T* q;
  const TP* k;
  const TP* v;
  const float* ks;     // int8 pools: per-token scales, else unused
  const float* vs;
  const int* table;    // this descriptor's page table [maxp]
  int H, G, kvh, P, n_pages, maxp;
  int q_start, q_len, kv_len, row0, rows, key_end;

  __device__ const T* q_row(int lr) const {
    const int rr = row0 + lr, r = rr / G;
    if (r >= q_len) return nullptr;
    return q + ((size_t)(q_start + r) * H + kvh * G + rr % G) * D;
  }
  __device__ long long k_off(int pos) const {
    if (pos / P >= maxp) return -1;
    const int page = table[pos / P];
    if (page < 0 || page >= n_pages) return -1;
    return (((long long)kvh * n_pages + page) * P + pos % P) * D;
  }
  __device__ long long v_off(int pos) const { return k_off(pos); }
  __device__ float mask(int lr, int pos, float s) const {
    return pos <= kv_len + (row0 + lr) / G ? s : kMasked;
  }
};

template <typename T, int D, typename TP>
__global__ void __launch_bounds__(NT)
ragged_attend(const T* __restrict__ q, const TP* __restrict__ k_pages,
              const TP* __restrict__ v_pages, const float* __restrict__ k_scales,
              const float* __restrict__ v_scales, const int* __restrict__ q_start,
              const int* __restrict__ q_len, const int* __restrict__ kv_len,
              const int* __restrict__ tables, T* __restrict__ out, int H,
              int KVH, int n_pages, int P, int maxp, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.y, s = blockIdx.z;
  const int G = H / KVH;
  const int row0 = blockIdx.x * BR;
  const int ql = q_len[s];
  const int live = ql * G;                 // rows rr < live have a query
  if (row0 >= live) return;                // zeroed by ragged_append

  RaggedCtx<T, D, TP> ctx;
  ctx.q = q;
  ctx.k = k_pages;
  ctx.v = v_pages;
  ctx.ks = k_scales;
  ctx.vs = v_scales;
  ctx.table = tables + (size_t)s * maxp;
  ctx.H = H;
  ctx.G = G;
  ctx.kvh = kvh;
  ctx.P = P;
  ctx.n_pages = n_pages;
  ctx.maxp = maxp;
  ctx.q_start = q_start[s];
  ctx.q_len = ql;
  ctx.kv_len = kv_len[s];
  ctx.row0 = row0;
  ctx.rows = min(BR, live - row0);
  // the last position any row of this tile may see
  ctx.key_end = ctx.kv_len + min(ql - 1, (row0 + BR - 1) / G) + 1;

  RowState<D> st;
  attend_rows<T, D>(ctx, scale, smem, st);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = row0 + ty + 16 * i;
    if (rr >= live) continue;
    const int r = rr / G, h = kvh * G + rr % G;
    const float lsafe = fmaxf(st.l[i], 1e-30f);
    T* o = out + (((size_t)s * P + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) o[tx + 16 * c] = from_f<T>(st.acc[i][c] / lsafe);
  }
}

template <typename T, typename TP, int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_pages, void* v_pages, float* k_scales,
                   float* v_scales, const int* q_start, const int* q_len,
                   const int* kv_len, const int* tables, void* out, int S,
                   int H, int KVH, int n_pages, int P, int maxp, float scale,
                   cudaStream_t stream) {
  constexpr bool INT8 = std::is_same<TP, int8_t>::value;
  if constexpr (INT8)
    ragged_append_int8<T, D><<<dim3(KVH, S), 256, 0, stream>>>(
        static_cast<const T*>(k_new), static_cast<const T*>(v_new),
        static_cast<int8_t*>(k_pages), static_cast<int8_t*>(v_pages),
        k_scales, v_scales, q_start, q_len, kv_len, tables,
        static_cast<T*>(out), H, KVH, n_pages, P, maxp);
  else
    ragged_append<T, TP><<<dim3(KVH, S), 256, 0, stream>>>(
        static_cast<const T*>(k_new), static_cast<const T*>(v_new),
        static_cast<TP*>(k_pages), static_cast<TP*>(v_pages), q_start, q_len,
        kv_len, tables, static_cast<T*>(out), H, KVH, n_pages, P, D, maxp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int G = H / KVH;
  const dim3 grid((P * G + BR - 1) / BR, KVH, S);
  using TE = typename std::conditional<INT8, float, TP>::type;
  const size_t smem = Tile<TE, D>::kBytes;
  static bool smem_set = false;
  e = allow_smem(ragged_attend<T, D, TP>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  ragged_attend<T, D, TP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(k_pages),
      static_cast<const TP*>(v_pages), INT8 ? k_scales : nullptr,
      INT8 ? v_scales : nullptr, q_start, q_len, kv_len, tables,
      static_cast<T*>(out), H, KVH, n_pages, P, maxp, scale);
  return cudaGetLastError();
}

template <typename T, typename TP>
cudaError_t dispatch_d(int D, const void* q, const void* k_new,
                       const void* v_new, void* k_pages, void* v_pages,
                       float* k_scales, float* v_scales, const int* q_start,
                       const int* q_len, const int* kv_len, const int* tables,
                       void* out, int S, int H, int KVH, int n_pages, int P,
                       int maxp, float scale, cudaStream_t stream) {
  if (D == 64)
    return launch<T, TP, 64>(q, k_new, v_new, k_pages, v_pages, k_scales,
                             v_scales, q_start, q_len, kv_len, tables, out, S,
                             H, KVH, n_pages, P, maxp, scale, stream);
  if (D == 128)
    return launch<T, TP, 128>(q, k_new, v_new, k_pages, v_pages, k_scales,
                              v_scales, q_start, q_len, kv_len, tables, out,
                              S, H, KVH, n_pages, P, maxp, scale, stream);
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
                          int S, int H, int KVH, int n_pages, int P, int maxp,
                          float scale, cudaStream_t st) {
#define PTT_RAGGED_POOL(TP)                                                  \
  return dispatch_d<T, TP>(D, q, k_new, v_new, k_pages, v_pages, k_scales,  \
                           v_scales, q_start, q_len, kv_len, tables, out, S, \
                           H, KVH, n_pages, P, maxp, scale, st)
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

}  // namespace ptt

extern "C" {

// dtype (q, new rows, out): 0 float32, 1 bfloat16, 2 float16.  pool: the
// pools' type, the same codes or 3 for int8 pools with f32 scale pools.
// Returns a cudaError_t.
int ragged_paged_append_attend(const void* q, const void* k_new,
                               const void* v_new, void* k_pages,
                               void* v_pages, float* k_scales,
                               float* v_scales, const int* q_start,
                               const int* q_len, const int* kv_len,
                               const int* tables, void* out, int S, int H,
                               int KVH, int n_pages, int P, int D, int maxp,
                               float scale, int dtype, int pool,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return ptt::dispatch_pool<float>(pool, D, q, k_new, v_new, k_pages,
                                       v_pages, k_scales, v_scales, q_start,
                                       q_len, kv_len, tables, out, S, H, KVH,
                                       n_pages, P, maxp, scale, st);
    case 1:
      return ptt::dispatch_pool<__nv_bfloat16>(
          pool, D, q, k_new, v_new, k_pages, v_pages, k_scales, v_scales,
          q_start, q_len, kv_len, tables, out, S, H, KVH, n_pages, P, maxp,
          scale, st);
    case 2:
      return ptt::dispatch_pool<__half>(pool, D, q, k_new, v_new, k_pages,
                                        v_pages, k_scales, v_scales, q_start,
                                        q_len, kv_len, tables, out, S, H, KVH,
                                        n_pages, P, maxp, scale, st);
  }
  return cudaErrorInvalidValue;
}

const char* ragged_paged_attention_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
