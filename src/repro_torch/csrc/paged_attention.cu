// E-Attention paged decode attention for Hopper (sm_90a), split-KV.
//
// Replaces the TPU Pallas kernel `paged_attention` / `_kernel` in
// src/repro/kernels/paged_attention.py (pallas_call at line 120).
//
// What it computes: for every sequence b and kv head kh, the G = H / K query
// rows of that head attend over the sequence's first lengths[b] tokens,
// which live in the pages tables[b, 0..] of a (P, T, K, hd) slab.  Scale
// 1/sqrt(hd), positions >= lengths[b] masked, online softmax in float32
// (m, l, acc), out = acc / max(l, 1e-30) in the input dtype; length 0
// gives zeros.  float32 and bfloat16 share the design; the arithmetic is
// float32 either way.
//
// What bounds it on an H100: device-memory bytes.  Each (b, kh) reads
// lengths[b] * hd * 2 (K and V) elements once and does 4 * G flops per
// element pair, far below the ~295 flop/byte ridge, so the floor is
// B * ctx * K * hd * 2 * sizeof(T) / 3.35 TB/s per layer.  The only way to
// it is to have every SM pulling bytes at once, with several loads in
// flight each.
//
// Design (flash-decoding): one call makes two launches.
//  1. `paged_split_kernel`, grid (splits, K, B).  The context is cut into
//     splits of `split_tokens` tokens (a whole number of pages, computed by
//     the wrapper from the table's static shape (N, T), never from
//     `lengths`, so the host reads nothing back).  A block whose split
//     starts at or past lengths[b] exits before it reads a table entry, and
//     no block reads an entry at or past ceil(len / T).  Inside a block,
//     each warp takes rows of K: lanes take 16-byte pieces of a row (hd 64
//     bf16: 8 lanes a row, 4 rows a warp-load) and every load of the split
//     is issued before the first score is reduced; the G query rows of the
//     kv head sit in shared memory and a score is a warp-shuffle reduction
//     over the row's lanes.  V streams into shared memory by cp.async
//     meanwhile.  The split's softmax (max, exp, sum) runs one warp per
//     query row with every lane busy; P.V runs one thread per (row, dim).
//     The block writes its (m, l, acc) to float32 scratch.
//  2. `paged_combine_kernel`, grid (H, B): merges the live splits' partials
//     of each (b, head) into the output.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // warp-loads of K in flight per lane

// Row stride of the score tile: a multiple of 4 floats, so the V rows after
// it stay 16-byte aligned for cp.async whatever the page size.
__host__ __device__ inline int score_stride(int split_tokens) {
  return (split_tokens + 3) & ~3;
}

size_t split_smem_bytes(int G, int hd, int split_tokens, int T_blk, size_t elem) {
  return static_cast<size_t>(G) * hd * 4                             // q rows, float
         + static_cast<size_t>(G) * score_stride(split_tokens) * 4   // scores / probabilities
         + static_cast<size_t>(split_tokens) * hd * elem  // V rows
         + static_cast<size_t>(split_tokens / T_blk) * 4; // page ids
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages, const int* __restrict__ tables,
                   const int* __restrict__ lengths, float* __restrict__ part_acc,
                   float* __restrict__ part_m, float* __restrict__ part_l, int H, int K,
                   int T_blk, int N, int split_tokens, int splits, float scale) {
  constexpr int VEC = VecWidth<T>::N;
  constexpr int LPR = HD * static_cast<int>(sizeof(T)) / 16;  // lanes per K row
  constexpr int RPW = 32 / LPR;                               // rows per warp-load
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row must fit a warp");
  const int G = H / K;
  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int len = lengths[b];
  const int s0 = split * split_tokens;
  if (s0 >= len) return;  // dead split: touches no table entry
  const int n = min(split_tokens, len - s0);
  const int npages = (n + T_blk - 1) / T_blk;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);            // [G][HD]
  const int sst = score_stride(split_tokens);
  float* ss = qs + G * HD;                                   // [G][sst]
  T* vs = reinterpret_cast<T*>(ss + G * sst);                // [split_tokens][HD]
  int* pg = reinterpret_cast<int*>(vs + split_tokens * HD);  // [split_tokens / T]

  const int* tb = tables + static_cast<size_t>(b) * N + s0 / T_blk;
  for (int i = tid; i < npages; i += kThreads) pg[i] = tb[i];
  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G) * HD;
  for (int i = tid; i < G * HD / VEC; i += kThreads) load_vec(qb + i * VEC, qs + i * VEC);
  __syncthreads();

  const size_t row_stride = static_cast<size_t>(K) * HD;  // elements between slots
  auto row_off = [&](int j) {  // element offset of token j's (kh) row in the slab
    return (static_cast<size_t>(pg[j / T_blk]) * T_blk + j % T_blk) * row_stride +
           static_cast<size_t>(kh) * HD;
  };

  // V rows of the split -> shared memory, in flight while the scores run
  for (int i = tid; i < n * LPR; i += kThreads) {
    const int j = i / LPR;
    const int c = i % LPR;
    cp_async16(smem_addr(vs + j * HD + c * VEC), v_pages + row_off(j) + c * VEC);
  }
  cp_async_commit();

  // scores: lane (r, c) holds piece c of row r of each warp-load
  const int r = lane / LPR;
  const int c = lane % LPR;
  constexpr int kPass = kUnroll * kWarps * RPW;  // tokens per pass of the block
  for (int j0 = 0; j0 < n; j0 += kPass) {
    uint4 kr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + (u * kWarps + warp) * RPW + r;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (j < n) kr[u] = __ldg(reinterpret_cast<const uint4*>(k_pages + row_off(j) + c * VEC));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + (u * kWarps + warp) * RPW + r;
      if (j0 + u * kWarps * RPW >= n) break;  // warp-uniform: no row of this load
      float kf[VEC];
      if (j < n) {
        unpack_vec<T>(kr[u], kf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = 0.f;
      }
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * HD + c * VEC;
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d += qg[e] * kf[e];
#pragma unroll
        for (int o = LPR / 2; o >= 1; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (c == 0 && j < n) ss[g * sst + j] = d * scale;
      }
    }
  }
  __syncthreads();

  // the split's softmax: one warp per query row
  const size_t part = (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G) * splits;
  for (int g = warp; g < G; g += kWarps) {
    float* sg = ss + g * sst;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sg[j]);
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sg[j] - mx);
      sg[j] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      part_m[part + static_cast<size_t>(g) * splits + split] = mx;
      part_l[part + static_cast<size_t>(g) * splits + split] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // P.V: one thread per (query row, dim)
  for (int o = tid; o < G * HD; o += kThreads) {
    const int g = o / HD;
    const int d = o % HD;
    const float* pgp = ss + g * sst;
    float a = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) a += pgp[j] * to_float(vs[j * HD + d]);
    part_acc[(part + static_cast<size_t>(g) * splits + split) * HD + d] = a;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
paged_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                     const float* __restrict__ part_l, const int* __restrict__ lengths,
                     T* __restrict__ out, int H, int split_tokens, int splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int live = (lengths[b] + split_tokens - 1) / split_tokens;  // 0 for length 0
  const size_t base = (static_cast<size_t>(b) * H + h) * splits;
  float mx = -INFINITY;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, part_m[base + s]);
  float l = 0.f, a = 0.f;
#pragma unroll 4
  for (int s = 0; s < live; ++s) {
    const float w = expf(part_m[base + s] - mx);
    l += w * part_l[base + s];
    a += w * part_acc[(base + s) * HD + d];
  }
  out[(static_cast<size_t>(b) * H + h) * HD + d] = from_float<T>(a / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* tables, const int* lengths, void* out, float* part_acc,
                   float* part_m, float* part_l, int B, int H, int K, int T_blk, int N,
                   int split_tokens, int splits, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = split_smem_bytes(G, HD, split_tokens, T_blk, sizeof(T));
  constexpr auto kernel = paged_split_kernel<T, HD>;
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(splits, K, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, lengths, part_acc, part_m, part_l, H, K,
      T_blk, N, split_tokens, splits, 1.0f / sqrtf(static_cast<float>(HD)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T, HD><<<dim3(H, B), HD, 0, stream>>>(
      part_acc, part_m, part_l, lengths, static_cast<T*>(out), H, split_tokens, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                        const int* tables, const int* lengths, void* out, float* pa,
                        float* pm, float* pl, int B, int H, int K, int T_blk, int N,
                        int split_tokens, int splits, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, kp, vp, tables, lengths, out, pa, pm, pl, B, H, K,
                                  T_blk, N, split_tokens, splits, stream);
    case 64: return launch<T, 64>(q, kp, vp, tables, lengths, out, pa, pm, pl, B, H, K,
                                  T_blk, N, split_tokens, splits, stream);
    case 128: return launch<T, 128>(q, kp, vp, tables, lengths, out, pa, pm, pl, B, H, K,
                                    T_blk, N, split_tokens, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, hd); k/v pages (P, T, K, hd) of one layer; tables (B, N) int32;
// lengths (B,) int32; out (B, H, hd); scratch part_acc (B, H, splits, hd)
// and part_m, part_l (B, H, splits) float32, with split_tokens a multiple of
// T and splits = ceil(N * T / split_tokens).  All contiguous on the device.
// Returns the cudaError_t of the two launches (0 = success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lengths, void* out, void* part_acc,
                                      void* part_m, void* part_l, int B, int H, int K,
                                      int hd, int T_blk, int N, int split_tokens,
                                      int splits, int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  if (split_tokens <= 0 || split_tokens % T_blk || splits * split_tokens < N * T_blk)
    return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_hd<float>(hd, q, k_pages, v_pages, tb, ln, out, pa, pm, pl, B, H, K,
                              T_blk, N, split_tokens, splits, s);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, tb, ln, out, pa, pm, pl, B,
                                      H, K, T_blk, N, split_tokens, splits, s);
  return cudaErrorInvalidValue;
}
