// E-Attention paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `paged_attention` / `_kernel` in
// src/repro/kernels/paged_attention.py (pallas_call at line 120).
//
// What it computes: for every sequence b and kv head kh, the G = H / K query
// rows of that head attend over the sequence's first lengths[b] tokens,
// which live in the pages tables[b, 0..] of a (P, T, K, hd) slab.  Scale
// 1/sqrt(hd), positions >= lengths[b] masked, online softmax in float32
// (m, l, acc), out = acc / max(l, 1e-30) in the input dtype.
//
// What bounds it on an H100: device-memory bytes.  Each (b, kh) reads
// lengths[b] * hd * 2 (K and V) elements once and does 4 * G flops per
// element pair, far below the ~295 flop/byte ridge, so the floor is
// B * ctx * K * hd * 2 * sizeof(T) / 3.35 TB/s per layer.
//
// Design: one block of 128 threads per (b, kh) walks the live context in
// chunks of 32 tokens.  A block reads the page id of each token itself from
// the table and never dereferences entries at or past ceil(len / T) (the
// Pallas kernel DMAs a page for every table entry and relies on padding
// being a valid id).  K and V rows are loaded with 16-byte vector loads into
// shared memory as float32; scores, the per-row online-softmax update and
// the P.V accumulation each run as one block-wide pass.  The grid and the
// loop bound come from device data only, so a decode step never reads
// lengths back to the host.  Deliberately simple: with B * K blocks the card
// is mostly idle at small batch; a split-KV pass (flash-decoding) and
// cp.async/TMA double buffering are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;  // tokens staged per iteration

template <int HD>
__host__ __device__ constexpr int padded() { return HD + 1; }  // bank-conflict pad

template <int HD>
size_t smem_floats(int G) {
  return static_cast<size_t>(G) * HD * 2           // q rows, acc
         + 2 * kChunk * padded<HD>()                // K, V chunk
         + static_cast<size_t>(G) * kChunk          // scores / probabilities
         + 3 * static_cast<size_t>(G);              // m, l, corr
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int K, int T_blk, int N, float scale) {
  constexpr int VEC = VecWidth<T>::N;
  constexpr int HDP = padded<HD>();
  const int G = H / K;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* qs = smem;                        // [G][HD]
  float* acc = qs + G * HD;                // [G][HD]
  float* ks = acc + G * HD;                // [kChunk][HDP]
  float* vs = ks + kChunk * HDP;           // [kChunk][HDP]
  float* ss = vs + kChunk * HDP;           // [G][kChunk]
  float* m = ss + G * kChunk;              // [G]
  float* l = m + G;                        // [G]
  float* corr = l + G;                     // [G]

  const int len = lengths[b];
  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G) * HD;
  for (int i = tid; i < G * HD / VEC; i += kThreads) {
    float t[VEC];
    load_vec(qb + i * VEC, t);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qs[i * VEC + e] = t[e];
  }
  for (int i = tid; i < G * HD; i += kThreads) acc[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  __syncthreads();

  const int* tb = tables + static_cast<size_t>(b) * N;
  for (int c0 = 0; c0 < len; c0 += kChunk) {
    // stage K/V rows of tokens c0 .. c0+kChunk-1 (zeros past len)
    for (int i = tid; i < kChunk * (HD / VEC); i += kThreads) {
      const int j = i / (HD / VEC);
      const int part = i % (HD / VEC);
      const int pos = c0 + j;
      float kt[VEC], vt[VEC];
      if (pos < len) {
        const int page = tb[pos / T_blk];
        const int slot = pos % T_blk;
        const size_t off =
            ((static_cast<size_t>(page) * T_blk + slot) * K + kh) * HD + part * VEC;
        load_vec(k_pages + off, kt);
        load_vec(v_pages + off, vt);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kt[e] = vt[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[j * HDP + part * VEC + e] = kt[e];
        vs[j * HDP + part * VEC + e] = vt[e];
      }
    }
    __syncthreads();

    // scores of every (query row, token) pair of the chunk
    for (int i = tid; i < G * kChunk; i += kThreads) {
      const int g = i / kChunk;
      const int j = i % kChunk;
      float s = -INFINITY;
      if (c0 + j < len) {
        float d = 0.f;
#pragma unroll 16
        for (int e = 0; e < HD; ++e) d += qs[g * HD + e] * ks[j * HDP + e];
        s = d * scale;
      }
      ss[i] = s;
    }
    __syncthreads();

    // online-softmax update, one thread per query row; the chunk holds at
    // least one live token, so m_new is finite
    for (int g = tid; g < G; g += kThreads) {
      float mx = -INFINITY;
      for (int j = 0; j < kChunk; ++j) mx = fmaxf(mx, ss[g * kChunk + j]);
      const float m_new = fmaxf(m[g], mx);
      const float cr = expf(m[g] - m_new);
      float sum = 0.f;
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(ss[g * kChunk + j] - m_new);  // masked: exp(-inf) = 0
        ss[g * kChunk + j] = p;
        sum += p;
      }
      l[g] = l[g] * cr + sum;
      m[g] = m_new;
      corr[g] = cr;
    }
    __syncthreads();

    for (int i = tid; i < G * HD; i += kThreads) {
      const int g = i / HD;
      const int e = i % HD;
      float a = acc[i] * corr[g];
#pragma unroll 8
      for (int j = 0; j < kChunk; ++j) a += ss[g * kChunk + j] * vs[j * HDP + e];
      acc[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) {
    ob[i] = from_float<T>(acc[i] / fmaxf(l[i / HD], 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* tables, const int* lengths, void* out, int B, int H,
                   int K, int T_blk, int N, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = smem_floats<HD>(G) * sizeof(float);
  auto kernel = paged_attention_kernel<T, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(K, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, lengths, static_cast<T*>(out), H, K,
      T_blk, N, 1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                        const int* tables, const int* lengths, void* out, int B,
                        int H, int K, int T_blk, int N, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, kp, vp, tables, lengths, out, B, H, K, T_blk, N, stream);
    case 64: return launch<T, 64>(q, kp, vp, tables, lengths, out, B, H, K, T_blk, N, stream);
    case 128: return launch<T, 128>(q, kp, vp, tables, lengths, out, B, H, K, T_blk, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, hd); k/v pages (P, T, K, hd) of one layer; tables (B, N) int32;
// lengths (B,) int32; out (B, H, hd).  All contiguous on the device.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lengths, void* out, int B, int H,
                                      int K, int hd, int T_blk, int N, int dtype,
                                      void* stream) {
  if (B == 0) return cudaSuccess;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_hd<float>(hd, q, k_pages, v_pages, tb, ln, out, B, H, K, T_blk, N, s);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, tb, ln, out, B, H, K, T_blk,
                                      N, s);
  return cudaErrorInvalidValue;
}
