// Blockwise causal / sliding-window GQA attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `flash_attention` / `_kernel` in
// src/repro/kernels/flash_attention.py (pallas_call at line 102).
//
// What it computes: q (B, S, H, hd), k/v (B, S, K, hd); query head h reads
// kv head h / (H / K).  Key kp is visible to query qp iff kp <= qp (causal)
// and kp > qp - window (window > 0).  Scale 1/sqrt(hd), online softmax in
// float32, rows with no visible key give 0, output in the input dtype.
//
// What bounds it on an H100: causal prefill does 2 * B * H * S^2 * hd flops
// on 2 * B * S * (H + K) * hd * sizeof(T) bytes of input and output.  At the
// main path's S = 512, hd = 64, H / K = 4 in bf16 that is ~200 flop/byte,
// just under the ~295 ridge, so the two floors are close (bytes slightly
// larger); longer prompts are bound by operations.  This version runs the
// products on the float32 CUDA cores (67 TFLOP/s peak), far from either
// floor; mma/wgmma tiles are later work.
//
// Design: grid (ceil(S / 64), B * H); a block of 128 threads owns 64 query
// rows, two threads per row, each with 32 score and hd / 2 accumulator
// registers.  The block stages its Q tile once and loops over 64-key K/V
// tiles only from the first tile inside the window to the last tile at or
// before the causal limit, so blocks wholly in the future or wholly behind
// the window are never loaded.  Rows and keys past S (a tail the TPU kernel
// could not take) are masked; a row's two threads combine their max and sum
// with one warp shuffle each.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per block (two threads each)
constexpr int kBK = 64;  // keys per tile
static_assert(kBQ == kBK, "stage() loads kBQ rows for every tile");

template <int HD>
size_t smem_floats() {
  return static_cast<size_t>(kBQ) * (HD + 1)        // Q tile
         + 2 * static_cast<size_t>(kBK) * (HD + 1)  // K, V tiles
         + static_cast<size_t>(kBQ) * (kBK + 1);    // probabilities
}

// Stage kBQ rows of hd elements starting at row r0 of a (B, S, heads, hd)
// tensor's (b, ., head) slice into a padded float tile; rows >= S are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* tile, const T* __restrict__ src, int b,
                                      int r0, int S, int heads, int head) {
  constexpr int VEC = VecWidth<T>::N;
  constexpr int P = HD + 1;
  for (int i = threadIdx.x; i < kBQ * (HD / VEC); i += kThreads) {
    const int row = i / (HD / VEC);
    const int part = i % (HD / VEC);
    float t[VEC];
    if (r0 + row < S) {
      const size_t off =
          ((static_cast<size_t>(b) * S + r0 + row) * heads + head) * HD + part * VEC;
      load_vec(src + off, t);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) tile[row * P + part * VEC + e] = t[e];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S, int H,
                       int K, int causal, int window, float scale) {
  constexpr int P = HD + 1;
  constexpr int PP = kBK + 1;
  constexpr int NS = kBK / 2;  // score columns per thread
  constexpr int ND = HD / 2;   // accumulator columns per thread
  const int G = H / K;
  const int b = blockIdx.y / H;
  const int hq = blockIdx.y % H;
  const int kvh = hq / G;
  const int q0 = blockIdx.x * kBQ;
  const int r = threadIdx.x >> 1;  // query row within the tile
  const int half = threadIdx.x & 1;
  const int qp = q0 + r;

  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][P]
  float* ks = qs + kBQ * P;     // [kBK][P]
  float* vs = ks + kBK * P;     // [kBK][P]
  float* ps = vs + kBK * P;     // [kBQ][PP]

  stage<T, HD>(qs, q, b, q0, S, H, hq);

  const int nk = (S + kBK - 1) / kBK;
  int kt_end = nk;
  if (causal) kt_end = min(nk, (min(q0 + kBQ, S) - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  float m = -INFINITY, l = 0.f;
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile fully consumed (and Q staged)
    stage<T, HD>(ks, k, b, k0, S, K, kvh);
    stage<T, HD>(vs, v, b, k0, S, K, kvh);
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int c = 0; c < NS; ++c) s[c] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qv = qs[r * P + d];
#pragma unroll
      for (int c = 0; c < NS; ++c) s[c] += qv * ks[(half + 2 * c) * P + d];
    }
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const int kp = k0 + half + 2 * c;
      const bool ok = kp < S && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
      s[c] = ok ? s[c] * scale : -INFINITY;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = (m_new == -INFINITY) ? 0.f : expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const float p = (s[c] == -INFINITY) ? 0.f : expf(s[c] - m_new);
      ps[r * PP + half + 2 * c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();  // the row's partner wrote its half of the probabilities

#pragma unroll
    for (int j = 0; j < ND; ++j) acc[j] *= corr;
    for (int c = 0; c < kBK; ++c) {
      const float p = ps[r * PP + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[j] += p * vs[c * P + half + 2 * j];
    }
  }

  if (qp < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + ((static_cast<size_t>(b) * S + qp) * H + hq) * HD;
#pragma unroll
    for (int j = 0; j < ND; ++j) o[half + 2 * j] = from_float<T>(acc[j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int S, int H, int K, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, K, causal, window,
      1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out,
                        int B, int S, int H, int K, int causal, int window,
                        cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, K, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, K, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, K, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, hd); k, v (B, S, K, hd); out like q.  All contiguous on the
// device.  Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int S, int H, int K, int hd,
                                      int causal, int window, int dtype, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_hd<float>(hd, q, k, v, out, B, S, H, K, causal, window, s);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, H, K, causal, window, s);
  return cudaErrorInvalidValue;
}
