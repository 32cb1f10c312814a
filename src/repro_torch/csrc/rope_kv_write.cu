// Rotary embedding of a decode step's query and key, and the step's K/V rows
// written into their pages, for Hopper (sm_90a): one launch a layer.
//
// Replaces no TPU kernel: the reference's decode step
// (src/repro/serving/engine.py `_paged_decode_step`) ropes q and k with
// `apply_rope` and scatters the new rows with `.at[].set`, which XLA fuses.
// In PyTorch the same chain is separate kernels: per layer two `apply_rope`
// calls of 19 operations each (the frequencies, the angles, cos and sin,
// the fp32 casts, four products, a difference, a sum, a concat, the cast
// back) and two `index_copy_`.  At batch 1 each of those kernels moves a
// few kilobytes, so a step pays their launches and gaps, not their bytes.
// The step computes its cos/sin table once, before its layer loop
// (`common.rope_table`), and each layer makes one launch of this kernel:
//
//   q_out[b, h]             = rope(q[b, h])      (the query K1 reads)
//   k_pages[row[b], kh]     = rope(k[b, kh])
//   v_pages[row[b], kh]     = v[b, kh]
//
// with rope(x)[i] = x[i] c[i] - x[i + hd/2] s[i] and rope(x)[i + hd/2] =
// x[i + hd/2] c[i] + x[i] s[i], for i < hd/2, (c, s) = (cos, sin)[b].
//
// Same bits as the PyTorch chain: products, the difference and the sum each
// rounded in float32 as its own kernel rounds it (`__fmul_rn`, `__fsub_rn`,
// `__fadd_rn`, which the compiler never contracts into an FMA), then one
// round to bfloat16 (`__float2bfloat16_rn`).  The step's logits are equal to
// the bit to those of the chain.
//
// What bounds it: nothing but its launch.  At deepseek-7b's B 1 it moves
// 48 KB (q, k and v read and written, hd 128, 32 + 32 + 32 heads), 15 ns at
// 3.35 TB/s; one thread a rotated pair, 256 threads a block, the grid sized
// from the static shapes, so every load is issued at once and the kernel
// waits for one memory round trip.  The row of each sequence is read on the
// device: a call never syncs and captures into a CUDA graph.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  const __nv_bfloat16* q;  // (B, H, hd)
  const __nv_bfloat16* k;  // (B, K, hd)
  const __nv_bfloat16* v;  // (B, K, hd)
  const float* cos;        // (B, hd / 2)
  const float* sin;        // (B, hd / 2)
  const long long* row;    // (B,) each sequence's row of a layer's (P * T, K, hd) pages
  __nv_bfloat16* q_out;    // (B, H, hd)
  __nv_bfloat16* k_pages;  // (P * T, K, hd), one layer
  __nv_bfloat16* v_pages;  // (P * T, K, hd), one layer
  int H, K, half;          // half = hd / 2
  long long pairs;         // B * (H + 2 K) * half: one thread each
};

// Thread t owns pair i = t % half of head row t / half; a sequence's head
// rows are its H query heads, then its K key heads, then its K value heads.
__global__ void __launch_bounds__(kThreads) rope_kv_write_kernel(const Args a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= a.pairs) return;
  const int half = a.half;
  const int i = static_cast<int>(t % half);
  const long long r = t / half;
  const int heads = a.H + 2 * a.K;
  const int b = static_cast<int>(r / heads);
  const int h = static_cast<int>(r % heads);
  const size_t hd = 2 * static_cast<size_t>(half);
  if (h >= a.H + a.K) {  // a value head: copied to its page
    const int kh = h - a.H - a.K;
    const __nv_bfloat16* src = a.v + (static_cast<size_t>(b) * a.K + kh) * hd;
    __nv_bfloat16* dst = a.v_pages + (static_cast<size_t>(a.row[b]) * a.K + kh) * hd;
    dst[i] = src[i];
    dst[i + half] = src[i + half];
    return;
  }
  const __nv_bfloat16* src;
  __nv_bfloat16* dst;
  if (h < a.H) {  // a query head
    const size_t off = (static_cast<size_t>(b) * a.H + h) * hd;
    src = a.q + off;
    dst = a.q_out + off;
  } else {  // a key head: roped into its page
    const int kh = h - a.H;
    src = a.k + (static_cast<size_t>(b) * a.K + kh) * hd;
    dst = a.k_pages + (static_cast<size_t>(a.row[b]) * a.K + kh) * hd;
  }
  const float c = a.cos[static_cast<size_t>(b) * half + i];
  const float s = a.sin[static_cast<size_t>(b) * half + i];
  const float x1 = __bfloat162float(src[i]);
  const float x2 = __bfloat162float(src[i + half]);
  dst[i] = __float2bfloat16_rn(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  dst[i + half] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
}

}  // namespace

// q_out (B, H, hd) from q, and one layer's k_pages / v_pages (P * T, K, hd)
// written at row (B,) int64 from k, v (B, K, hd); cos, sin (B, hd / 2)
// float32; every other operand bfloat16.  Returns a cudaError_t.
extern "C" int rope_kv_write_launch(const void* q, const void* k, const void* v,
                                    const void* cos, const void* sin, const void* row,
                                    void* q_out, void* k_pages, void* v_pages, int B, int H,
                                    int K, int hd, void* stream) {
  if (B == 0) return cudaSuccess;
  if (B < 0 || H <= 0 || K <= 0 || hd <= 0 || hd % 2) return cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(cos),
               static_cast<const float*>(sin), static_cast<const long long*>(row),
               static_cast<__nv_bfloat16*>(q_out), static_cast<__nv_bfloat16*>(k_pages),
               static_cast<__nv_bfloat16*>(v_pages), H, K, hd / 2,
               static_cast<long long>(B) * (H + 2 * K) * (hd / 2)};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((a.pairs + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  return cudaLaunchKernelEx(&cfg, rope_kv_write_kernel, a);
}
