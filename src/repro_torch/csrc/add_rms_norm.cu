// Residual add and RMSNorm of a paged decode step's layer, for Hopper
// (sm_90a): one launch where the step ran ten.
//
// Replaces no TPU kernel: the reference's decode step
// (src/repro/serving/engine.py `_paged_decode_step`) adds each sub-block's
// output to the residual stream and normalises it with `rms_norm`, which XLA
// fuses.  In PyTorch the same chain is separate kernels: the add, then
// `common.rms_norm`'s nine (the cast to float32, the square, the mean, the
// `+ eps`, the rsqrt, a product, `1 + scale`, a product, the cast back).
// A layer has two such chains, so a step of L layers ran 20 L + 9 kernels
// that each move a few kilobytes at batch 1; it pays their launches and
// gaps, not their bytes.  The step now makes 2 L + 1 launches of this
// kernel (one norm-only call on the embedding, then one after each
// sub-block, the last with the final norm's scale):
//
//   h_out = h + delta                     (skipped where delta is null)
//   x     = rms_norm(h_out, scale, eps)
//
// Same arithmetic as the PyTorch chain: the sum in float32 rounded to
// bfloat16; the squares of the rounded sum summed in float32, multiplied by
// the float factor 1 / D (PyTorch's mean multiplies, it does not divide),
// `+ eps` and `rsqrtf`; then (x r) (1 + s), each product and sum rounded in
// float32 as its own kernel rounds it (`__fmul_rn`, `__fadd_rn`, which the
// compiler never contracts into an FMA), and one round to bfloat16.  Only
// the order of the sum over D differs from PyTorch's reduction, so h_out is
// the chain's to the bit and x is within one bfloat16 step of it.
//
// What bounds it: its launch.  At deepseek-7b's D 4096, B 1 it moves 48 KB
// (h and delta read, h_out and x written, the scale read), 15 ns at
// 3.35 TB/s.  One block a row; each thread holds one 16-byte vector of h
// and of delta (8 values) in registers, so every load is issued at once;
// the sum of squares is reduced within each warp by shuffles, then across
// the warps through shared memory.  Threads = D / 8 rounded up to a warp,
// at most 1024 (D up to 8192); the grid and the block come from the static
// shapes, so a call never syncs and captures into a CUDA graph.
#include "common.cuh"

namespace {

constexpr int kVec = 8;  // bfloat16 values in a 16-byte vector
constexpr int kMaxThreads = 1024;
constexpr int kWarp = 32;

struct Args {
  const __nv_bfloat16* h;      // (R, D)
  const __nv_bfloat16* delta;  // (R, D), or null: norm only
  const float* scale;          // (D,)
  __nv_bfloat16* h_out;        // (R, D); unused where delta is null
  __nv_bfloat16* x;            // (R, D)
  int vecs;                    // D / 8
  float inv_d;                 // 1 / D as a float, PyTorch's mean factor
  float eps;
};

union Pack {
  uint4 raw;
  __nv_bfloat16 v[kVec];
};

// Block r normalises row r; thread t owns its values [8 t, 8 t + 8).
__global__ void __launch_bounds__(kMaxThreads) add_rms_norm_kernel(const Args a) {
  __shared__ float warp_sums[kMaxThreads / kWarp];
  const int t = threadIdx.x;
  const bool live = t < a.vecs;
  const size_t off = (static_cast<size_t>(blockIdx.x) * a.vecs + t) * kVec;
  float v[kVec];
  float ss = 0.0f;
  if (live) {
    Pack p;
    p.raw = __ldg(reinterpret_cast<const uint4*>(a.h + off));
    if (a.delta != nullptr) {
      Pack d;
      d.raw = __ldg(reinterpret_cast<const uint4*>(a.delta + off));
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        p.v[i] = __float2bfloat16_rn(
            __fadd_rn(__bfloat162float(p.v[i]), __bfloat162float(d.v[i])));
      *reinterpret_cast<uint4*>(a.h_out + off) = p.raw;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      v[i] = __bfloat162float(p.v[i]);
      ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
    }
  }
  // Every lane of a xor butterfly adds the same pairs, so all lanes (and,
  // below, all warps) end with the same bits.
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(~0u, ss, o));
  const int lane = t % kWarp;
  if (lane == 0) warp_sums[t / kWarp] = ss;
  __syncthreads();
  float total = lane < static_cast<int>(blockDim.x) / kWarp ? warp_sums[lane] : 0.0f;
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    total = __fadd_rn(total, __shfl_xor_sync(~0u, total, o));
  if (!live) return;
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, a.inv_d), a.eps));
  const float4* s4 = reinterpret_cast<const float4*>(a.scale) + 2 * t;
  const float4 s0 = __ldg(s4), s1 = __ldg(s4 + 1);
  const float s[kVec] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  Pack out;
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    out.v[i] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(v[i], r), __fadd_rn(1.0f, s[i])));
  *reinterpret_cast<uint4*>(a.x + off) = out.raw;
}

}  // namespace

// x (rows, D) = rms_norm(h + delta) and h_out (rows, D) = h + delta, from
// h, delta (rows, D) bfloat16 (delta null: x = rms_norm(h), h_out unused)
// and scale (D,) float32.  D a multiple of 8, at most 8192.  Returns a
// cudaError_t.
extern "C" int add_rms_norm_launch(const void* h, const void* delta, const void* scale,
                                   void* h_out, void* x, int rows, int D, float eps,
                                   void* stream) {
  if (rows == 0) return cudaSuccess;
  if (rows < 0 || D <= 0 || D % kVec || D / kVec > kMaxThreads) return cudaErrorInvalidValue;
  const int vecs = D / kVec;
  const Args a{static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(delta),
               static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(h_out),
               static_cast<__nv_bfloat16*>(x), vecs, 1.0f / static_cast<float>(D), eps};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows));
  cfg.blockDim = dim3(static_cast<unsigned>((vecs + kWarp - 1) / kWarp * kWarp));
  cfg.stream = static_cast<cudaStream_t>(stream);
  return cudaLaunchKernelEx(&cfg, add_rms_norm_kernel, a);
}
