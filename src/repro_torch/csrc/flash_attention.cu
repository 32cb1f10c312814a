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
// main path's S = 512, hd = 64, H / K = 4 in bf16 the two floors are within
// 1.5x of each other (6.3 us bytes, 4.4 us operations), so what decides the
// time there is keeping 132 SMs busy and hiding load latency; from S ~ 2k
// on it is bound by operations, and only tensor cores get near that floor.
//
// Two kernels, chosen by the dtype (no fallback between them):
//
// bfloat16, `flash_bf16_kernel` (the main path), on the tensor cores with
// Hopper's warpgroup products.  A block is one warpgroup (4 warps) owning
// 64 query rows of one (b, head).  S = Q.K^T runs as wgmma m64n64k16 with
// both operands read from shared memory through descriptors; P.V runs as
// wgmma m64nHDk16 with P rounded to bf16 in registers as the A operand --
// the same rounding as the plain version's `p.to(q.dtype)` -- and V as the
// MN-major B operand, so no tile is transposed.  Accumulators are float32.
// Tiles sit in shared memory in the layout the descriptors name: rows of
// 128 bytes (64 bytes for hd 32) with their 16-byte chunks XOR-swizzled by
// row, hd 128 as two 64-column blocks.  K/V tiles of 64 keys stream
// through a 2-stage ring filled by cp.async 16-byte copies (rows past S
// read as zeros), so the next tile's copies are in flight while the
// current one is computed; a proxy fence makes the copies visible to the
// tensor cores.  Tiles wholly in the future or wholly behind the window
// are never loaded; the elementwise mask runs only on tiles that straddle
// the diagonal, the window's edge or S.  The online softmax runs in the
// log2 domain on the accumulator fragments (one FFMA and one ex2.approx
// per score: at hd 64 the exponentials cost about as much as the
// products), a row's max and sum reducing over the 4 lanes that share it.  Heavy (late) query tiles launch first,
// so the causal triangle leaves no tail of idle SMs.  Any S is taken.
// Loads by TMA, warp specialisation and GQA packing are later work.
//
// float32, `flash_f32_kernel`: products on the float32 CUDA cores (TF32 or
// bf16 products would miss fp32's 2e-5 tolerance).  A block of 128 threads
// owns 64 query rows, two threads per row; Q, K, V tiles are staged into
// padded float shared memory, with the same tile skipping and tail masking.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------- bfloat16
namespace bf16 {

constexpr int kThreads = 128;  // one warpgroup: 4 warps x 16 query rows
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory tile of 64 rows x HD bf16 in the canonical layout that
// wgmma's descriptors name: HD / AC column blocks of AC = min(HD, 64)
// elements, each block's rows AC * 2 bytes long (128 B: the 128-byte
// swizzle; 64 B for hd 32: the 64-byte swizzle) with their 16-byte chunks
// XOR-swizzled by row, so the 8 rows of a core matrix fall in distinct bank
// groups.  Tiles start on 1024-byte boundaries.
template <int HD>
struct Tile {
  static constexpr int AC = HD < 64 ? HD : 64;
  static constexpr int RB = AC * 2;                     // bytes per block row
  static constexpr int CPR = RB / 16;                   // chunks per block row
  static constexpr uint32_t kBlock = kBK * RB;          // bytes per column block
  static constexpr uint32_t kBytes = kBK * HD * 2;
  static constexpr uint64_t kSwizzle = RB == 128 ? 1 : 2;  // descriptor layout type
  static_assert(kBQ == kBK, "Q tiles share the K/V tile layout");

  // byte offset of chunk c (of HD / 8) of row r
  __device__ static uint32_t off(int r, int c) {
    const int blk = c / CPR;
    const int cc = c % CPR;
    const int pc = RB == 128 ? (cc ^ (r & 7)) : (cc ^ ((r >> 1) & 3));
    return blk * kBlock + r * RB + pc * 16;
  }
  // wgmma descriptor: start address, leading / stride byte offsets, swizzle
  __device__ static uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
           (kSwizzle << 62);
  }
  // K-major operand (Q as A, K as B of Q.K^T): columns 16 kk .. 16 kk + 15
  __device__ static uint64_t k_major(uint32_t tile, int kk) {
    const int e0 = 16 * kk;
    return desc(tile + (e0 / AC) * kBlock + (e0 % AC) * 2, 16, 8 * RB);
  }
  // MN-major operand (V as B of P.V): rows (keys) 16 kk .. 16 kk + 15, all
  // HD columns (the column blocks lie kBlock apart)
  __device__ static uint64_t mn_major(uint32_t tile, int kk) {
    return desc(tile + 16 * kk * RB, kBlock, 8 * RB);
  }
};

template <int HD>
constexpr size_t smem_bytes() {  // alignment slack + Q tile + 2 stages of K and V
  return 1024 + static_cast<size_t>(kBQ + 4 * kBK) * HD * 2;
}

// kBQ rows [r0, r0 + kBQ) of a (B, S, heads, HD) tensor's (b, ., head)
// slice -> tile, by cp.async; rows >= S are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* __restrict__ src,
                                          int b, int r0, int S, int heads, int head) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < kBQ * CH; i += kThreads) {
    const int r = i / CH;
    const int c = i % CH;
    const bool ok = r0 + r < S;
    const __nv_bfloat16* g =
        src + ((static_cast<size_t>(b) * S + (ok ? r0 + r : 0)) * heads + head) * HD + c * 8;
    cp_async16(tile + Tile<HD>::off(r, c), g, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of accumulator registers across the
// asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64 f32, this thread's 32) += A (64 x 16, smem) . B (16 x 64, smem),
// both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x N f32, this thread's N / 2) += A (64 x 16 bf16 in registers: each
// warp holds the mma.m16n8k16 A fragment of its 16 rows) . B (16 x N, smem,
// MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, "
      "%20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, "
      "%36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, "
      "%68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit, subnormal results flushed to zero
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                  int S, int H, int K, int causal, int window, float scale_log2) {
  using L = Tile<HD>;
  constexpr int KS = HD / 16;  // k-steps of Q.K^T
  constexpr int NT = kBK / 8;  // 8-key column groups of the scores
  constexpr int DT = HD / 8;   // 8-wide column groups of the output
  const int G = H / K;
  const int b = blockIdx.x / H;
  const int hq = blockIdx.x % H;
  const int kvh = hq / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // accumulator row within the warp's 8
  const int tig = lane & 3;   // accumulator column pair

  extern __shared__ unsigned char smem[];
  const uint32_t qs = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t kv0 = qs + L::kBytes;  // stage s: K at kv0 + 2 s kBytes, V after it

  const int nk = (S + kBK - 1) / kBK;
  int kt_end = nk;
  if (causal) kt_end = min(nk, (min(q0 + kBQ, S) - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  load_tile<HD>(qs, q, b, q0, S, H, hq);
  load_tile<HD>(kv0, k, b, kt_begin * kBK, S, K, kvh);
  load_tile<HD>(kv0 + L::kBytes, v, b, kt_begin * kBK, S, K, kvh);
  cp_async_commit();

  const int row_lo = q0 + warp * 16 + gid;  // this lane's two query rows
  const int row_hi = row_lo + 8;
  float o[HD / 2];  // wgmma accumulator: o[4 j + e] is column group j
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;  // log2 domain

  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int k0 = kt * kBK;
    if (kt + 1 < kt_end) {  // next tile -> the other stage, in flight meanwhile
      const uint32_t st = kv0 + ((it + 1) & 1) * 2 * L::kBytes;
      load_tile<HD>(st, k, b, k0 + kBK, S, K, kvh);
      load_tile<HD>(st + L::kBytes, v, b, k0 + kBK, S, K, kvh);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: this tile (and Q) landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    const uint32_t ks = kv0 + (it & 1) * 2 * L::kBytes;
    const uint32_t vs = ks + L::kBytes;

    // S = Q K^T (64 x 64), both operands from shared memory
    float s[NT * 4];
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) s[i] = 0.f;
    pin<NT * 4>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(s, L::k_major(qs, kk), L::k_major(ks, kk));
    wgmma_commit_and_wait();
    pin<NT * 4>(s);

    // mask only tiles that straddle an edge (raw scores; the scale is > 0)
    const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kBQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * tig + (e & 1);
          const int qp = e < 2 ? row_lo : row_hi;
          if (!(kp < S && (!causal || kp <= qp) && (window <= 0 || kp > qp - window)))
            s[4 * j + e] = -INFINITY;
        }
      }
    }

    // online softmax in the log2 domain; the 4 lanes of a quad share a row
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    mx_lo = fmaxf(m_lo, mx_lo * scale_log2);
    mx_hi = fmaxf(m_hi, mx_hi * scale_log2);
    const float base_lo = mx_lo == -INFINITY ? 0.f : mx_lo;  // fully masked so far
    const float base_hi = mx_hi == -INFINITY ? 0.f : mx_hi;
    const float corr_lo = exp2_ftz(m_lo - base_lo);
    const float corr_hi = exp2_ftz(m_hi - base_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[4 * j] = exp2_ftz(fmaf(s[4 * j], scale_log2, -base_lo));
      s[4 * j + 1] = exp2_ftz(fmaf(s[4 * j + 1], scale_log2, -base_lo));
      s[4 * j + 2] = exp2_ftz(fmaf(s[4 * j + 2], scale_log2, -base_hi));
      s[4 * j + 3] = exp2_ftz(fmaf(s[4 * j + 3], scale_log2, -base_hi));
      sum_lo += s[4 * j] + s[4 * j + 1];
      sum_hi += s[4 * j + 2] + s[4 * j + 3];
    }
    l_lo = l_lo * corr_lo + sum_lo;  // this lane's share; the quad sums at the end
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[4 * j] *= corr_lo;
      o[4 * j + 1] *= corr_lo;
      o[4 * j + 2] *= corr_hi;
      o[4 * j + 3] *= corr_hi;
    }

    // O += P V: P rounded to bf16 in registers as the A operand, V from
    // shared memory
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    pin<HD / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs<HD>(o, pa[kk], L::mn_major(vs, kk));
    wgmma_commit_and_wait();
    pin<HD / 2>(o);
    __syncthreads();  // this stage is refilled by the next iteration's copies
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* o_lo = out + ((static_cast<size_t>(b) * S + row_lo) * H + hq) * HD + 2 * tig;
  __nv_bfloat16* o_hi = out + ((static_cast<size_t>(b) * S + row_hi) * H + hq) * HD + 2 * tig;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    if (row_lo < S)
      *reinterpret_cast<uint32_t*>(o_lo + 8 * j) =
          pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
    if (row_hi < S)
      *reinterpret_cast<uint32_t*>(o_hi + 8 * j) =
          pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int H, int K, int causal, int window, cudaStream_t stream) {
  constexpr auto kernel = flash_bf16_kernel<HD>;
  cudaError_t err = allow_smem<kernel>(smem_bytes<HD>());
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem_bytes<HD>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, H, K,
      causal, window, kLog2e / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

}  // namespace bf16

// ---------------------------------------------------------------- float32
namespace f32 {

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
template <int HD>
__device__ __forceinline__ void stage(float* tile, const float* __restrict__ src, int b,
                                      int r0, int S, int heads, int head) {
  constexpr int VEC = 4;
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S, int H,
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

  stage<HD>(qs, q, b, q0, S, H, hq);

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
    stage<HD>(ks, k, b, k0, S, K, kvh);
    stage<HD>(vs, v, b, k0, S, K, kvh);
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
    float* o = out + ((static_cast<size_t>(b) * S + qp) * H + hq) * HD;
#pragma unroll
    for (int j = 0; j < ND; ++j) o[half + 2 * j] = acc[j] * inv;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int H, int K, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  constexpr auto kernel = flash_f32_kernel<HD>;
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, K, causal, window,
      1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// q (B, S, H, hd); k, v (B, S, K, hd); out like q.  All contiguous on the
// device.  The dtype picks the kernel: bfloat16 the tensor-core one, float32
// the CUDA-core one.  Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int S, int H, int K, int hd,
                                      int causal, int window, int dtype, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    switch (hd) {
      case 32: return bf16::launch<32>(q, k, v, out, B, S, H, K, causal, window, s);
      case 64: return bf16::launch<64>(q, k, v, out, B, S, H, K, causal, window, s);
      case 128: return bf16::launch<128>(q, k, v, out, B, S, H, K, causal, window, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == kFloat32) {
    switch (hd) {
      case 32: return f32::launch<32>(q, k, v, out, B, S, H, K, causal, window, s);
      case 64: return f32::launch<64>(q, k, v, out, B, S, H, K, causal, window, s);
      case 128: return f32::launch<128>(q, k, v, out, B, S, H, K, causal, window, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
