// E-Attention paged decode attention for Hopper (sm_90a): one launch a call.
//
// Replaces the TPU Pallas kernel `paged_attention` / `_kernel` in
// src/repro/kernels/paged_attention.py (pallas_call at line 120).
//
// What it computes: for every sequence b and kv head kh, the G = H / K query
// rows of that head attend over the sequence's first lengths[b] tokens,
// which live in the pages tables[b, 0..] of a (P, T, K, hd) slab.  Scale
// 1/sqrt(hd), positions >= lengths[b] masked, online softmax in float32
// (m, l, acc), out = acc / max(l, 1e-30) in the input dtype; length 0
// gives zeros.  In bfloat16 the probabilities are rounded to bfloat16
// before P.V, as the plain version rounds them.
//
// What bounds it on an H100: latency.  Its bytes (lengths[b] * hd * 2 K and
// V elements per (b, kh)) take 0.2-2.5 us at 3.35 TB/s on the served shapes
// and its operations far less, so the time is the launch plus the chain of
// dependent memory round trips a block makes (length, table entries, K and
// V rows, partials, the merge).  The design keeps that chain short and
// every SM busy:
//
//  - One launch, grid (splits, K * row groups, B).  The context is cut into
//    splits of `split_tokens` tokens (whole pages; `split_plan` in the
//    wrapper sizes them from the static shapes and the SM count, never from
//    `lengths`, so the host reads nothing back).  A block whose split starts
//    at or past lengths[b] exits before it reads a table entry, and no block
//    reads an entry at or past ceil(len / T).  A sequence with one live
//    split is written by its block directly.  Otherwise each block writes
//    its (m, l, acc) to float32 scratch, fences, and takes a ticket from an
//    int32 counter of its (b, kv head, row group) with atomicAdd; the block
//    that draws the last ticket merges the live splits in index order
//    (never atomics on the output: a graph replay is bitwise the eager
//    call) and puts the counter back to 0, so every launch, replays
//    included, finds it at 0.  The counters are a per-device buffer the
//    wrapper allocates once, outside any capture and outside PyTorch's
//    caching allocator; launches on it are ordered by the compute stream.
//  - K and V rows stream into shared memory by cp.async, 16 bytes a lane,
//    neighbouring lanes on neighbouring pieces of a row, rows padded by 16
//    bytes so that ldmatrix reads them without bank conflicts.  A stage
//    holds 64 tokens (four warps x 16); a split longer than one stage runs
//    a two-stage ring, the next stage's loads in flight while this one's
//    products run.  Masked slots are zero-filled.
//  - bfloat16 ("mma" core): the G query rows of a kv head are padded to
//    16 and Q.K^T and P.V run as mma.sync m16n8k16 bf16 products with
//    float32 accumulators.  Each warp owns 16 tokens of a stage and keeps
//    its own online softmax; the four warps are merged through shared
//    memory at the end of the split.  P is rounded to bf16 in registers
//    and reused as the A operand of P.V (the accumulator layout of two
//    n8 tiles is the A layout of one k16 step).
//  - float32 ("simt" core): CUDA-core dot products over the same ring
//    (TF32 would miss 2e-5): scores one thread per (token, row pair), the
//    stage's softmax one warp per row, P.V one thread per (dim, row set).
//    bfloat16 takes mma at every G, G 1 too: its 16-row tile of one real
//    row beat these dot products 2.3-2.6x on an H100 (PERF.md).
//
// Latent mode (`paged_latent_launch`): the decode attention of absorbed
// multi-head latent attention (DeepSeek-V2).  One kv head of W = 576
// values a token (the latent row [c | k_pe]) is K, its first V = 512
// columns are V, and the H query heads of a sequence attend to it at the
// caller's scale; out (B, H, 512).  At B 1 it reads lengths[b] * 1152
// bytes a layer (18.9 MB at 16k tokens) and does 2 * 16 * (576 + 512)
// operations a token, so it is bound by bytes, and with one kv head the
// context's splits alone are the grid: `latent_split_plan` in the wrapper
// cuts a full table into about two blocks an SM.  Per block (split,
// 16-row group, b), 4 warps:
//  - the 16 query rows sit in shared memory; the split's latent rows
//    stream in 64-token stages (two-stage cp.async ring, rows padded by 16
//    bytes for ldmatrix), 74.8 KB a stage;
//  - Q.K^T: each warp scores 16 tokens of the stage over the 576 columns
//    (36 mma.sync m16n8k16 steps), the scaled, masked scores go to shared
//    memory;
//  - every warp reads the stage's 16 x 64 scores back, keeps the same
//    online softmax (so no warp waits on another's max), rounds P to bf16
//    as the A operand, and runs P.V over all 64 tokens for its own 128 of
//    the 512 output columns: the output tile stays 64 float registers a
//    thread, where owning tokens would take 256;
//  - a sequence with one live split writes its output; otherwise each live
//    split writes float32 partials (m, l, acc) and a second kernel, the
//    merge instance, combines them: grid (16 column slices of 32, H, B), a
//    block's 16 lanes of splits each walk a sixteenth of them, 8 loads at a
//    time, and fold through shared memory.  Spread over 256 blocks the
//    merge is about one group of L2 round trips long, where one block
//    merging 129 partials of 32 KB would take longer than the split kernel.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // tokens of one ring stage: 16 a warp
constexpr int kRows = 16;   // query rows of a block: the M of an mma tile

enum Core : int { kMma = 0, kSimt = 1, kLatent = 2, kMerge = 3 };

constexpr int kLatW = 576;  // latent mode: q/k width, [c (512) | k_pe (64)]
constexpr int kLatV = 512;  // latent mode: v width, the rows' first columns

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* tables;
  const int* lengths;
  void* out;
  float* part_acc;  // (B, H, splits, hd)
  float* part_m;    // (B, H, splits)
  float* part_l;
  int* counters;  // (B, K * groups), 0 between launches
  int H, K, G, groups, T, N, split_tokens, splits;
  float scale;
};

// Shared memory of a block: the ring, the split's result (acc, m, l of 16
// rows), the core's own buffers, a flag and the split's page ids.
template <typename T, int HD, int CORE>
struct Smem {
  static constexpr int RS = HD + 16 / static_cast<int>(sizeof(T));  // ring row stride
  static constexpr size_t kStage = size_t(2) * kChunk * RS * sizeof(T);  // K and V rows
  static constexpr size_t kRes = size_t(kRows) * HD * 4 + 2 * kRows * 4;
  static constexpr size_t kCore =
      CORE == kMma ? size_t(2) * kWarps * kRows * 4  // each warp's m and l
                   : size_t(kRows) * HD * 4 + size_t(kRows) * kChunk * 4 + 3 * kRows * 4;
  static size_t bytes(int stages, int pages) {
    return stages * kStage + kRes + kCore + 16 + size_t(pages) * 4;
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}
// c += a (16x16, row) . b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
// The probability as P.V consumes it: rounded to the input dtype.
template <typename T> __device__ __forceinline__ float as_input(float p) {
  return to_float(from_float<T>(p));
}

// The 16 x HD query tile of rows [0, rows) as mma A fragments, zero-padded.
template <int HD>
__device__ __forceinline__ void load_q_frags(const __nv_bfloat16* qb, int rows,
                                             uint32_t (&qa)[HD / 16][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(qb + g * HD);
  const uint32_t* r1 = reinterpret_cast<const uint32_t*>(qb + (g + 8) * HD);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = (ks * 16 + 2 * t) / 2;  // in bf16 pairs
    qa[ks][0] = g < rows ? __ldg(r0 + c) : 0u;
    qa[ks][1] = g + 8 < rows ? __ldg(r1 + c) : 0u;
    qa[ks][2] = g < rows ? __ldg(r0 + c + 4) : 0u;
    qa[ks][3] = g + 8 < rows ? __ldg(r1 + c + 4) : 0u;
  }
}

// One split of one (b, kv head, row group) through the bf16 tensor cores.
// `issue(c, stage)` starts the cp.async loads of chunk c; on return `res`,
// `resm`, `resl` hold the split's acc, m and l of rows [0, rows).
template <int HD, typename Issue>
__device__ __forceinline__ void mma_core(const Args& a, const __nv_bfloat16* qb, int rows,
                                         int n, int stages, __nv_bfloat16* ring,
                                         float* core, float* res, float* resm, float* resl,
                                         Issue issue) {
  using S = Smem<__nv_bfloat16, HD, kMma>;
  constexpr int RS = S::RS;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  uint32_t qa[HD / 16][4];
  load_q_frags<HD>(qb, rows, qa);
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const int chunks = (n + kChunk - 1) / kChunk;
  issue(0, 0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      issue(c + 1, (c + 1) % stages);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int base = c * kChunk + w * 16;  // the warp's first token in the split
    if (base < n) {  // warp-uniform
      const __nv_bfloat16* ks = ring + (c % stages) * (2 * kChunk * RS) + w * 16 * RS;
      const __nv_bfloat16* vs = ks + kChunk * RS;
      float s[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_addr(ks + ((lane >> 4) * 8 + (lane & 7)) * RS + kk * 16 +
                          ((lane >> 3) & 1) * 8),
                b0, b1, b2, b3);
        mma_bf16(s[0], qa[kk], b0, b1);
        mma_bf16(s[1], qa[kk], b2, b3);
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = base + nt * 8 + 2 * t + (e & 1);
          s[nt][e] = tok < n ? s[nt][e] * a.scale : -INFINITY;
          if (e < 2) mx0 = fmaxf(mx0, s[nt][e]);
          else mx1 = fmaxf(mx1, s[nt][e]);
        }
      const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
      const float z0 = n0 == -INFINITY ? 0.f : n0, z1 = n1 == -INFINITY ? 0.f : n1;
      const float al0 = expf(m0 - z0), al1 = expf(m1 - z1);
      m0 = n0;
      m1 = n1;
      float p[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nt][e] = expf(s[nt][e] - (e < 2 ? z0 : z1));
      l0 = l0 * al0 + p[0][0] + p[0][1] + p[1][0] + p[1][1];
      l1 = l1 * al1 + p[0][2] + p[0][3] + p[1][2] + p[1][3];
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        o[2 * dp][0] *= al0; o[2 * dp][1] *= al0; o[2 * dp][2] *= al1; o[2 * dp][3] *= al1;
        o[2 * dp + 1][0] *= al0; o[2 * dp + 1][1] *= al0;
        o[2 * dp + 1][2] *= al1; o[2 * dp + 1][3] *= al1;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_addr(vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * RS + dp * 16 +
                                (lane >> 4) * 8),
                      b0, b1, b2, b3);
        mma_bf16(o[2 * dp], pa, b0, b1);
        mma_bf16(o[2 * dp + 1], pa, b2, b3);
      }
    }
    __syncthreads();  // the stage is free for the load after next
  }
  // merge the four warps: each warp's m and l, then its acc rows through the
  // ring (no longer read), weighted by exp(m_w - max)
  float* wm = core;
  float* wl = core + kWarps * kRows;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (t == 0) {
    wm[w * kRows + g] = m0;
    wm[w * kRows + g + 8] = m1;
    wl[w * kRows + g] = l0;
    wl[w * kRows + g + 8] = l1;
  }
  constexpr int OS = HD + 8;  // float row stride of the warps' acc rows
  static_assert(size_t(kWarps) * kRows * OS * 4 <= S::kStage, "acc rows fit one stage");
  float* ob = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    *reinterpret_cast<float2*>(ob + (w * kRows + g) * OS + col) = make_float2(o[dt][0], o[dt][1]);
    *reinterpret_cast<float2*>(ob + (w * kRows + g + 8) * OS + col) =
        make_float2(o[dt][2], o[dt][3]);
  }
  __syncthreads();
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, wm[v * kRows + r]);
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float mv = wm[v * kRows + r];
      const float f = mv == -INFINITY ? 0.f : expf(mv - mx);
      acc += f * ob[(v * kRows + r) * OS + d];
      l += f * wl[v * kRows + r];
    }
    res[r * HD + d] = acc;
    if (d == 0) {
      resm[r] = mx;
      resl[r] = l;
    }
  }
  __syncthreads();
}

// The same on the CUDA cores, for float32.
template <typename T, int HD, typename Issue>
__device__ __forceinline__ void simt_core(const Args& a, const T* qb, int rows, int n,
                                          int stages, T* ring, float* core, float* res,
                                          float* resm, float* resl, Issue issue) {
  using S = Smem<T, HD, kSimt>;
  constexpr int RS = S::RS;
  constexpr int VEC = VecWidth<T>::N;
  constexpr int RSTEP = kThreads / HD;  // rows between a thread's P.V rows
  constexpr int NACC = kRows / RSTEP;
  static_assert(kThreads % HD == 0 && kThreads == 2 * kChunk, "thread mapping");
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  float* qf = core;                 // [kRows][HD]
  float* sc = qf + kRows * HD;      // [kRows][kChunk]
  float* sm = sc + kRows * kChunk;  // running max, sum and this stage's rescale
  float* sl = sm + kRows;
  float* sa = sl + kRows;
  for (int i = tid; i < rows * HD / VEC; i += kThreads) load_vec(qb + i * VEC, qf + i * VEC);
  if (tid < kRows) {
    sm[tid] = -INFINITY;
    sl[tid] = 0.f;
  }
  const int d = tid % HD, r0 = tid / HD;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  const int chunks = (n + kChunk - 1) / kChunk;
  issue(0, 0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      issue(c + 1, (c + 1) % stages);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = ring + (c % stages) * (2 * kChunk * RS);
    const T* vs = ks + kChunk * RS;
    {  // scores: token j of the stage against rows gp, gp + 2, ...
      const int j = tid % kChunk, gp = tid / kChunk;
      float s[kRows / 2];
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) s[i] = 0.f;
      const T* kr = ks + j * RS;
#pragma unroll 4
      for (int p = 0; p < HD / VEC; ++p) {
        float kf[VEC];
        unpack_vec<T>(*reinterpret_cast<const uint4*>(kr + p * VEC), kf);
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) {
          if (gp + 2 * i < rows) {
            const float* qq = qf + (gp + 2 * i) * HD + p * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e) s[i] += qq[e] * kf[e];
          }
        }
      }
      const bool live = c * kChunk + j < n;
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i)
        if (gp + 2 * i < rows) sc[(gp + 2 * i) * kChunk + j] = live ? s[i] * a.scale : -INFINITY;
    }
    __syncthreads();
    for (int r = w; r < rows; r += kWarps) {  // the stage's softmax, one warp a row
      float* sr = sc + r * kChunk;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mo = sm[r];
      const float mn = fmaxf(mo, mx);
      const float z = mn == -INFINITY ? 0.f : mn;
      const float p0 = expf(x0 - z), p1 = expf(x1 - z);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sr[lane] = as_input<T>(p0);
      sr[lane + 32] = as_input<T>(p1);
      __syncwarp();
      if (lane == 0) {
        const float al = expf(mo - z);
        sa[r] = al;
        sl[r] = sl[r] * al + sum;
        sm[r] = mn;
      }
    }
    __syncthreads();
    const int nj = min(kChunk, n - c * kChunk);
#pragma unroll
    for (int i = 0; i < NACC; ++i)
      if (r0 + i * RSTEP < rows) acc[i] *= sa[r0 + i * RSTEP];
    for (int j = 0; j < nj; ++j) {  // P.V
      const float v = to_float(vs[j * RS + d]);
#pragma unroll
      for (int i = 0; i < NACC; ++i)
        if (r0 + i * RSTEP < rows) acc[i] += sc[(r0 + i * RSTEP) * kChunk + j] * v;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i)
    if (r0 + i * RSTEP < rows) res[(r0 + i * RSTEP) * HD + d] = acc[i];
  if (tid < rows) {
    resm[tid] = sm[tid];
    resl[tid] = sl[tid];
  }
  __syncthreads();
}


// ------------------------------------------------------------ latent mode
namespace latent {

constexpr int RS = kLatW + 8;          // Q and ring row stride (bf16): 16 bytes of pad
constexpr int kSC = kChunk + 4;        // score row stride (floats)
constexpr int kCols = kLatV / kWarps;  // output columns a warp owns
constexpr int kSlice = 32;             // output columns a merge block folds
constexpr int kMergeLanes = kThreads / (kSlice / 4);  // splits a merge block walks at once

__host__ __device__ constexpr size_t smem_bytes(int stages, int pages) {
  return size_t(kRows) * RS * 2 + size_t(stages) * kChunk * RS * 2 +
         size_t(kRows) * kSC * 4 + size_t(pages) * 4;
}

// One split of one (b, 16-row group): see the source note.
__device__ __forceinline__ void split_kernel(const Args& a, int stages) {
  using bf16 = __nv_bfloat16;
  const int split = blockIdx.x, hb = blockIdx.y, b = blockIdx.z;
  const int h0 = hb * kRows;
  const int rows = min(kRows, a.H - h0);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  bf16* out = static_cast<bf16*>(a.out) + (static_cast<size_t>(b) * a.H + h0) * kLatV;

  const int len = min(a.lengths[b], a.N * a.T);
  if (len <= 0) {
    if (split == 0)
      for (int i = tid; i < rows * kLatV; i += kThreads) out[i] = __float2bfloat16_rn(0.f);
    return;
  }
  const int s0 = split * a.split_tokens;
  if (s0 >= len) return;  // dead split: touches no table entry
  const int n = min(a.split_tokens, len - s0);
  const int live = (len + a.split_tokens - 1) / a.split_tokens;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][RS]
  bf16* ring = qs + kRows * RS;                  // [stages][kChunk][RS]
  float* sc = reinterpret_cast<float*>(ring + stages * kChunk * RS);  // [kRows][kSC]
  int* pg = reinterpret_cast<int*>(sc + kRows * kSC);

  const int npages = (n + a.T - 1) / a.T;
  const int* tb = a.tables + static_cast<size_t>(b) * a.N + s0 / a.T;
  for (int i = tid; i < npages; i += kThreads) pg[i] = tb[i];
  // the query rows (zeros past `rows`), in the first stage's copy group
  const bf16* qg = static_cast<const bf16*>(a.q) + (static_cast<size_t>(b) * a.H + h0) * kLatW;
  for (int i = tid; i < kRows * (kLatW / 8); i += kThreads) {
    const int r = i / (kLatW / 8), p = i % (kLatW / 8);
    const bool in = r < rows;
    cp_async16(smem_addr(qs + r * RS + p * 8), qg + (in ? r * kLatW + p * 8 : 0), in ? 16 : 0);
  }
  __syncthreads();

  const bf16* base = static_cast<const bf16*>(a.k_pages);
  auto issue = [&](int c, int stage) {  // chunk c's latent rows -> ring stage
    bf16* rs = ring + stage * kChunk * RS;
    for (int i = tid; i < kChunk * (kLatW / 8); i += kThreads) {
      const int j = i / (kLatW / 8), p = i % (kLatW / 8);
      const int tok = c * kChunk + j;
      const uint32_t d = smem_addr(rs + j * RS + p * 8);
      if (tok < n)
        cp_async16(d, base + (static_cast<size_t>(pg[tok / a.T]) * a.T + tok % a.T) * kLatW +
                          p * 8);
      else
        cp_async16(d, base, 0);
    }
    cp_async_commit();
  };

  float o[kCols / 8][4];
#pragma unroll
  for (int i = 0; i < kCols / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const int chunks = (n + kChunk - 1) / kChunk;
  issue(0, 0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      issue(c + 1, (c + 1) % stages);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = ring + (c % stages) * kChunk * RS;
    {  // Q.K^T of the warp's 16 tokens, scaled and masked, into `sc`
      // two accumulator pairs, even and odd k-steps, halve the chain of
      // dependent products
      float s[2][4] = {}, s2[2][4] = {};
      if (c * kChunk + w * 16 < n) {  // warp-uniform
        const bf16* kw = ks + w * 16 * RS;
#pragma unroll 2
        for (int kk = 0; kk < kLatW / 16; kk += 2) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t qa[4], b0, b1, b2, b3;
            ldsm_x4(smem_addr(qs + (lane & 15) * RS + (kk + h) * 16 + (lane >> 4) * 8), qa[0],
                    qa[1], qa[2], qa[3]);
            ldsm_x4(smem_addr(kw + ((lane >> 4) * 8 + (lane & 7)) * RS + (kk + h) * 16 +
                              ((lane >> 3) & 1) * 8),
                    b0, b1, b2, b3);
            mma_bf16(h ? s2[0] : s[0], qa, b0, b1);
            mma_bf16(h ? s2[1] : s[1], qa, b2, b3);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] += s2[nt][e];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = w * 16 + nt * 8 + 2 * t + (e & 1);
          sc[(g + (e >> 1) * 8) * kSC + j] = c * kChunk + j < n ? s[nt][e] * a.scale : -INFINITY;
        }
    }
    __syncthreads();
    // the stage's online softmax, the same in every warp; P as mma A fragments
    float sv[kChunk / 16][8];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const int c0 = kk * 16 + 2 * t;
      const float* r0 = sc + g * kSC + c0;
      const float* r1 = sc + (g + 8) * kSC + c0;
      sv[kk][0] = r0[0]; sv[kk][1] = r0[1]; sv[kk][2] = r1[0]; sv[kk][3] = r1[1];
      sv[kk][4] = r0[8]; sv[kk][5] = r0[9]; sv[kk][6] = r1[8]; sv[kk][7] = r1[9];
      mx0 = fmaxf(mx0, fmaxf(fmaxf(sv[kk][0], sv[kk][1]), fmaxf(sv[kk][4], sv[kk][5])));
      mx1 = fmaxf(mx1, fmaxf(fmaxf(sv[kk][2], sv[kk][3]), fmaxf(sv[kk][6], sv[kk][7])));
    }
    const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
    const float z0 = n0 == -INFINITY ? 0.f : n0, z1 = n1 == -INFINITY ? 0.f : n1;
    const float al0 = expf(m0 - z0), al1 = expf(m1 - z1);
    m0 = n0;
    m1 = n1;
    uint32_t pa[kChunk / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) p[e] = expf(sv[kk][e] - ((e >> 1) & 1 ? z1 : z0));
      ps0 += p[0] + p[1] + p[4] + p[5];
      ps1 += p[2] + p[3] + p[6] + p[7];
      pa[kk][0] = pack_bf16(p[0], p[1]);
      pa[kk][1] = pack_bf16(p[2], p[3]);
      pa[kk][2] = pack_bf16(p[4], p[5]);
      pa[kk][3] = pack_bf16(p[6], p[7]);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      o[nt][0] *= al0;
      o[nt][1] *= al0;
      o[nt][2] *= al1;
      o[nt][3] *= al1;
    }
    // P.V over the stage's 64 tokens, the warp's kCols columns
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const bf16* vs = ks + kk * 16 * RS + w * kCols;
#pragma unroll
      for (int dp = 0; dp < kCols / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_addr(vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * RS + dp * 16 +
                                (lane >> 4) * 8),
                      b0, b1, b2, b3);
        mma_bf16(o[2 * dp], pa[kk], b0, b1);
        mma_bf16(o[2 * dp + 1], pa[kk], b2, b3);
      }
    }
    __syncthreads();  // the stage and the scores are free
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int col0 = w * kCols + 2 * t;
  if (live == 1) {  // the only live split: the output directly
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      if (g < rows)
        *reinterpret_cast<uint32_t*>(out + g * kLatV + col0 + nt * 8) =
            pack_bf16(o[nt][0] * i0, o[nt][1] * i0);
      if (g + 8 < rows)
        *reinterpret_cast<uint32_t*>(out + (g + 8) * kLatV + col0 + nt * 8) =
            pack_bf16(o[nt][2] * i1, o[nt][3] * i1);
    }
    return;
  }
  const size_t hrow = static_cast<size_t>(b) * a.H + h0;
  float* acc0 = a.part_acc + ((hrow + g) * a.splits + split) * kLatV + col0;
  float* acc1 = a.part_acc + ((hrow + g + 8) * a.splits + split) * kLatV + col0;
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt) {
    if (g < rows) *reinterpret_cast<float2*>(acc0 + nt * 8) = make_float2(o[nt][0], o[nt][1]);
    if (g + 8 < rows)
      *reinterpret_cast<float2*>(acc1 + nt * 8) = make_float2(o[nt][2], o[nt][3]);
  }
  if (w == 0 && t == 0) {
    if (g < rows) {
      a.part_m[(hrow + g) * a.splits + split] = m0;
      a.part_l[(hrow + g) * a.splits + split] = l0;
    }
    if (g + 8 < rows) {
      a.part_m[(hrow + g + 8) * a.splits + split] = m1;
      a.part_l[(hrow + g + 8) * a.splits + split] = l1;
    }
  }
}

// The merge of a sequence's live splits: block (column slice, head, b); a
// thread holds 4 columns and walks splits j, j + kMergeLanes, ..., eight
// loads at a time, then the block folds its kMergeLanes partial sums.
__device__ __forceinline__ void merge_kernel(const Args& a) {
  constexpr int C4 = kSlice / 4;  // float4 columns of the slice
  constexpr int kGroup = 8;
  const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = min(a.lengths[b], a.N * a.T);
  const int live = len <= 0 ? 0 : (len + a.split_tokens - 1) / a.split_tokens;
  if (live <= 1) return;  // written by the split kernel
  const int lane = threadIdx.x % C4, j = threadIdx.x / C4;
  const size_t hrow = static_cast<size_t>(b) * a.H + h;
  const float* pm = a.part_m + hrow * a.splits;
  const float* pl = a.part_l + hrow * a.splits;
  const float4* pa =
      reinterpret_cast<const float4*>(a.part_acc + hrow * a.splits * kLatV) + slice * C4 + lane;
  float mx = -INFINITY, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = j; s0 < live; s0 += kMergeLanes * kGroup) {
    float ms[kGroup], ls[kGroup];
    float4 v[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int s = s0 + q * kMergeLanes;
      const bool in = s < live;
      ms[q] = in ? __ldcg(pm + s) : -INFINITY;
      ls[q] = in ? __ldcg(pl + s) : 0.f;
      v[q] = in ? __ldcg(pa + static_cast<size_t>(s) * (kLatV / 4)) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float mn = mx;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) mn = fmaxf(mn, ms[q]);  // finite: split s0 is live
    const float f = expf(mx - mn);
    acc.x *= f;
    acc.y *= f;
    acc.z *= f;
    acc.w *= f;
    l *= f;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const float e = expf(ms[q] - mn);
      acc.x += v[q].x * e;
      acc.y += v[q].y * e;
      acc.z += v[q].z * e;
      acc.w += v[q].w * e;
      l += ls[q] * e;
    }
    mx = mn;
  }
  __shared__ float sm[kMergeLanes][C4], sl[kMergeLanes][C4];
  __shared__ float4 sa[kMergeLanes][C4];
  sm[j][lane] = mx;
  sl[j][lane] = l;
  sa[j][lane] = acc;
  __syncthreads();
  if (j != 0) return;
  float M = -INFINITY;
#pragma unroll
  for (int q = 0; q < kMergeLanes; ++q) M = fmaxf(M, sm[q][lane]);
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
  float L = 0.f;
#pragma unroll
  for (int q = 0; q < kMergeLanes; ++q) {
    const float e = sm[q][lane] == -INFINITY ? 0.f : expf(sm[q][lane] - M);
    A.x += sa[q][lane].x * e;
    A.y += sa[q][lane].y * e;
    A.z += sa[q][lane].z * e;
    A.w += sa[q][lane].w * e;
    L += sl[q][lane] * e;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) + hrow * kLatV + slice * kSlice + 4 * lane;
  *reinterpret_cast<uint32_t*>(o) = pack_bf16(A.x * inv, A.y * inv);
  *reinterpret_cast<uint32_t*>(o + 2) = pack_bf16(A.z * inv, A.w * inv);
}

}  // namespace latent

template <typename T, int HD, int CORE>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Args a, int stages) {
  if constexpr (CORE == kLatent) {
    latent::split_kernel(a, stages);
    return;
  } else if constexpr (CORE == kMerge) {
    latent::merge_kernel(a);
    return;
  } else {
  using S = Smem<T, HD, CORE>;
  constexpr int RS = S::RS;
  const int split = blockIdx.x, hb = blockIdx.y, b = blockIdx.z;
  const int kh = hb / a.groups;
  const int h0 = kh * a.G + (hb % a.groups) * kRows;  // the block's first query head
  const int rows = min(kRows, a.G - (hb % a.groups) * kRows);
  const int tid = threadIdx.x;
  T* out = static_cast<T*>(a.out) + (static_cast<size_t>(b) * a.H + h0) * HD;

  const int len = min(a.lengths[b], a.N * a.T);  // the plain version masks past N * T
  if (len <= 0) {  // zeros, written by the first split's block
    if (split == 0)
      for (int i = tid; i < rows * HD; i += kThreads) out[i] = from_float<T>(0.f);
    return;
  }
  const int s0 = split * a.split_tokens;
  if (s0 >= len) return;  // dead split: touches no table entry
  const int n = min(a.split_tokens, len - s0);
  const int live = (len + a.split_tokens - 1) / a.split_tokens;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* res = reinterpret_cast<float*>(smem_raw + stages * S::kStage);  // [kRows][HD]
  float* resm = res + kRows * HD;
  float* resl = resm + kRows;
  float* core = resl + kRows;
  int* flag = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(core) + S::kCore);
  int* pg = flag + 4;  // the split's page ids

  const int npages = (n + a.T - 1) / a.T;  // entries below ceil(len / T) only
  const int* tb = a.tables + static_cast<size_t>(b) * a.N + s0 / a.T;
  for (int i = tid; i < npages; i += kThreads) pg[i] = tb[i];
  __syncthreads();

  const size_t row_stride = static_cast<size_t>(a.K) * HD;  // elements between slots
  const T* kbase = static_cast<const T*>(a.k_pages) + static_cast<size_t>(kh) * HD;
  const T* vbase = static_cast<const T*>(a.v_pages) + static_cast<size_t>(kh) * HD;
  auto issue = [&](int c, int stage) {  // chunk c's K and V rows -> ring stage
    constexpr int VEC = VecWidth<T>::N;
    constexpr int PPR = HD / VEC;  // 16-byte pieces a row
    T* ks = ring + stage * (2 * kChunk * RS);
    T* vs = ks + kChunk * RS;
    for (int i = tid; i < kChunk * PPR; i += kThreads) {
      const int j = i / PPR, p = i % PPR;
      const int tok = c * kChunk + j;
      const uint32_t dk = smem_addr(ks + j * RS + p * VEC);
      const uint32_t dv = smem_addr(vs + j * RS + p * VEC);
      if (tok < n) {
        const size_t off =
            (static_cast<size_t>(pg[tok / a.T]) * a.T + tok % a.T) * row_stride + p * VEC;
        cp_async16(dk, kbase + off);
        cp_async16(dv, vbase + off);
      } else {  // a masked slot: zeros, nothing read
        cp_async16(dk, kbase, 0);
        cp_async16(dv, vbase, 0);
      }
    }
    cp_async_commit();
  };

  const T* qb = static_cast<const T*>(a.q) + (static_cast<size_t>(b) * a.H + h0) * HD;
  if constexpr (CORE == kMma)
    mma_core<HD>(a, qb, rows, n, stages, ring, core, res, resm, resl, issue);
  else
    simt_core<T, HD>(a, qb, rows, n, stages, ring, core, res, resm, resl, issue);

  if (live == 1) {  // the only live split: the output directly
    for (int i = tid; i < rows * HD; i += kThreads)
      out[i] = from_float<T>(res[i] / fmaxf(resl[i / HD], 1e-30f));
    return;
  }
  const size_t hrow = static_cast<size_t>(b) * a.H + h0;
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    a.part_acc[((hrow + r) * a.splits + split) * HD + d] = res[i];
  }
  if (tid < rows) {
    a.part_m[(hrow + tid) * a.splits + split] = resm[tid];
    a.part_l[(hrow + tid) * a.splits + split] = resl[tid];
  }
  __threadfence();
  __syncthreads();
  int* counter = a.counters + static_cast<size_t>(b) * gridDim.y + hb;
  if (tid == 0) *flag = atomicAdd(counter, 1) == live - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // The last block merges every live split's partials: a thread a (row, 4
  // dims) walks the splits in index order, eight at a time: their m, l and
  // 16 bytes of acc are loaded at once, then the running max and sums are
  // brought up to the eight (one rescale a group, so the chain of dependent
  // steps is live / 8 long).
  constexpr int C4 = HD / 4;  // 4-dim columns of a row
  constexpr int kGroup = 8;
  for (int i = tid; i < rows * C4; i += kThreads) {
    const int r = i / C4, c = i % C4;
    const float* pm = a.part_m + (hrow + r) * a.splits;
    const float* pl = a.part_l + (hrow + r) * a.splits;
    const float4* pa = reinterpret_cast<const float4*>(a.part_acc + (hrow + r) * a.splits * HD) + c;
    float mx = -INFINITY, l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < live; s0 += kGroup) {
      float ms[kGroup], ls[kGroup];
      float4 v[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const bool in = s0 + j < live;
        ms[j] = in ? __ldcg(pm + s0 + j) : -INFINITY;
        ls[j] = in ? __ldcg(pl + s0 + j) : 0.f;
        v[j] = in ? __ldcg(pa + static_cast<size_t>(s0 + j) * C4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float mn = mx;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) mn = fmaxf(mn, ms[j]);  // finite: split s0 is live
      const float f = expf(mx - mn);
      acc.x *= f;
      acc.y *= f;
      acc.z *= f;
      acc.w *= f;
      l *= f;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float g = expf(ms[j] - mn);
        acc.x += v[j].x * g;
        acc.y += v[j].y * g;
        acc.z += v[j].z * g;
        acc.w += v[j].w * g;
        l += ls[j] * g;
      }
      mx = mn;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + r * HD + 4 * c;
    o[0] = from_float<T>(acc.x * inv);
    o[1] = from_float<T>(acc.y * inv);
    o[2] = from_float<T>(acc.z * inv);
    o[3] = from_float<T>(acc.w * inv);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
  }
}

template <typename T, int HD, int CORE>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int stages = a.split_tokens > kChunk ? 2 : 1;
  const size_t smem = Smem<T, HD, CORE>::bytes(stages, a.split_tokens / a.T);
  constexpr auto kernel = paged_attention_kernel<T, HD, CORE>;
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.K * a.groups, B), kThreads, smem, stream>>>(a, stages);
  return cudaGetLastError();
}

template <typename T, int CORE>
cudaError_t dispatch_hd(int hd, const Args& a, int B, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32, CORE>(a, B, stream);
    case 64: return launch<T, 64, CORE>(a, B, stream);
    case 128: return launch<T, 128, CORE>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, hd); k/v pages (P, T, K, hd) of one layer; tables (B, N) int32;
// lengths (B,) int32; out (B, H, hd); scratch part_acc (B, H, splits, hd)
// and part_m, part_l (B, H, splits) float32, with split_tokens a multiple of
// T and splits * split_tokens >= N * T; counters: B * K * ceil(G / 16) int32
// that read 0 (and read 0 again when the launch ends).  bfloat16 runs on the
// tensor cores, float32 on the CUDA cores.  All contiguous on the device.
// Returns the launch's cudaError_t (0 = success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lengths, void* out, void* part_acc,
                                      void* part_m, void* part_l, void* counters, int B,
                                      int H, int K, int hd, int T_blk, int N,
                                      int split_tokens, int splits, int dtype,
                                      void* stream) {
  if (B == 0) return cudaSuccess;
  if (K <= 0 || H % K || T_blk <= 0 || split_tokens <= 0 || split_tokens % T_blk ||
      static_cast<long long>(splits) * split_tokens < static_cast<long long>(N) * T_blk)
    return cudaErrorInvalidValue;
  Args a{q, k_pages, v_pages, static_cast<const int*>(tables),
         static_cast<const int*>(lengths), out, static_cast<float*>(part_acc),
         static_cast<float*>(part_m), static_cast<float*>(part_l),
         static_cast<int*>(counters), H, K, H / K, (H / K + kRows - 1) / kRows, T_blk, N,
         split_tokens, splits, 1.0f / sqrtf(static_cast<float>(hd))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_hd<float, kSimt>(hd, a, B, s);
  if (dtype == kBFloat16) return dispatch_hd<__nv_bfloat16, kMma>(hd, a, B, s);
  return cudaErrorInvalidValue;
}

// Latent mode: q (B, H, qk) bf16; pages (P, T, 1, qk) bf16 of one layer;
// tables (B, N) int32; lengths (B,) int32; out (B, H, v); scratch part_acc
// (B, H, splits, v) and part_m, part_l (B, H, splits) float32, with
// split_tokens a multiple of T and splits * split_tokens >= N * T; (qk, v)
// (576, 512) only.  Scores at `scale`.  Launches the split kernel, and with
// more than one split the merge.  Returns the first cudaError_t (0 = success).
extern "C" int paged_latent_launch(const void* q, const void* pages, const void* tables,
                                   const void* lengths, void* out, void* part_acc,
                                   void* part_m, void* part_l, int B, int H, int qk, int v,
                                   int T_blk, int N, int split_tokens, int splits, float scale,
                                   void* stream) {
  if (B == 0) return cudaSuccess;
  if (qk != kLatW || v != kLatV || H <= 0 || T_blk <= 0 || split_tokens <= 0 ||
      split_tokens % T_blk ||
      static_cast<long long>(splits) * split_tokens < static_cast<long long>(N) * T_blk)
    return cudaErrorInvalidValue;
  const int groups = (H + kRows - 1) / kRows;
  Args a{q, pages, pages, static_cast<const int*>(tables), static_cast<const int*>(lengths),
         out, static_cast<float*>(part_acc), static_cast<float*>(part_m),
         static_cast<float*>(part_l), nullptr, H, 1, H, groups, T_blk, N, split_tokens, splits,
         scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stages = split_tokens > kChunk ? 2 : 1;
  const size_t smem = latent::smem_bytes(stages, split_tokens / T_blk);
  constexpr auto kernel = paged_attention_kernel<__nv_bfloat16, kLatW, kLatent>;
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(splits, groups, B), kThreads, smem, s>>>(a, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  paged_attention_kernel<__nv_bfloat16, kLatV, kMerge>
      <<<dim3(kLatV / latent::kSlice, H, B), kThreads, 0, s>>>(a, 0);
  return cudaGetLastError();
}

// A zeroed buffer of n int32 ticket counters on the current device, for
// `paged_attention_launch`; the memset is queued on `stream`.  Never freed:
// a captured graph keeps its address.  Returns null on failure.
extern "C" void* paged_attention_counters(int n, void* stream) {
  void* p = nullptr;
  const size_t bytes = static_cast<size_t>(n) * sizeof(int);
  if (cudaMalloc(&p, bytes) != cudaSuccess) return nullptr;
  if (cudaMemsetAsync(p, 0, bytes, static_cast<cudaStream_t>(stream)) != cudaSuccess) {
    cudaFree(p);
    return nullptr;
  }
  return p;
}
