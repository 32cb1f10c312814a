// Routed SwiGLU experts of a MoE layer for Hopper (sm_90a): two launches a call.
//
// Replaces no TPU kernel.  The reference's scatter dispatch
// (src/repro/models/layers.py `moe_forward`), and the port's slot path
// after it, run the SwiGLU of every expert over its capacity slots: three
// batched products over all E experts.  With T tokens of k choices and
// T * k < E (a decode step: qwen3-moe-30b-a3b at B 1 routes 8 pairs over
// 128 experts) most slots are empty and most of the weights read are
// multiplied by zeros.  This kernel computes the same function over the
// (token, choice) pairs that routing kept, and reads only their experts:
//
//   y_t = sum over t's kept pairs j, in choice order, of
//         w_j * (silu(x_t . Wg_e) * (x_t . Wu_e)) . Wd_e,     e = ids[t, j]
//
// rounded where the slot path rounds in bfloat16: x.Wg and x.Wu, silu and
// the product h; h.Wd, the weight w and each weighted pair; the k pairs of
// a token summed in float32 and rounded once.  Products accumulate in
// float32.
//
// What bounds it on an H100: bytes.  A pair reads 3 * D * F weights and
// does 6 * D * F operations, 3 operations a byte in bf16, against the
// card's ~295: the weights at 3.35 TB/s are the floor (qwen3-moe B 1:
// 8 pairs x 9.44 MB = 75.5 MB a layer, 22.5 us; mixtral-8x7b B 1: 2 pairs
// x 352 MB, 210 us).  The design streams each routed weight once:
//
//  - Kernel 1 (gate, up, SiLU.mul), grid (F / C, T * k, splits): a block
//    owns C columns of one pair's Wg and Wu (128 bytes of a row: C = 64 in
//    bf16, 32 in fp32) and one split of the D rows.  It writes h (T * k, F).
//    Kernel 2 (down, weighted combine), grid (D / C, T, splits): a block
//    owns C columns of y and one split of its token's k * F rows of Wd,
//    pairs in choice order; a pass of 32 rows lies inside one pair (32
//    divides F), so a pair's sum ends at a pass that every thread shares.
//  - Rows stream through a ring of 4 passes in shared memory by cp.async,
//    16 bytes a thread (a 128-byte row is 8 neighbouring lanes), chunks
//    XOR-swizzled by row; the pass's 32 vector values (x or h) ride along.
//  - bf16 multiplies on the tensor cores: the vector is row 0 of an mma
//    A tile, the pass's 32 x 64 weights are B (ldmatrix.trans, two k16 steps
//    of mma.sync m16n8k16, one 8-column chunk a warp, float32 sums).  On the
//    CUDA cores, unpacking and multiplying 16 bytes cost more issue slots
//    than their load: the first design, one thread a 16-byte chunk, reached
//    0.42 of the bound at qwen3-moe B 1, this one 0.57 (PERF.md).  fp32
//    stays on the CUDA cores (TF32 would round the products).
//  - The splits of a tile form one thread-block cluster and sum into rank 0
//    through distributed shared memory in rank order; warps and lanes sum
//    in fixed order too.  No atomics: a graph replay is bitwise the eager
//    call.  `splits` is the least power of two up to 8 that gives every SM
//    two blocks (`split_plan` in the wrapper, from the static shapes and the
//    SM count): qwen3-moe B 1 takes 4 in kernel 1 (12 x 8 x 4 = 384
//    blocks) and 8 in kernel 2 (32 x 1 x 8 = 256).
//  - A dropped pair's blocks in kernel 1 exit before any load, and kernel 2
//    skips its rows: nothing of its expert is read.
//  - Expert ids, weights and the keep mask are read on the device, so a
//    call never syncs and captures into a CUDA graph.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;                 // 16-byte chunks of a 128-byte row
constexpr int kRows = kThreads / kLanes;  // rows of a pass: one chunk a thread
constexpr int kStages = 4;                // passes in the ring
constexpr int kMaxSplits = 8;             // a portable cluster
constexpr int kMaxK = 64;

struct Args {
  const void* x;               // (T, D)
  const long long* ids;        // (T, k) expert of each pair
  const float* w;              // (T, k) routing weight
  const unsigned char* keep;   // (T, k) the pair kept a slot
  const void* wg;              // (E, D, F)
  const void* wu;              // (E, D, F)
  const void* wd;              // (E, F, D)
  void* h;                     // (T, k, F) scratch
  void* y;                     // (T, D)
  int k, D, F, splits;
};

// 16-byte pieces of the kRows vector values (x or h) of a pass
template <typename T>
constexpr int kPieces = kRows * static_cast<int>(sizeof(T)) / 16;

// Where chunk c of row r of a pass sits in its stage: chunks XOR-swizzled by
// row, so that ldmatrix reads one chunk of 8 rows from 8 bank groups.
__device__ __forceinline__ int swz(int r, int c) { return r * kLanes + (c ^ (r & 7)); }

// One stage of a ring: a pass of NW matrices (kRows rows x 128 bytes each)
// and the pass's vector values.
template <typename T, int NW>
struct Stage {
  uint4 w[NW][kThreads];
  uint4 v[kPieces<T>];
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ void ldsm_x4_trans(const void* p, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
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

// Every thread of every block of the cluster arrives at the start and waits
// before its first write into another block's shared memory: that block has
// started by then.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Where split `rank` leaves its sums: rank 0's buffer, through distributed
// shared memory when the tile is split.
__device__ __forceinline__ float* rank0(float* p, bool clustered) {
  return clustered ? cg::this_cluster().map_shared_rank(p, 0) : p;
}

// The product of a pass's vector values (the one real row of A) with its
// 32 x C weights, accumulated over the passes, and the sums of a tile's C
// columns once the rows are done.
//  - bfloat16, on the tensor cores: warp w owns the 8 columns of chunk w;
//    A is the vector row padded to 16 rows, B the chunk's 32 rows by
//    ldmatrix.trans (two k16 steps of mma.sync m16n8k16); lanes 0-3 end
//    with row 0's sums of two columns each.
//  - float32, on the CUDA cores (TF32 would round the products): each
//    thread its own chunk of 4 columns in its row; the rows of a warp summed
//    by shuffles, the warps through shared memory in warp order.
template <typename T>
struct Core;

template <>
struct Core<__nv_bfloat16> {
  static constexpr int C = 64;
  float acc[4] = {};
  __device__ __forceinline__ void add(const uint4* w, const uint4* v) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    uint32_t a0[4] = {}, a1[4] = {};
    if (lane < 4) {
      const uint32_t* pairs = reinterpret_cast<const uint32_t*>(v);
      a0[0] = pairs[lane];
      a0[2] = pairs[4 + lane];
      a1[0] = pairs[8 + lane];
      a1[2] = pairs[12 + lane];
    }
    uint32_t b[4];
    ldsm_x4_trans(&w[swz(lane, warp)], b[0], b[1], b[2], b[3]);
    mma_bf16(acc, a0, b[0], b[1]);
    mma_bf16(acc, a1, b[2], b[3]);
  }
  // the tile's column sums into out[C]; every thread calls it; acc back to 0
  __device__ __forceinline__ void finish(float* out, float (&)[kWarps][C]) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    if (lane < 4) {
      out[warp * 8 + lane * 2] = acc[0];
      out[warp * 8 + lane * 2 + 1] = acc[1];
    }
    acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  }
};

template <>
struct Core<float> {
  static constexpr int C = 32;
  float acc[4] = {};
  __device__ __forceinline__ void add(const uint4* w, const uint4* v) {
    const int r = threadIdx.x / kLanes, c = threadIdx.x % kLanes;
    const float x = reinterpret_cast<const float*>(v)[r];
    const uint4 q = w[swz(r, c)];
    acc[0] = fmaf(x, __uint_as_float(q.x), acc[0]);
    acc[1] = fmaf(x, __uint_as_float(q.y), acc[1]);
    acc[2] = fmaf(x, __uint_as_float(q.z), acc[2]);
    acc[3] = fmaf(x, __uint_as_float(q.w), acc[3]);
  }
  __device__ __forceinline__ void finish(float* out, float (&red)[kWarps][C]) {
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
    for (int off = kLanes; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    if (lane < kLanes) {
#pragma unroll
      for (int i = 0; i < 4; ++i) red[warp][lane * 4 + i] = acc[i];
    }
    acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
    __syncthreads();
    if (tid < C) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[w][tid];
      out[tid] = sum;
    }
    __syncthreads();
  }
};

// Shared memory of kernel 1: the ring (Wg and Wu and x a pass), then the
// sums.
template <typename T>
struct UpSmem {
  static constexpr int C = Core<T>::C;
  Stage<T, 2> ring[kStages];
  float red[kWarps][C];
  float sums[2][C];
  float gather[kMaxSplits][2][C];
};

template <typename T>
__global__ void __launch_bounds__(kThreads) moe_gate_up_kernel(Args a) {
  constexpr int V = VecWidth<T>::N;
  constexpr int C = Core<T>::C;
  extern __shared__ __align__(16) unsigned char raw[];
  UpSmem<T>& sm = *reinterpret_cast<UpSmem<T>*>(raw);

  const int p = blockIdx.y;  // every block of a cluster has the same pair
  if (!a.keep[p]) return;    // dropped: the cluster leaves together, reading nothing
  const bool clustered = a.splits > 1;
  if (clustered) cluster_arrive();
  const int rank = blockIdx.z;
  const int D = a.D, F = a.F;
  const int tid = threadIdx.x, c = tid % kLanes, r = tid / kLanes;
  const long long e = a.ids[p];
  const size_t col = static_cast<size_t>(blockIdx.x) * C + c * V;
  // this split's rows: whole passes (D is a multiple of kRows)
  const int per = (D / kRows + a.splits - 1) / a.splits * kRows;
  const int d0 = rank * per, passes = (min(D, d0 + per) - d0) / kRows;
  const T* wg = static_cast<const T*>(a.wg) + (static_cast<size_t>(e) * D + d0 + r) * F + col;
  const T* wu = static_cast<const T*>(a.wu) + (static_cast<size_t>(e) * D + d0 + r) * F + col;
  const T* x = static_cast<const T*>(a.x) + static_cast<size_t>(p / a.k) * D + d0;

  // pass i into its stage; an empty group past the last pass
  auto issue = [&sm, passes, tid, r, c, wg, wu, x, F](int i) {
    if (i < passes) {
      Stage<T, 2>& st = sm.ring[i % kStages];
      const size_t off = static_cast<size_t>(i) * kRows * F;
      cp_async16(smem_addr(&st.w[0][swz(r, c)]), wg + off);
      cp_async16(smem_addr(&st.w[1][swz(r, c)]), wu + off);
      if (tid < kPieces<T>) cp_async16(smem_addr(&st.v[tid]), x + i * kRows + tid * V);
    }
    cp_async_commit();
  };

  Core<T> gate, up;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < passes; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // pass i landed for every thread; stage i - 1 is free
    issue(i + kStages - 1);
    const Stage<T, 2>& st = sm.ring[i % kStages];
    gate.add(st.w[0], st.v);
    up.add(st.w[1], st.v);
  }
  gate.finish(sm.sums[0], sm.red);
  up.finish(sm.sums[1], sm.red);
  __syncthreads();
  if (clustered) cluster_wait();
  for (int i = tid; i < 2 * C; i += kThreads)
    *rank0(&sm.gather[rank][i / C][i % C], clustered) = sm.sums[i / C][i % C];
  if (clustered) cg::this_cluster().sync();
  else __syncthreads();
  if (rank != 0 || tid >= C) return;
  float gs = 0.f, us = 0.f;
  for (int q = 0; q < a.splits; ++q) {
    gs += sm.gather[q][0][tid];
    us += sm.gather[q][1][tid];
  }
  const float gb = round_to<T>(gs), ub = round_to<T>(us);
  const float act = round_to<T>(gb / (1.f + expf(-gb)));
  static_cast<T*>(a.h)[static_cast<size_t>(p) * F + blockIdx.x * C + tid] =
      from_float<T>(act * ub);
}

// Shared memory of kernel 2: the ring (Wd and h a pass), the token's pairs,
// then (sized by k) each pair's sums and every split's sums (rank 0's).
template <typename T>
struct DownSmem {
  static constexpr int C = Core<T>::C;
  Stage<T, 1> ring[kStages];
  float red[kWarps][C];
  long long e[kMaxK];
  unsigned char keep[kMaxK];
  __host__ __device__ static size_t bytes(int k, int splits) {
    return (sizeof(DownSmem) + 15) / 16 * 16 +
           sizeof(float) * static_cast<size_t>(k) * C * (1 + splits);
  }
};

// The pair and row of a pass of the token's k * F rows, advanced pass by
// pass (a pass lies inside one pair: kRows divides F).
struct Cursor {
  int j, f;
  __device__ __forceinline__ Cursor(int pass, int F) : j(pass * kRows / F), f(pass * kRows - j * F) {}
  __device__ __forceinline__ void next(int F) {
    f += kRows;
    if (f == F) f = 0, ++j;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) moe_down_kernel(Args a) {
  constexpr int V = VecWidth<T>::N;
  constexpr int C = Core<T>::C;
  extern __shared__ __align__(16) unsigned char raw[];
  DownSmem<T>& sm = *reinterpret_cast<DownSmem<T>*>(raw);
  float* pair_sum = reinterpret_cast<float*>(raw + (sizeof(DownSmem<T>) + 15) / 16 * 16);  // (k, C)
  float* gather = pair_sum + a.k * C;  // (splits, k, C): rank 0's

  const bool clustered = a.splits > 1;
  if (clustered) cluster_arrive();
  const int t = blockIdx.y, rank = blockIdx.z;
  const int k = a.k, D = a.D, F = a.F;
  const int tid = threadIdx.x, c = tid % kLanes, r = tid / kLanes;
  if (tid < k) {
    sm.e[tid] = a.ids[t * k + tid];
    sm.keep[tid] = a.keep[t * k + tid];
  }
  for (int i = tid; i < k * C; i += kThreads) pair_sum[i] = 0.f;
  __syncthreads();

  const T* wd = static_cast<const T*>(a.wd) + static_cast<size_t>(r) * D +
                static_cast<size_t>(blockIdx.x) * C + c * V;
  const T* h = static_cast<const T*>(a.h) + static_cast<size_t>(t) * k * F;
  // this split's passes of the token's k * F rows
  const int all = k * F / kRows;
  const int i0 = rank * all / a.splits, passes = (rank + 1) * all / a.splits - i0;

  // pass i0 + i into its stage (the cursor at it); a dropped pair's rows are
  // not read; an empty group past the last pass
  Cursor in(i0, F);
  auto issue = [&sm, &in, passes, tid, r, c, wd, h, D, F](int i) {
    if (i < passes) {
      if (sm.keep[in.j]) {
        Stage<T, 1>& st = sm.ring[i % kStages];
        cp_async16(smem_addr(&st.w[0][swz(r, c)]),
                   wd + (static_cast<size_t>(sm.e[in.j]) * F + in.f) * D);
        if (tid < kPieces<T>) cp_async16(smem_addr(&st.v[tid]), h + in.j * F + in.f + tid * V);
      }
      in.next(F);
    }
    cp_async_commit();
  };

  Core<T> core;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  Cursor at(i0, F);
  for (int i = 0; i < passes; ++i, at.next(F)) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // pass i landed for every thread; stage i - 1 is free
    issue(i + kStages - 1);
    if (sm.keep[at.j]) {
      const Stage<T, 1>& st = sm.ring[i % kStages];
      core.add(st.w[0], st.v);
    }
    if (at.f + kRows == F || i + 1 == passes) core.finish(pair_sum + at.j * C, sm.red);  // the pair's last pass here
  }
  __syncthreads();
  if (clustered) cluster_wait();
  for (int idx = tid; idx < k * C; idx += kThreads)
    *rank0(&gather[rank * k * C + idx], clustered) = pair_sum[idx];
  if (clustered) cg::this_cluster().sync();
  else __syncthreads();
  if (rank != 0 || tid >= C) return;
  float y = 0.f;
  for (int j = 0; j < k; ++j) {
    if (!sm.keep[j]) continue;
    float sum = 0.f;
    for (int q = 0; q < a.splits; ++q) sum += gather[(q * k + j) * C + tid];
    y += round_to<T>(round_to<T>(sum) * round_to<T>(a.w[t * k + j]));
  }
  static_cast<T*>(a.y)[static_cast<size_t>(t) * D + blockIdx.x * C + tid] = from_float<T>(y);
}

// One launch of `kernel` over `grid`, its z dimension one cluster.
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T>
cudaError_t run(Args a, int T_tok, int splits_up, int splits_down, cudaStream_t stream) {
  constexpr int C = Core<T>::C;
  if (a.D % C || a.F % C) return cudaErrorInvalidValue;
  if (splits_up * kRows > a.D || splits_down * kRows > a.k * a.F) return cudaErrorInvalidValue;
  constexpr auto up = moe_gate_up_kernel<T>;
  constexpr auto down = moe_down_kernel<T>;
  const size_t smem_up = sizeof(UpSmem<T>), smem_down = DownSmem<T>::bytes(a.k, splits_down);
  cudaError_t err = allow_smem<up>(smem_up);
  if (err != cudaSuccess) return err;
  err = allow_smem<down>(smem_down);
  if (err != cudaSuccess) return err;
  a.splits = splits_up;
  err = launch(up, dim3(a.F / C, T_tok * a.k, splits_up), smem_up, stream, a);
  if (err != cudaSuccess) return err;
  a.splits = splits_down;
  return launch(down, dim3(a.D / C, T_tok, splits_down), smem_down, stream, a);
}

bool valid_splits(int s) { return s == 1 || s == 2 || s == 4 || s == kMaxSplits; }

}  // namespace

// y (T, D) from x (T, D), the pairs' ids (int64), weights (float32) and
// keep mask (bool) of shape (T, k), and the expert weights wg, wu (E, D, F),
// wd (E, F, D); h (T, k, F) is scratch.  Returns a cudaError_t.
extern "C" int moe_experts_launch(const void* x, const void* ids, const void* w,
                                  const void* keep, const void* wg, const void* wu,
                                  const void* wd, void* h, void* y, int T, int k, int D, int F,
                                  int splits_up, int splits_down, int dtype, void* stream) {
  if (T == 0) return cudaSuccess;
  if (k <= 0 || k > kMaxK || D <= 0 || F <= 0 || !valid_splits(splits_up) ||
      !valid_splits(splits_down))
    return cudaErrorInvalidValue;
  Args a{x, static_cast<const long long*>(ids), static_cast<const float*>(w),
         static_cast<const unsigned char*>(keep), wg, wu, wd, h, y, k, D, F, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return run<float>(a, T, splits_up, splits_down, s);
  if (dtype == kBFloat16) return run<__nv_bfloat16>(a, T, splits_up, splits_down, s);
  return cudaErrorInvalidValue;
}
