// population_linear: y[b] = x[b] · W[b] for every member b of a population.
//
// Replaces the TPU kernel `population_linear` (`_linear_kernel`) of
// deep_neuroevolution_tpu/ops/pallas_forward.py. It is the fc layer of the
// population forward: x [B, K], W [B, K, N] → y [B, N] float32, with
// K = 3872 and N = 256 for the VBN-DQN and SmallDQN, K = 7744 and N = 512
// for the LargeDQN. Each member has its own W, so W is read once and used
// once: two operations per element of W.
//
// What bounds it on the H100: bytes. At B = 128 in float32, W is 507 MB
// and one pass over it takes 0.152 ms at 3.35 TB/s; its 0.25 G operations
// take 4 µs at the float32 rate. In bfloat16 the bytes halve. An M = 1
// product per member would waste 63 of a wgmma tile's 64 rows, so the FMAs
// stay on the CUDA cores and the design is about keeping bytes in flight.
//
// Two variants, chosen by the wrapper (ops/population_linear.py) from the
// plan it computes:
//
// * bulk (the main path). W streams through shared memory by the TMA's 1D
//   bulk copy (`cp.async.bulk`), which needs no tensor map. A work unit is
//   R full rows of one member, W[b, k0:k0+R, :], one contiguous span of
//   R·N·sizeof(T) bytes (32 KB), plus x[b, k0:k0+R] beside it. One producer
//   thread keeps a ring of stages full, guarded by full/empty mbarrier
//   pairs; eight consumer warps read their columns from shared memory and
//   FMA them against x in float32 registers. Four 32 KB stages keep up to
//   128 KB in flight per SM, where registers and unroll depth capped the
//   loads of the general variant. (On the H100, a few large copies beat
//   many small ones at the same bytes in flight; two or three blocks an
//   SM with two stages each, an L2 prefetch of the next units, x read from
//   global memory instead of the ring and a persistent second pass were no
//   faster.) The grid is persistent and sized to the card (one block per
//   SM, whatever B is): each block walks an equal contiguous range of the
//   flattened (member, K-chunk) units, so no block carries more than one
//   unit more than another, and a population of 4 fills the card as one of
//   128 does. A block writes one
//   partial row per member it touches; a second pass sums each member's
//   partials in a fixed order. There are no float atomics, so the same
//   inputs give a bit-identical y from launch to launch, as on the TPU. The
//   wrapper computes the plan (grid, R, stages, each block's unit range,
//   the segment map of the partials) and allocates the partials; the
//   kernels allocate nothing. Both passes are programmatic dependent
//   launches: the second pass's blocks are resident before the first pass
//   ends, and the first pass's set-up overlaps the kernel before it.
// * general: what a bulk copy cannot take (W or x off 16-byte alignment, a
//   row N·sizeof(T) or x row K·sizeof(T) that is not a multiple of 16,
//   K = 0, N above 256 16-byte vectors). One block per (member, N tile),
//   eight warps split K, 16-byte `__ldg` loads where alignment allows.
//
// The sums are float32 whatever the input type. The TPU kernel's member
// grouping (`members_per_step`) and its hand-off to XLA for large K·N have
// no counterpart: the grid here does not follow B, and VMEM limits do not
// apply.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

using nevo_ring::bulk_copy_g2s;
using nevo_ring::mbar_arrive;
using nevo_ring::mbar_arrive_expect_tx;
using nevo_ring::mbar_init;
using nevo_ring::mbar_wait;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ------------------------------------------------------------- general

constexpr int kThreadsN = 32;  // threads along N: one warp wide
constexpr int kSplitK = 8;     // warps along K inside one block

// VEC consecutive elements of a W row as float32. VEC > 1 reads 16 bytes in
// one load; the launcher picks VEC > 1 only when every row start and every
// thread's column offset is 16-byte aligned.
template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&out)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = __ldg(p + i);
  }
}

template <int VEC>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&out)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = __bfloat162float(p[i]);
  }
}

// grid: (B, ceil(N / (kThreadsN·VEC))); block: (kThreadsN, kSplitK).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreadsN* kSplitK)
    population_linear_kernel(const T* __restrict__ x, const T* __restrict__ W,
                             float* __restrict__ y, int K, int N) {
  const int b = blockIdx.x;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int n0 = (blockIdx.y * kThreadsN + tx) * VEC;  // first column of this thread
  const T* xb = x + (size_t)b * K;
  const T* Wb = W + (size_t)b * K * N;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;

  // With VEC > 1 the launcher guarantees N % VEC == 0, so a thread's VEC
  // columns are all in range or all out of range.
  if (n0 < N) {
#pragma unroll 4
    for (int k = ty; k < K; k += kSplitK) {
      const float xk = to_f32(xb[k]);
      float w[VEC];
      load_row<VEC>(Wb + (size_t)k * N + n0, w);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(xk, w[v], acc[v]);
    }
  }

  // Reduce the kSplitK partial sums. Layout [ty][v][tx] keeps the writes
  // free of bank conflicts.
  __shared__ float red[kSplitK][VEC][kThreadsN];
#pragma unroll
  for (int v = 0; v < VEC; ++v) red[ty][v][tx] = acc[v];
  __syncthreads();

  const int tid = ty * kThreadsN + tx;
  for (int o = tid; o < VEC * kThreadsN; o += kThreadsN * kSplitK) {
    const int v = o / kThreadsN;
    const int t = o % kThreadsN;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kSplitK; ++j) s += red[j][v][t];
    const int n = (blockIdx.y * kThreadsN + t) * VEC + v;
    if (n < N) y[(size_t)b * N + n] = s;
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* W, float* y, int B, int K, int N, cudaStream_t stream) {
  const dim3 grid(B, (N + kThreadsN * VEC - 1) / (kThreadsN * VEC));
  const dim3 block(kThreadsN, kSplitK);
  population_linear_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(W), y, K, N);
}

// ---------------------------------------------------------------- bulk

constexpr int kConsumers = 256;  // consumer threads: 8 warps
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBulkThreads = kConsumers + 32;  // + the producer warp
constexpr int kBlocksPerSM = 1;
constexpr int kReduceWarps = 8;  // second pass: warps that split a member's partials

// 16 bytes of T per consumer load: 4 float32 or 8 bfloat16 values.
template <typename T>
struct Vec16 {
  static constexpr int n = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// A bulk block's consumers write the partial row `out` of the member they
// have summed and clear their sums. Every consumer thread calls it at the
// same units.
template <int VEC>
__device__ __forceinline__ void flush_partial(float (&acc)[VEC], float* __restrict__ out, float* __restrict__ red,
                                              int N, int g, int col, int row_groups, bool active, int t) {
  if (row_groups == 1) {
    if (active) {
#pragma unroll
      for (int v = 0; v < VEC; v += 4)
        *reinterpret_cast<float4*>(out + col * VEC + v) = make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
    }
  } else {
    // the row groups meet in `red` and are summed in order
    consumers_sync();  // the previous flush has read `red`
    if (active) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[g * N + col * VEC + v] = acc[v];
    }
    consumers_sync();
    for (int n = t; n < N; n += kConsumers) {
      float s = 0.f;
      for (int gg = 0; gg < row_groups; ++gg) s += red[gg * N + n];
      out[n] = s;
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
}

// Shared memory of one bulk block: the ring, each stage W rows then x
// values, each part starting on 128 bytes (on the H100 the same ring 32 or
// 48 bytes past a 128-byte boundary ran slower); then the consumers'
// reduction buffer and the 2·stages mbarriers.
// ops/population_linear.py computes the same layout (`smem_bytes`).
__host__ __device__ __forceinline__ int round128(int bytes) { return (bytes + 127) & ~127; }

template <typename T>
__host__ __device__ __forceinline__ int bulk_stage_bytes(int rows, int N) {
  return round128(rows * N * (int)sizeof(T)) + round128(rows * (int)sizeof(T));
}

template <typename T>
__host__ __device__ __forceinline__ int bulk_smem_bytes(int rows, int N, int stages) {
  return stages * bulk_stage_bytes<T>(rows, N) + kConsumers * Vec16<T>::n * 4 + 16 * stages;
}

// First pass. grid: the plan's blocks; block: kBulkThreads. plan[0 .. grid]
// are the blocks' unit ranges, plan[grid + 1 + i] block i's first partial
// row. Unit u is rows [c·rows, min((c + 1)·rows, K)) of member u / chunks,
// c = u % chunks. With V = N / VEC ≤ kConsumers 16-byte column vectors a
// row, consumer thread t owns column vector t % V and row group g = t / V
// of each unit's rows (rows g, g + row_groups, ...); threads past
// row_groups·V idle.
template <typename T>
__global__ void __launch_bounds__(kBulkThreads, kBlocksPerSM)
    population_linear_bulk_kernel(const T* __restrict__ x, const T* __restrict__ W, float* __restrict__ partials,
                                  const int* __restrict__ plan, int K, int N, int rows, int chunks, int stages,
                                  int row_groups) {
  constexpr int VEC = Vec16<T>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  const int stage_bytes = bulk_stage_bytes<T>(rows, N);
  const int w_bytes = round128(rows * N * (int)sizeof(T));  // a stage's x values start here
  unsigned char* ring = smem;
  float* red = reinterpret_cast<float*>(smem + stages * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes + kConsumers * VEC * 4);
  uint64_t* empty = full + stages;

  // The plan was written by an earlier copy, never by the kernel this one
  // may overlap, so it is read before the wait below.
  const int u0 = plan[blockIdx.x];
  const int u1 = plan[blockIdx.x + 1];
  int seg = plan[gridDim.x + 1 + blockIdx.x];

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Launched as a programmatic dependent launch, this grid may start while
  // the kernel before it in the stream still runs: every thread waits for
  // that kernel to finish before it reads x or W or writes the partials
  // (whose memory the allocator may have handed on from that kernel).
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // let the second pass's blocks become resident; they wait for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = u0; u < u1; ++u) {
        const int b = u / chunks;
        const int k0 = (u - b * chunks) * rows;
        const int r = min(rows, K - k0);
        mbar_wait(&empty[stage], phase ^ 1);  // the first pass of the ring finds every stage free
        unsigned char* dst = ring + (size_t)stage * stage_bytes;
        const uint32_t wb = (uint32_t)(r * N * (int)sizeof(T));
        const uint32_t xb = (uint32_t)(r * (int)sizeof(T));
        mbar_arrive_expect_tx(&full[stage], wb + xb);
        bulk_copy_g2s(dst, W + ((size_t)b * K + k0) * N, wb, &full[stage]);
        bulk_copy_g2s(dst + w_bytes, x + (size_t)b * K + k0, xb, &full[stage]);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers
  const int t = threadIdx.x;
  const int V = N / VEC;
  const int g = t / V;
  const int col = t % V;
  const bool active = g < row_groups;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;

  int member = u0 / chunks;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = u0; u < u1; ++u) {
    const int b = u / chunks;
    if (b != member) {
      flush_partial<VEC>(acc, partials + (size_t)seg++ * N, red, N, g, col, row_groups, active, t);
      member = b;
    }
    const int k0 = (u - b * chunks) * rows;
    const int r = min(rows, K - k0);
    mbar_wait(&full[stage], phase);
    const unsigned char* src = ring + (size_t)stage * stage_bytes;
    const T* ws = reinterpret_cast<const T*>(src);
    const T* xs = reinterpret_cast<const T*>(src + w_bytes);
    if (active) {
#pragma unroll 4
      for (int i = g; i < r; i += row_groups) {
        const float xk = to_f32(xs[i]);
        float w[VEC];
        load16(ws + (size_t)i * N + col * VEC, w);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = fmaf(xk, w[v], acc[v]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (u0 < u1) flush_partial<VEC>(acc, partials + (size_t)seg * N, red, N, g, col, row_groups, active, t);
}

// Second pass. grid: (B, ceil(N / 32)); block: 32 × kReduceWarps.
// member_segs[b] .. member_segs[b + 1] are member b's partial rows. Warp w
// sums rows w, w + kReduceWarps, ... in order, and warp 0 sums the warps'
// sums in order: a fixed order for a given plan.
__global__ void __launch_bounds__(32 * kReduceWarps)
    population_linear_reduce_kernel(const float* __restrict__ partials, const int* __restrict__ member_segs,
                                    float* __restrict__ y, int N) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the first pass has finished
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the next call's first pass may start
  __shared__ float red[kReduceWarps][32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int n = blockIdx.y * 32 + lane;
  const int s0 = member_segs[b];
  const int s1 = member_segs[b + 1];
  float s = 0.f;
  if (n < N)
    for (int i = s0 + w; i < s1; i += kReduceWarps) s += partials[(size_t)i * N + n];
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && n < N) {
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < kReduceWarps; ++j) total += red[j][lane];
    y[(size_t)b * N + n] = total;
  }
}

// Lets the bulk kernel take `smem` bytes of dynamic shared memory (above
// 48 KB only on request); the largest size allowed so far is kept.
template <typename T>
cudaError_t allow_smem(int smem) {
  static int allowed = 0;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(population_linear_bulk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

template <typename T>
int launch_bulk(const T* x, const T* W, float* partials, float* y, const int* plan, int B, int K, int N, int grid,
                int rows, int chunks, int stages, int row_groups, cudaStream_t stream) {
  const int smem = bulk_smem_bytes<T>(rows, N, stages);
  cudaError_t e = allow_smem<T>(smem);
  if (e != cudaSuccess) return (int)e;
  // both passes as programmatic dependent launches: each may become
  // resident while the kernel before it ends, and waits for it in-kernel
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kBulkThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, population_linear_bulk_kernel<T>, x, W, partials, plan, K, N, rows, chunks, stages,
                         row_groups);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  cfg.gridDim = dim3(B, (N + 31) / 32);
  cfg.blockDim = dim3(32 * kReduceWarps);
  cfg.dynamicSmemBytes = 0;
  e = cudaLaunchKernelEx(&cfg, population_linear_reduce_kernel, (const float*)partials,
                         plan + 2 * (grid + 1), y, N);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The general variant. dtype: 0 = float32, 1 = bfloat16 (x and W alike).
// y is float32 [B, N]. Returns the cudaError_t of the launch (0 on success).
extern "C" int nevo_population_linear(const void* x, const void* W, void* y, int B, int K,
                                      int N, int dtype, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (K < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (N > 65535 * kThreadsN) return (int)cudaErrorInvalidValue;  // grid.y limit
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* yf = static_cast<float*>(y);
  const bool aligned = (reinterpret_cast<uintptr_t>(W) % 16) == 0;
  if (dtype == 0) {
    if (aligned && N % 4 == 0)
      launch<float, 4>(x, W, yf, B, K, N, s);
    else
      launch<float, 1>(x, W, yf, B, K, N, s);
  } else {
    if (aligned && N % 8 == 0)
      launch<__nv_bfloat16, 8>(x, W, yf, B, K, N, s);
    else
      launch<__nv_bfloat16, 1>(x, W, yf, B, K, N, s);
  }
  return (int)cudaGetLastError();
}

// The bulk variant: both passes, on the plan of ops/population_linear.py.
// plan is int32 on the device: the blocks' unit ranges [grid + 1], their
// first partial rows [grid + 1], the members' partial rows [B + 1].
// partials is float32 [plan's segments, N]. Returns a cudaError_t; refuses
// (cudaErrorInvalidValue) what the bulk copies cannot take.
extern "C" int nevo_population_linear_bulk(const void* x, const void* W, void* partials, void* y,
                                           const void* plan, int B, int K, int N, int dtype, int grid, int rows,
                                           int chunks, int stages, int row_groups, void* stream) {
  const int size = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  const int vec = size ? 16 / size : 1;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16) == 0 && (reinterpret_cast<uintptr_t>(W) % 16) == 0 &&
                       (reinterpret_cast<uintptr_t>(partials) % 16) == 0;
  if (size == 0 || B <= 0 || K <= 0 || N <= 0 || grid <= 0 || rows <= 0 || stages < 2 || row_groups < 1 ||
      !aligned || (N * size) % 16 != 0 || (K * size) % 16 != 0 || (rows * size) % 16 != 0 ||
      chunks != (K + rows - 1) / rows || N / vec > kConsumers || row_groups != kConsumers / (N / vec) ||
      (N + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(plan);
  float* part = static_cast<float*>(partials);
  float* yf = static_cast<float*>(y);
  if (dtype == 0)
    return launch_bulk<float>(static_cast<const float*>(x), static_cast<const float*>(W), part, yf, p, B, K, N, grid,
                              rows, chunks, stages, row_groups, s);
  return launch_bulk<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(W), part,
                                    yf, p, B, K, N, grid, rows, chunks, stages, row_groups, s);
}

// Blocks of the bulk variant's first pass that fit one SM with `smem_bytes`
// of dynamic shared memory, or a negative cudaError_t.
extern "C" int nevo_population_linear_bulk_occupancy(int dtype, int smem_bytes) {
  int blocks = 0;
  cudaError_t e;
  if (dtype == 0) {
    e = allow_smem<float>(smem_bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, population_linear_bulk_kernel<float>,
                                                        kBulkThreads, smem_bytes);
  } else {
    e = allow_smem<__nv_bfloat16>(smem_bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, population_linear_bulk_kernel<__nv_bfloat16>,
                                                        kBulkThreads, smem_bytes);
  }
  return e == cudaSuccess ? blocks : -(int)e;
}
