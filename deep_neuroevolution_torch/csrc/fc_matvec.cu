// fc_matvec: kernels K7 (fc_ktiled) and K8 (fc_whole), y[b] = x[b] · W[b]
// for every member b, x [B, K] and W [B, K, N] both float32 or both bf16,
// y [B, N] float32. Every product and sum is float32.
//
// Replaces the TPU kernels of scripts/exp_large_fwd.py: `fc_ktiled`
// (`_kt_kernel`, a grid of (B, nk = ⌈K / kt⌉) steps, each adding one tile's
// dot x[b, tile] · W[b, tile, :] into the f32 y[b] in tile order, x and W
// zero-padded to nk·kt rows) and `fc_whole` (`_whole_kernel`, one member's
// whole W in VMEM a step, one f32 dot). Shapes there: x [256, 7744] and
// W [256, 7744, 512] bf16, kt ∈ {1024, 2048, 3872}: the LargeDQN's fc.
// K7 here: tile t is rows [t·kt, min((t + 1)·kt, K)); its partial p_t is
// the f32 sum of its rows, and y = ((0 + p_0) + p_1) + ... + p_{nk−1}, the
// tiles added in tile order. K8 is K7 with one tile (kt = K): one kernel
// serves both.
//
// What bounds it on the H100: bytes. W is read once and used once, two
// operations an element: at B = 256 in bf16, x, W and y are 2.03 GB, 0.607
// ms at 3.35 TB/s, against 2 µs for the operations.
//
// Two variants, chosen by the wrapper (ops/fc_matvec.py) from the plan it
// computes:
//
// * bulk (every aligned shape). K1's design (population_linear.cu) with
//   tiles. A unit is R full rows of one member inside one tile,
//   W[b, k0:k0+R, :], one contiguous span (about 32 KB); no unit straddles
//   a tile, so a tile's last unit may be shorter. The grid is persistent
//   and sized to the card, not to B: each block walks an equal contiguous
//   range of the flattened (member, tile, unit) order, so B = 5 fills the
//   132 SMs as B = 256 does, and no block carries more than one unit more
//   than another. One producer thread streams each unit (and the x values
//   beside it) by 1D bulk copies (`cp.async.bulk`, csrc/bulk_ring.cuh)
//   through a ring of shared-memory stages (four of 32 KB) guarded by
//   full/empty mbarrier pairs, W under an L2 evict-first policy (nothing of
//   it is read twice); eight consumer warps FMA their 16-byte column
//   vectors from shared memory against x in float32 registers. Where the
//   general variant's rows hold 32 KB of loads in flight a block in
//   registers, the ring holds up to 128 KB an SM. A block writes one f32
//   partial row per (member, tile) it touches (its row groups met by warp
//   shuffles where the columns allow), and a second kernel under a
//   programmatic dependent launch, as K1's, adds a tile's partials in block
//   order, then the tiles' sums into y in tile order from 0. No float
//   atomics: the same inputs give a bit-identical y from launch to launch.
// * general: what a bulk copy cannot take (W or x off 16-byte alignment, a
//   row of W or x that is not a multiple of 16 bytes, more 16-byte column
//   vectors than consumer threads, K = 0): the first port's kernel, a
//   block of 256 threads per (member, column chunk) walking the member's
//   tiles in order, 16-byte streaming loads where alignment allows, 8 rows
//   in flight a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

using nevo_ring::bulk_copy_g2s;
using nevo_ring::fence_proxy_async;
using nevo_ring::mbar_arrive;
using nevo_ring::mbar_arrive_expect_tx;
using nevo_ring::mbar_init;
using nevo_ring::mbar_wait;

// ------------------------------------------------------------- general
//
// The block is 256 threads: 64 along N and 4 row groups along K. Thread t
// owns VEC consecutive columns, n0 + VEC·(t % 64).., and sums rows
// k0 + g, k0 + g + 4, ... of row group g = t / 64 in that order, kUnroll
// rows' loads in flight before their FMAs. The four groups' sums then meet
// in shared memory and are added in group order. W is read once, so its
// loads are streaming loads (`__ldcs`: evict first in L2); VEC = 8 (bf16)
// or 4 (float32) reads 16 bytes a load, VEC = 1 one element.

constexpr int kThreads = 256;
constexpr int kColThreads = 64;                     // threads along N
constexpr int kRowGroups = kThreads / kColThreads;  // thread groups along K
constexpr int kUnroll = 8;                          // rows a thread has in flight

// One element of x as float32, through the read-only cache.
__device__ __forceinline__ float load_x(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// VEC consecutive elements of a W row: the raw load, then float32 lanes.
template <typename T, int VEC>
struct Lanes;

template <>
struct Lanes<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& u, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Lanes<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldcs(reinterpret_cast<const float4*>(p)); }
  static __device__ __forceinline__ void widen(const Raw& u, float (&v)[4]) {
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
};

template <>
struct Lanes<__nv_bfloat16, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __bfloat162float(__ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
  }
  static __device__ __forceinline__ void widen(const Raw& u, float (&v)[1]) { v[0] = u; }
};

template <>
struct Lanes<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldcs(p); }
  static __device__ __forceinline__ void widen(const Raw& u, float (&v)[1]) { v[0] = u; }
};

// The column chunk a general block covers: kColThreads · VEC columns.
template <int VEC>
__host__ __device__ constexpr int chunk_cols() {
  return kColThreads * VEC;
}

// Σ_{k0 ≤ r < k1} x[r] · W[r, n] for the chunk's columns n0.. into `sum`,
// valid in the threads of row group 0 (threadIdx.x < kColThreads) for the
// columns that lie inside N. `red` is kRowGroups · chunk_cols<VEC>() floats
// of shared memory. Every thread of the block must call it.
template <typename T, int VEC>
__device__ __forceinline__ void rows_times_x(const T* __restrict__ x, const T* __restrict__ W, int N, int k0,
                                             int k1, int n0, float* red, float (&sum)[VEC]) {
  using L = Lanes<T, VEC>;
  const int ct = threadIdx.x % kColThreads, grp = threadIdx.x / kColThreads;
  const int col = n0 + ct * VEC;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  if (col < N) {
    const T* w = W + col;
#pragma unroll 1
    for (int r0 = k0 + grp; r0 < k1; r0 += kRowGroups * kUnroll) {
      typename L::Raw raw[kUnroll];
      float xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kRowGroups;
        if (r < k1) {
          raw[u] = L::load(w + (size_t)r * N);
          xv[u] = load_x(x + r);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u * kRowGroups < k1) {
          float v[VEC];
          L::widen(raw[u], v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = fmaf(xv[u], v[j], acc[j]);
        }
      }
    }
  }
  constexpr int kCols = chunk_cols<VEC>();
#pragma unroll
  for (int j = 0; j < VEC; ++j) red[grp * kCols + ct * VEC + j] = acc[j];
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float s = red[ct * VEC + j];
#pragma unroll
      for (int g = 1; g < kRowGroups; ++g) s += red[g * kCols + ct * VEC + j];
      sum[j] = s;
    }
  }
}

// grid: B · chunks blocks of kThreads; block (b, chunk) adds its member's
// tiles' partials into a running sum in tile order. kt ≥ K is one tile.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    fc_general_kernel(const T* __restrict__ x, const T* __restrict__ W, float* __restrict__ y, int K, int N, int kt,
                      int chunks) {
  __shared__ float red[kRowGroups * chunk_cols<VEC>()];
  const size_t b = blockIdx.x / chunks;
  const int n0 = (blockIdx.x % chunks) * chunk_cols<VEC>();
  float sum[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sum[j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += min(kt, K - k0)) {
    float part[VEC];
    rows_times_x<T, VEC>(x + b * K, W + b * K * N, N, k0, k0 + min(kt, K - k0), n0, red, part);
#pragma unroll
    for (int j = 0; j < VEC; ++j) sum[j] += part[j];
    __syncthreads();  // the next tile writes `red` again
  }
  const int col = n0 + threadIdx.x * VEC;
  if (threadIdx.x < kColThreads && col < N) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) y[b * N + col + j] = sum[j];
  }
}

// Whether every row of W starts 16-byte aligned (W itself, and rows of
// N·sizeof(T) bytes a multiple of 16), so that VEC > 1 may read 16 bytes a
// load.
template <typename T>
bool rows_aligned16(const void* W, int N) {
  return reinterpret_cast<uintptr_t>(W) % 16 == 0 && ((size_t)N * sizeof(T)) % 16 == 0;
}

template <typename T, int VEC>
int launch_general(const void* x, const void* W, void* y, int B, int K, int N, int kt, cudaStream_t stream) {
  const int chunks = (N + chunk_cols<VEC>() - 1) / chunk_cols<VEC>();
  fc_general_kernel<T, VEC><<<(unsigned)B * chunks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(W), static_cast<float*>(y), K, N, kt, chunks);
  return (int)cudaGetLastError();
}

int general(const void* x, const void* W, void* y, int B, int K, int N, int kt, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return rows_aligned16<__nv_bfloat16>(W, N) ? launch_general<__nv_bfloat16, 8>(x, W, y, B, K, N, kt, s)
                                               : launch_general<__nv_bfloat16, 1>(x, W, y, B, K, N, kt, s);
  return rows_aligned16<float>(W, N) ? launch_general<float, 4>(x, W, y, B, K, N, kt, s)
                                     : launch_general<float, 1>(x, W, y, B, K, N, kt, s);
}

// ---------------------------------------------------------------- bulk

constexpr int kConsumers = 256;  // consumer threads: 8 warps
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBulkThreads = kConsumers + 32;  // + the producer warp
constexpr int kCombineThreads = 128;           // second pass: columns a block at most
constexpr int kMaxSmem = 232448;               // dynamic shared memory a block may have on the H100

template <typename T>
struct Vec16 {
  static constexpr int n = 16 / sizeof(T);
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// The shape of the flattened (member, tile, unit) order: tiles of kt ≤ K
// rows, units of `rows` rows, `tile_units` units in a whole tile and
// `member_units` in a member (the last tile may have fewer).
struct Grid {
  int K, N, kt, rows, tile_units, member_units, tiles;
};

// Unit u: rows [k0, k0 + r) of member b, inside tile `tile`.
struct Unit {
  int b, tile, k0, r;
};

__device__ __forceinline__ Unit decode(int u, const Grid& g) {
  Unit o;
  o.b = u / g.member_units;
  const int v = u - o.b * g.member_units;
  o.tile = v / g.tile_units;
  const int t0 = o.tile * g.kt;
  o.k0 = t0 + (v - o.tile * g.tile_units) * g.rows;
  o.r = min(g.rows, t0 + min(g.kt, g.K - t0) - o.k0);
  return o;
}

// Shared memory of one bulk block: the ring, each stage W rows then x
// values (the x slice copied from the 16-byte boundary at or before its
// first value, so up to 32 bytes more), each part on 128 bytes; then the
// consumers' reduction buffer and the 2·stages mbarriers.
// ops/fc_matvec.py computes the same layout (`smem_bytes`).
__host__ __device__ __forceinline__ int round128(int bytes) { return (bytes + 127) & ~127; }

template <typename T>
__host__ __device__ __forceinline__ int w_stage_bytes(int rows, int N) {
  return round128(rows * N * (int)sizeof(T));
}

template <typename T>
__host__ __device__ __forceinline__ int stage_bytes(int rows, int N) {
  return w_stage_bytes<T>(rows, N) + round128(rows * (int)sizeof(T) + 32);
}

template <typename T>
__host__ __device__ __forceinline__ int bulk_smem_bytes(int rows, int N, int stages) {
  return stages * stage_bytes<T>(rows, N) + kConsumers * Vec16<T>::n * 4 + 16 * stages;
}

// The consumers write the partial row `out` of the (member, tile) they
// have summed and clear their sums. Where V, the column vectors a row, is
// a power of two of at least 8, a warp holds all row groups of V / 8
// column vectors (`lane_groups`, row group g in lanes g·V/8 ..), and the
// groups meet by xor shuffles: s_g += s_{g ^ d} for d = 1, 2, 4, ... (group
// distance), without a barrier. Else the groups meet in `red` and are added
// in group order from 0. Every consumer thread calls it at the same units.
template <int VEC>
__device__ __forceinline__ void flush_partial(float (&acc)[VEC], float* __restrict__ out, float* __restrict__ red,
                                              int N, int g, int col, int row_groups, bool lane_groups, int cpw,
                                              bool active, int t) {
  if (lane_groups) {
    for (int d = cpw; d < 32; d <<= 1) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], d);
    }
    if (g == 0) {
#pragma unroll
      for (int v = 0; v < VEC; v += 4)
        *reinterpret_cast<float4*>(out + col * VEC + v) = make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
    }
  } else {
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

// y[b, n] from member b's partial rows: tile t's rows tile_segs[t] ..
// tile_segs[t + 1] (tile_segs points at the member's first tile; a member's
// rows are contiguous, in tile order) added in block order from 0, the
// tiles' sums added into y in tile order from 0. The loads go kCombineBatch
// at a time, across tile ends, so that a long list of rows (B = 1: one per
// block) or many short tiles wait on L2 a few times, not once a row; the
// adds keep their order. Loads through L2 only (`__ldcg`): other blocks
// wrote the rows.
constexpr int kCombineBatch = 32;

// The member's first row, the end of its first tile and its end: the
// plan's, so a caller may read them before it waits for the first pass.
struct Rows {
  int first, tile_end, end;
};

__device__ __forceinline__ Rows member_rows(const int* __restrict__ tile_segs, int tiles) {
  return Rows{tile_segs[0], tile_segs[1], tile_segs[tiles]};
}

__device__ __forceinline__ float combine_column(const float* __restrict__ partials, const int* __restrict__ tile_segs,
                                                Rows r, int N, int n) {
  float total = 0.f, s = 0.f;
  int t = 0;
  for (int i0 = r.first; i0 < r.end; i0 += kCombineBatch) {
    float v[kCombineBatch];
#pragma unroll
    for (int j = 0; j < kCombineBatch; ++j)
      v[j] = i0 + j < r.end ? __ldcg(partials + (size_t)(i0 + j) * N + n) : 0.f;
#pragma unroll
    for (int j = 0; j < kCombineBatch; ++j) {
      if (i0 + j < r.end) {
        if (i0 + j == r.tile_end) {  // tile t is summed (no tile is empty)
          total += s;
          s = 0.f;
          r.tile_end = tile_segs[++t + 1];
        }
        s += v[j];
      }
    }
  }
  return total + s;
}

// First pass. grid: the plan's blocks; block: kBulkThreads. plan holds the
// blocks' unit ranges [grid + 1], their first partial rows [grid + 1] and
// the (member, tile) segments' first partial rows [B·tiles + 1]. With
// V = N / VEC ≤ kConsumers 16-byte column vectors a row, each consumer
// thread owns one column vector and one row group g: rows g,
// g + row_groups, ... of each unit. Where V is a power of two of at least
// 8, warp w's lane l owns vector w·V/8 + l % (V/8) in group l / (V/8);
// else thread t owns vector t % V in group t / V, and threads past
// row_groups·V idle. W's bulk copies go under an L2 evict-first
// policy: nothing of W is read twice.
template <typename T>
__global__ void __launch_bounds__(kBulkThreads, 1)
    fc_bulk_kernel(const T* __restrict__ x, const T* __restrict__ W, float* __restrict__ partials,
                   const int* __restrict__ plan, Grid gd, int stages, int row_groups) {
  constexpr int VEC = Vec16<T>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = gd.N, K = gd.K;
  const int sbytes = stage_bytes<T>(gd.rows, N);
  const int wbytes = w_stage_bytes<T>(gd.rows, N);  // a stage's x values start here
  unsigned char* ring = smem;
  float* red = reinterpret_cast<float*>(smem + stages * sbytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * sbytes + kConsumers * VEC * 4);
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
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      const uint64_t policy = nevo_ring::l2_evict_first_policy();
      int stage = 0;
      uint32_t phase = 0;
      for (int u = u0; u < u1; ++u) {
        const Unit un = decode(u, gd);
        mbar_wait(&empty[stage], phase ^ 1);  // the first pass of the ring finds every stage free
        unsigned char* dst = ring + (size_t)stage * sbytes;
        const uint32_t wb = (uint32_t)(un.r * N * (int)sizeof(T));
        // x's slice from the 16-byte boundary at or before k0 to the one at
        // or after k0 + r (inside the row: K·sizeof(T) is a multiple of 16)
        const uint32_t xa = (uint32_t)(un.k0 * (int)sizeof(T)) & ~15u;
        const uint32_t xe = ((uint32_t)((un.k0 + un.r) * (int)sizeof(T)) + 15u) & ~15u;
        const unsigned char* xrow = reinterpret_cast<const unsigned char*>(x + (size_t)un.b * K);
        mbar_arrive_expect_tx(&full[stage], wb + (xe - xa));
        const T* src = W + ((size_t)un.b * K + un.k0) * N;
        nevo_ring::bulk_copy_g2s_hint(dst, src, wb, &full[stage], policy);
        bulk_copy_g2s(dst + wbytes, xrow + xa, xe - xa, &full[stage]);
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
  const bool lane_groups = (V & (V - 1)) == 0 && V >= 8;  // then row_groups · V = kConsumers
  const int cpw = V / 8;                                   // column vectors a warp, with lane_groups
  const int g = lane_groups ? lane / cpw : t / V;
  const int col = lane_groups ? warp * cpw + lane % cpw : t % V;
  const bool active = g < row_groups;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;

  int cur_seg = -1;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = u0; u < u1; ++u) {
    const Unit un = decode(u, gd);
    const int sid = un.b * gd.tiles + un.tile;
    if (sid != cur_seg) {
      if (cur_seg >= 0)
        flush_partial<VEC>(acc, partials + (size_t)seg++ * N, red, N, g, col, row_groups, lane_groups, cpw, active,
                           t);
      cur_seg = sid;
    }
    mbar_wait(&full[stage], phase);
    const unsigned char* src = ring + (size_t)stage * sbytes;
    const T* ws = reinterpret_cast<const T*>(src);
    const T* xs = reinterpret_cast<const T*>(src + wbytes) + (un.k0 & (VEC - 1));
    if (active) {
#pragma unroll 4
      for (int i = g; i < un.r; i += row_groups) {
        const float xk = to_f32(xs[i]);
        float w[VEC];
        load16(ws + (size_t)i * N + col * VEC, w);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = fmaf(xk, w[v], acc[v]);
      }
    }
    fence_proxy_async();  // the reads above before the TMA refills the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (u0 < u1)
    flush_partial<VEC>(acc, partials + (size_t)seg * N, red, N, g, col, row_groups, lane_groups, cpw, active, t);
}

// Second pass. grid: (B, ⌈N / blockDim.x⌉); a thread per (member,
// column).
__global__ void __launch_bounds__(kCombineThreads)
    fc_combine_kernel(const float* __restrict__ partials, const int* __restrict__ tile_segs, float* __restrict__ y,
                      int N, int tiles) {
  const int b = blockIdx.x;
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  const int* ts = tile_segs + (size_t)b * tiles;
  const Rows r = member_rows(ts, tiles);  // the plan, written before the first pass: read while it runs
  asm volatile("griddepcontrol.wait;\n" ::: "memory");               // the first pass has finished
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the next call's first pass may start
  if (n < N) y[(size_t)b * N + n] = combine_column(partials, ts, r, N, n);
}

// Lets the bulk kernel take `smem` bytes of dynamic shared memory (above
// 48 KB only on request); the largest size allowed so far is kept.
template <typename T>
cudaError_t allow_smem(int smem) {
  static int allowed = 0;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(fc_bulk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

template <typename T>
int launch_bulk(const T* x, const T* W, float* partials, float* y, const int* plan, const Grid& gd, int B, int grid,
                int stages, int row_groups, cudaStream_t stream) {
  const int smem = bulk_smem_bytes<T>(gd.rows, gd.N, stages);
  cudaError_t e = allow_smem<T>(smem);
  if (e != cudaSuccess) return (int)e;
  // programmatic dependent launches: each pass may become resident while
  // the kernel before it ends, and waits for it in-kernel
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
  e = cudaLaunchKernelEx(&cfg, fc_bulk_kernel<T>, x, W, partials, plan, gd, stages, row_groups);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // blocks of 128 columns, or of 32 where those would leave SMs idle (small
  // B: a member's long list of partial rows is then read by more SMs)
  const int threads = (long long)B * ((gd.N + kCombineThreads - 1) / kCombineThreads) >= grid ? kCombineThreads : 32;
  cfg.gridDim = dim3(B, (gd.N + threads - 1) / threads);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  e = cudaLaunchKernelEx(&cfg, fc_combine_kernel, (const float*)partials, plan + 2 * (grid + 1), y, gd.N, gd.tiles);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The general variant of K7: x [B, K], W [B, K, N] contiguous, both float32
// (dtype 0) or both bf16 (dtype 1); y float32 [B, N]; tiles of kt rows.
// Returns the launch's cudaError_t; cudaErrorInvalidValue for another
// dtype, K < 1, kt < 1 or a negative size.
extern "C" int nevo_fc_ktiled(const void* x, const void* W, void* y, int B, int K, int N, int kt, int dtype,
                              void* stream) {
  if (B < 0 || K < 1 || N < 0 || kt < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  return general(x, W, y, B, K, N, kt, dtype, stream);
}

// The general variant of K8: K7's at one tile; K = 0 writes zeros.
extern "C" int nevo_fc_whole(const void* x, const void* W, void* y, int B, int K, int N, int dtype, void* stream) {
  if (B < 0 || K < 0 || N < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  return general(x, W, y, B, K, N, K > 0 ? K : 1, dtype, stream);
}

// The bulk variant's arguments beside the operands: the plan of
// ops/fc_matvec.py, which keeps one of these per plan in host memory (a
// call passes 6 arguments, not 15). plan is int32 on the device (see
// fc_bulk_kernel).
struct FcBulkArgs {
  const int* plan;
  int B, K, N, kt, dtype, grid, rows, stages, row_groups;
};

// The bulk variant of K7 and K8 (K8: kt = K): x [B, K], W [B, K, N]
// contiguous, both float32 (dtype 0) or both bf16 (dtype 1); partials
// float32 [the plan's segments, N]; y float32 [B, N]. Returns a
// cudaError_t; refuses (cudaErrorInvalidValue) what the bulk copies cannot
// take.
extern "C" int nevo_fc_bulk(const void* x, const void* W, void* partials, void* y, const FcBulkArgs* a,
                            void* stream) {
  const int B = a->B, K = a->K, N = a->N, kt = a->kt, dtype = a->dtype, rows = a->rows, stages = a->stages;
  const int size = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  const int vec = size ? 16 / size : 1;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16) == 0 && (reinterpret_cast<uintptr_t>(W) % 16) == 0 &&
                       (reinterpret_cast<uintptr_t>(partials) % 16) == 0;
  if (size == 0 || B <= 0 || K <= 0 || N <= 0 || kt < 1 || kt > K || rows < 1 || rows > kt || a->grid <= 0 ||
      stages < 2 || !aligned || (N * size) % 16 != 0 || (K * size) % 16 != 0 || N / vec > kConsumers ||
      a->row_groups != kConsumers / (N / vec) || (N + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  Grid gd;
  gd.K = K;
  gd.N = N;
  gd.kt = kt;
  gd.rows = rows;
  gd.tiles = (K + kt - 1) / kt;
  gd.tile_units = (kt + rows - 1) / rows;
  gd.member_units = (gd.tiles - 1) * gd.tile_units + (K - (gd.tiles - 1) * kt + rows - 1) / rows;
  if ((long long)B * gd.member_units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == 0 ? bulk_smem_bytes<float>(rows, N, stages) > kMaxSmem
                 : bulk_smem_bytes<__nv_bfloat16>(rows, N, stages) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  float* yf = static_cast<float*>(y);
  if (dtype == 0)
    return launch_bulk<float>(static_cast<const float*>(x), static_cast<const float*>(W), part, yf, a->plan, gd, B,
                              a->grid, stages, a->row_groups, s);
  return launch_bulk<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(W), part,
                                    yf, a->plan, gd, B, a->grid, stages, a->row_groups, s);
}
