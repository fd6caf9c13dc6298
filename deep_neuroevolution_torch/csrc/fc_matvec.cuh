// One block's share of a population mat-vec y[b] = x[b] · W[b], for kernels
// K7 (fc_ktiled.cu) and K8 (fc_whole.cu): the float32 sums of rows
// [k0, k1) of one member's W [K, N] against x [K], over one chunk of
// columns.
//
// The block is 256 threads: 64 along N and 4 row groups along K. Thread t
// owns VEC consecutive columns, n0 + VEC·(t % 64).., and sums rows
// k0 + g, k0 + g + 4, ... of row group g = t / 64 in that order, kUnroll
// rows' loads in flight before their FMAs. The four groups' sums then meet
// in shared memory and are added in group order. Every sum runs in a fixed
// order, so the same inputs give bit-identical results.
//
// W is read once, so its loads are streaming loads (`__ldcs`: evict first
// in L2); VEC = 8 (bf16) or 4 (float32) reads 16 bytes a load, VEC = 1 one
// element. x is read by every thread of a row group at the same address,
// which the warp serves with one load.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nevo_fc {

constexpr int kThreads = 256;
constexpr int kColThreads = 64;                      // threads along N
constexpr int kRowGroups = kThreads / kColThreads;   // thread groups along K
constexpr int kUnroll = 8;                           // rows a thread has in flight

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

// The column chunk a block covers: kColThreads · VEC columns.
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

// Whether every row of W starts 16-byte aligned (W itself, and rows of
// N·sizeof(T) bytes a multiple of 16), so that VEC > 1 may read 16 bytes a
// load.
template <typename T>
__host__ __forceinline__ bool rows_aligned16(const void* W, int N) {
  return reinterpret_cast<uintptr_t>(W) % 16 == 0 && ((size_t)N * sizeof(T)) % 16 == 0;
}

}  // namespace nevo_fc
