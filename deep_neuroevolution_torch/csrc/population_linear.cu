// population_linear: y[b] = x[b] · W[b] for every member b of a population.
//
// Replaces the TPU kernel `population_linear` (`_linear_kernel`) of
// deep_neuroevolution_tpu/ops/pallas_forward.py. It is the fc layer of the
// VBN-DQN's population forward: x [B, K], W [B, K, N] → y [B, N], with
// K = 3872 and N = 256 on the main path. Each member has its own W, so W is
// read once and used once: two operations per element of W.
//
// What bounds it on the H100: bytes. At B = 256 in float32, W is 1.01 GB
// and one pass over it takes 0.30 ms at 3.35 TB/s; its 0.51 G operations
// take 8 µs at the float32 rate. In bfloat16 the bytes halve.
//
// What the design does about it: every byte of W is read exactly once, as
// 16-byte vector loads, by threads that sit side by side along N, so one
// warp reads one contiguous 512-byte span of a W row per instruction.
// One block owns one member and one tile of N columns. Its eight warps
// split K between them (split-K inside the block), each keeping VEC float32
// partial sums per thread, and the partial sums meet in shared memory at the
// end. The loop over K is unrolled so that each thread keeps several loads
// in flight. x[b, k] is the same for a whole warp and comes as a broadcast.
// The sums are float32 whatever the input type. The TPU kernel's member
// grouping (`members_per_step`) and its hand-off to XLA for large K·N have
// no counterpart: blocks run in parallel here, and VMEM limits do not apply.
//
// Faster designs (TMA or cp.async pipelines, split-K across blocks when B
// alone does not fill the SMs) are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsN = 32;  // threads along N: one warp wide
constexpr int kSplitK = 8;     // warps along K inside one block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and W alike). y is float32 [B, N].
// Returns the cudaError_t of the launch (0 on success).
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
