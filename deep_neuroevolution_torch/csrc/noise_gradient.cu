// noise_gradient: g[d] = Σᵢ w[i] · table[idx[i] + d] for d in [0, D).
//
// Replaces the TPU kernel `gradient_from_noise_pallas` (`_grad_kernel`) of
// deep_neuroevolution_tpu/ops/pallas_kernels.py: the ES gradient, a sum of
// B noise-table slices of length D weighted by the pairs' rank weights.
// On the main path B = 2500 pairs and D ≈ 1.0 M parameters.
//
// What bounds it on the H100: bytes. Streaming every slice once moves
// B · D · 4 bytes (about 10 GB at the main-path shape, 3.0 ms at 3.35 TB/s)
// for two operations per element read. Slices that overlap in the table
// share bytes, so the least that has to move is the union of the slices;
// this kernel does not exploit that (see below).
//
// What the design does about it: one pass over the slices, with no
// intermediate [B, D] matrix. Each thread owns kPerThread outputs spaced
// one block apart, keeps their sums in registers and loops over the B rows,
// so the threads of a warp read 32 neighbouring floats of a slice per load.
// A block stages kRows (offset, weight) pairs in shared memory at a time.
// Offsets may be anything: there is no 1024 alignment, no tile padding and
// no over-read. A thread reads table[idx[i] + d] only for d < D, so with
// idx[i] + D <= N (the wrapper checks it) nothing past table[N - 1] is read.
// Loads are scalar because unaligned offsets rule out 16-byte vectors; the
// row loop is unrolled so each thread keeps several loads in flight.
//
// Not done here: sorting the offsets so that overlapping slices are served
// from L2, and vector loads over an aligned body of each slice.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kRows = kThreads;  // (offset, weight) pairs staged per pass

__global__ void __launch_bounds__(kThreads)
    noise_gradient_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                          const float* __restrict__ w, int B, long long D,
                          float* __restrict__ g) {
  __shared__ int s_idx[kRows];
  __shared__ float s_w[kRows];
  const long long base = (long long)blockIdx.x * (kThreads * kPerThread) + threadIdx.x;

  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.f;

  for (int r0 = 0; r0 < B; r0 += kRows) {
    const int nr = min(kRows, B - r0);
    __syncthreads();  // the previous pass is done with s_idx / s_w
    if (threadIdx.x < nr) {
      s_idx[threadIdx.x] = idx[r0 + threadIdx.x];
      s_w[threadIdx.x] = w[r0 + threadIdx.x];
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < nr; ++r) {
      const float* row = table + s_idx[r];
      const float wr = s_w[r];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const long long d = base + (long long)j * kThreads;
        if (d < D) acc[j] = fmaf(wr, __ldg(row + d), acc[j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long d = base + (long long)j * kThreads;
    if (d < D) g[d] = acc[j];
  }
}

}  // namespace

// table [N] f32, idx [B] int32 with 0 <= idx[i] and idx[i] + D <= N (checked
// by the caller), w [B] f32, g [D] f32 (written in full). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int nevo_noise_gradient(const void* table, const void* idx, const void* w, int B,
                                   long long D, void* g, void* stream) {
  if (D <= 0) return 0;
  if (B < 0) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kThreads * kPerThread;
  const long long blocks = (D + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  noise_gradient_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(w), B, D, static_cast<float*>(g));
  return (int)cudaGetLastError();
}
