// fc_whole (K8): y[b] = x[b] · W[b] for every member b, one block per
// member's column chunk summing all K rows.
//
// Replaces the TPU kernel `fc_whole` (`_whole_kernel`) of
// scripts/exp_large_fwd.py, which holds one member's whole W in VMEM each
// grid step and takes one float32 dot. Shapes there: x [B, 7744] and
// W [B, 7744, 512] bf16 → y [B, 512] float32, B = 256, the LargeDQN's fc.
// Here x and W are both float32 or both bf16, any K ≥ 0 and N ≥ 1; every
// product and sum is float32, and y is float32.
//
// What bounds it on the H100: bytes. W is read once and used once, two
// operations an element: at B = 256 in bf16, x, W and y are 2.03 GB, 0.607
// ms at 3.35 TB/s, against 2 µs for the operations at the bf16 rate.
//
// What the design does about it: a block of 256 threads takes one member
// and 512 bf16 (256 float32) columns: 64 threads along N read 16 bytes
// each of a row, four row groups split the rows, and each thread keeps 8
// rows' loads in flight (fc_matvec.cuh). At B = 256 bf16 that is 256
// blocks, all resident at once, about two an SM, 64 KB of loads in flight
// an SM. The groups' sums meet in shared memory in a fixed order, so the
// same inputs give bit-identical y. The TPU's whole-member VMEM block has
// no counterpart: nothing of W is reused, so nothing of it is staged.

#include "fc_matvec.cuh"

namespace {

using nevo_fc::chunk_cols;
using nevo_fc::kColThreads;
using nevo_fc::kRowGroups;
using nevo_fc::kThreads;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    fc_whole_kernel(const T* __restrict__ x, const T* __restrict__ W, float* __restrict__ y, int K, int N,
                    int chunks) {
  __shared__ float red[kRowGroups * chunk_cols<VEC>()];
  const size_t b = blockIdx.x / chunks;
  const int n0 = (blockIdx.x % chunks) * chunk_cols<VEC>();
  float sum[VEC];
  nevo_fc::rows_times_x<T, VEC>(x + b * K, W + b * K * N, N, 0, K, n0, red, sum);
  const int col = n0 + threadIdx.x * VEC;
  if (threadIdx.x < kColThreads && col < N) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) y[b * N + col + j] = sum[j];
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* W, void* y, int B, int K, int N, cudaStream_t stream) {
  const int chunks = (N + chunk_cols<VEC>() - 1) / chunk_cols<VEC>();
  fc_whole_kernel<T, VEC><<<(unsigned)B * chunks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(W), static_cast<float*>(y), K, N, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, K], W [B, K, N] contiguous, both float32 (dtype 0) or both bf16
// (dtype 1); y float32 [B, N]. Rows of W read 16 bytes a load where W is
// 16-byte aligned and a row is a multiple of 16 bytes, else one element a
// load. Returns the launch's cudaError_t; cudaErrorInvalidValue for another
// dtype or a negative size.
extern "C" int nevo_fc_whole(const void* x, const void* W, void* y, int B, int K, int N, int dtype,
                             void* stream) {
  if (B < 0 || K < 0 || N < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return nevo_fc::rows_aligned16<__nv_bfloat16>(W, N) ? launch<__nv_bfloat16, 8>(x, W, y, B, K, N, s)
                                                        : launch<__nv_bfloat16, 1>(x, W, y, B, K, N, s);
  return nevo_fc::rows_aligned16<float>(W, N) ? launch<float, 4>(x, W, y, B, K, N, s)
                                              : launch<float, 1>(x, W, y, B, K, N, s);
}
