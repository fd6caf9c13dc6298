// fc_ktiled (K7): y[b] = x[b] · W[b] for every member b, K cut into tiles
// of kt rows whose float32 partials are added into y in tile order.
//
// Replaces the TPU kernel `fc_ktiled` (`_kt_kernel`) of
// scripts/exp_large_fwd.py: a grid of (B, nk = ⌈K / kt⌉) steps, each
// adding one tile's dot x[b, tile] · W[b, tile, :] into the f32 y[b] in
// tile order, with x and W zero-padded to nk·kt rows. Shapes there: x
// [B, 7744] and W [B, 7744, 512] bf16 → y [B, 512] float32, B = 256,
// kt ∈ {1024, 2048, 3872}. Here x and W are both float32 or both bf16, any
// K ≥ 1, N ≥ 1 and kt ≥ 1; every product and sum is float32.
//
// What bounds it on the H100: bytes, as K8 (fc_whole.cu): 2.03 GB at
// B = 256 bf16, 0.607 ms at 3.35 TB/s.
//
// What the design does about it: K8's grid, one block per (member, column
// chunk) (fc_matvec.cuh: 64 threads along N reading 16 bytes each, four
// row groups, 8 rows in flight a thread), whose block walks its member's
// tiles in order as the TPU's grid does: each tile's rows give one f32
// partial, added into a running sum in tile order 0..nk−1. The tail tile
// reads only the rows inside K, so nothing is padded or copied. No atomics
// take part in any sum: the same inputs give bit-identical y.

#include "fc_matvec.cuh"

namespace {

using nevo_fc::chunk_cols;
using nevo_fc::kColThreads;
using nevo_fc::kRowGroups;
using nevo_fc::kThreads;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    fc_ktiled_kernel(const T* __restrict__ x, const T* __restrict__ W, float* __restrict__ y, int K, int N,
                     int kt, int chunks) {
  __shared__ float red[kRowGroups * chunk_cols<VEC>()];
  const size_t b = blockIdx.x / chunks;
  const int n0 = (blockIdx.x % chunks) * chunk_cols<VEC>();
  float sum[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sum[j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += min(kt, K - k0)) {
    float part[VEC];
    nevo_fc::rows_times_x<T, VEC>(x + b * K, W + b * K * N, N, k0, k0 + min(kt, K - k0), n0, red, part);
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

template <typename T, int VEC>
int launch(const void* x, const void* W, void* y, int B, int K, int N, int kt, cudaStream_t stream) {
  const int chunks = (N + chunk_cols<VEC>() - 1) / chunk_cols<VEC>();
  fc_ktiled_kernel<T, VEC><<<(unsigned)B * chunks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(W), static_cast<float*>(y), K, N, kt, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, K], W [B, K, N] contiguous, both float32 (dtype 0) or both bf16
// (dtype 1); y float32 [B, N]. Rows of W read 16 bytes a load where W is
// 16-byte aligned and a row is a multiple of 16 bytes, else one element a
// load. Returns the launch's cudaError_t; cudaErrorInvalidValue for another
// dtype, K < 1, kt < 1 or a negative size.
extern "C" int nevo_fc_ktiled(const void* x, const void* W, void* y, int B, int K, int N, int kt, int dtype,
                              void* stream) {
  if (B < 0 || K < 1 || N < 0 || kt < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return nevo_fc::rows_aligned16<__nv_bfloat16>(W, N) ? launch<__nv_bfloat16, 8>(x, W, y, B, K, N, kt, s)
                                                        : launch<__nv_bfloat16, 1>(x, W, y, B, K, N, kt, s);
  return nevo_fc::rows_aligned16<float>(W, N) ? launch<float, 4>(x, W, y, B, K, N, kt, s)
                                              : launch<float, 1>(x, W, y, B, K, N, kt, s);
}
