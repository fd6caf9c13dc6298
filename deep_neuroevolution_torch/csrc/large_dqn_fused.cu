// large_dqn_fused: the whole LargeDQN population forward, one block per
// member, → padded action scores [B, 64] float32.
//
// Replaces the TPU kernel `large_dqn_fused_scores` (`_large_fused_kernel`)
// of deep_neuroevolution_tpu/ops/pallas_fused_dqn.py, the GA's automatic
// route for the LargeDQN (models/dqn.py:208-216). Inputs follow
// `LargeDQN.fuse_prepare` (pallas_fused_dqn.py:303-313):
//
//   patches1 [B, 441, 256] bf16   im2col of the frames, k8 s4 SAME
//   w1 [B, 256, 32], w2 [B, 512, 64], w3 [B, 576, 64] bf16, (i, j, c) rows
//   wf [B, 64, 121, 512] bf16     fc rows channel-major:
//                                 wf[b, c, p, :] = fc/w[b, p·64 + c, :]
//   b1, b2, b3, bf [B, 1, C] f32; wo [B, 512, 64] f32; bo [B, 1, 64] f32
//
// and its rounding points (fc_mode 'fma', conv_mode 'scratch'): conv1's
// output and conv2's output are rounded to bf16, as the operands of the
// next product; x3 stays float32 in the fc; the out layer is float32; every
// sum is float32.
//
// What bounds it on the H100: bytes. A member reads 8,445,344 bytes, 94% of
// them its fc weights wf (7.9 MB), for 32.1 MFLOP: 0.32 ms for B = 128 at
// 3.35 TB/s, against 0.03 ms for the operations even at the float32 rate.
//
// What the design does about it: each member's weights are read once and
// nothing but the scores goes back to device memory. The three convs run
// from shared memory (conv_stage in dqn_conv.cuh): x1 [441, 32] and
// x2 [121, 64] in bf16, x3 [121, 64] in float32, 93 KB in all. The fc
// streams wf with 16-byte loads: 64 threads cover one 512-wide row of wf,
// eight such groups take every eighth row, x3[p, c] comes from shared
// memory as a broadcast, and the eight groups' partial sums meet in shared
// memory. The out layer is a 512 × 64 product split over the same groups.
// The convs are float32 FMAs on the CUDA cores, not tensor cores, and run
// before the fc's stream starts; overlapping them (two members per SM, or
// a producer warp streaming wf during the convs) is later work.

#include "dqn_conv.cuh"

namespace {

using nevo_dqn::kP1;
using nevo_dqn::kP2;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kC1 = 32, kC2 = 64, kC3 = 64, kFC = 512, kNOut = 64;
constexpr int kGroups = kThreads / (kFC / 8);  // row groups of the fc stream: 8

// shared memory layout, every offset 16-byte aligned
constexpr int kX1Bytes = kP1 * kC1 * 2;  // bf16
constexpr int kX2Bytes = kP2 * kC2 * 2;  // bf16
constexpr int kX3Bytes = kP2 * kC3 * 4;  // f32
constexpr int kRedBytes = kGroups * kFC * 4;
constexpr int kX4Bytes = kFC * 4;
constexpr int kX2Off = kX1Bytes;
constexpr int kX3Off = kX2Off + kX2Bytes;
constexpr int kRedOff = kX3Off + kX3Bytes;
constexpr int kX4Off = kRedOff + kRedBytes;
constexpr int kSmemBytes = kX4Off + kX4Bytes;
static_assert(kX2Off % 16 == 0 && kX3Off % 16 == 0 && kRedOff % 16 == 0 && kX4Off % 16 == 0,
              "shared-memory regions must be 16-byte aligned");

__global__ void __launch_bounds__(kThreads)
    large_dqn_fused_kernel(const bf16* __restrict__ patches1, const bf16* __restrict__ w1,
                           const float* __restrict__ b1, const bf16* __restrict__ w2,
                           const float* __restrict__ b2, const bf16* __restrict__ w3,
                           const float* __restrict__ b3, const bf16* __restrict__ wf,
                           const float* __restrict__ bfc, const float* __restrict__ wo,
                           const float* __restrict__ bo, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* x1 = reinterpret_cast<bf16*>(smem);
  bf16* x2 = reinterpret_cast<bf16*>(smem + kX2Off);
  float* x3 = reinterpret_cast<float*>(smem + kX3Off);
  float* red = reinterpret_cast<float*>(smem + kRedOff);
  float* x4 = reinterpret_cast<float*>(smem + kX4Off);

  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;

  nevo_dqn::conv1_stage<kC1, kThreads>(patches1 + b * kP1 * nevo_dqn::kKK1,
                                       w1 + b * nevo_dqn::kKK1 * kC1, b1 + b * kC1, x1);
  __syncthreads();
  nevo_dqn::conv2_stage<kC1, kC2, kThreads>(x1, w2 + b * 16 * kC1 * kC2, b2 + b * kC2, x2);
  __syncthreads();
  nevo_dqn::conv3_stage<kC2, kC3, kThreads>(x2, w3 + b * 9 * kC2 * kC3, b3 + b * kC3, x3);
  __syncthreads();

  // fc: h[n] = Σ_c Σ_p x3[p, c] · wf[c, p, n]
  {
    const int n0 = (tid % (kFC / 8)) * 8, grp = tid / (kFC / 8);
    const bf16* wfb = wf + b * kC3 * kP2 * kFC + n0;
    float acc[8] = {};
#pragma unroll 1
    for (int c = 0; c < kC3; ++c) {
      const bf16* wc = wfb + (size_t)c * kP2 * kFC;
#pragma unroll 4
      for (int p = grp; p < kP2; p += kGroups) {
        const float xv = x3[p * kC3 + c];
        float w[8];
        nevo_dqn::load8(wc + p * kFC, w);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(xv, w[j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) red[grp * kFC + n0 + j] = acc[j];
  }
  __syncthreads();
  for (int n = tid; n < kFC; n += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) s += red[g * kFC + n];
    x4[n] = fmaxf(s + bfc[b * kFC + n], 0.f);
  }
  __syncthreads();

  // out: scores[a] = Σ_k x4[k] · wo[k, a] + bo[a], K split over the groups
  {
    constexpr int kSplit = kThreads / kNOut, kSpan = kFC / kSplit;
    const int a = tid % kNOut, part = tid / kNOut;
    const float* wob = wo + b * kFC * kNOut + a;
    float s = 0.f;
    for (int k = part * kSpan; k < (part + 1) * kSpan; ++k) s = fmaf(x4[k], wob[k * kNOut], s);
    red[part * kNOut + a] = s;
    __syncthreads();
    if (tid < kNOut) {
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < kSplit; ++q) t += red[q * kNOut + tid];
      out[b * kNOut + tid] = t + bo[b * kNOut + tid];
    }
  }
}

}  // namespace

// Pointers as `fuse_prepare` lays them out (see the top of this file);
// patches1, w1, w2, w3 and wf 16-byte aligned. out is float32 [B, 64].
// Returns the cudaError_t of the shared-memory attribute or of the launch.
extern "C" int nevo_large_dqn_fused(const void* patches1, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* w3, const void* b3,
                                    const void* wf, const void* bf, const void* wo, const void* bo,
                                    void* out, int B, void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = nevo_dqn::allow_smem(large_dqn_fused_kernel, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  large_dqn_fused_kernel<<<B, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(patches1), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const bf16*>(w3), static_cast<const float*>(b3), static_cast<const bf16*>(wf),
      static_cast<const float*>(bf), static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
