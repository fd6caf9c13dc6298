// The reference DQN geometries' constants and a bf16 vector load, for
// kernel K3 (large_dqn_fused.cu).
//
// The geometries are the GPU stack's DQNs
// (deep_neuroevolution_tpu/models/dqn.py:30-47), all SAME padding, NHWC:
//
//   conv1 k8 s4  84×84×4 → 21×21×c1  from im2col patches [441, 256] built
//                                     outside the kernel
//   conv2 k4 s2  21×21×c1 → 11×11×c2 (pads 1 low, 2 high)
//   conv3 k3 s1  11×11×c2 → 11×11×c3 (pads 1, 1), LargeDQN only
//
// The conv stages themselves run on tensor cores (dqn_conv_mma.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nevo_dqn {

constexpr int kH1 = 21, kP1 = kH1 * kH1;  // conv1 output 21×21
constexpr int kH2 = 11, kP2 = kH2 * kH2;  // conv2/conv3 output 11×11
constexpr int kKK1 = 256;                 // conv1 patch length 8·8·4

// Eight consecutive bf16 values as float32; p is 16-byte aligned.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

}  // namespace nevo_dqn
