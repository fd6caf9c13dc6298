// The conv stages of the reference DQN geometries, shared by kernels K3
// (large_dqn_fused.cu), K5 (dqn_conv_chain.cu) and K4/K6 (vbn_dqn_fused.cu).
//
// One block computes one population member. Its activations live in shared
// memory; its weights are read from device memory (and served from L1 after
// the first pass). The geometries are the GPU stack's DQNs
// (deep_neuroevolution_tpu/models/dqn.py:30-47), all SAME padding, NHWC:
//
//   conv1 k8 s4  84×84×4 → 21×21×c1  from im2col patches [441, 256] built
//                                     outside the kernel
//   conv2 k4 s2  21×21×c1 → 11×11×c2 (pads 1 low, 2 high)
//   conv3 k3 s1  11×11×c2 → 11×11×c3 (pads 1, 1), LargeDQN only
//
// Each stage is a product [P, K]·[K, CO] with K in (i, j, c) order, the
// order of an HWIO weight reshaped to [k·k·cin, cout]. conv2 and conv3 read
// their im2col rows straight from the previous stage's activations: a tap
// whose input pixel falls in the SAME padding contributes zero, by a bounds
// check, where the TPU kernel wrote zero-padded 24×24 and 13×13 buffers.
//
// Threads: NT per block. A thread owns 4 consecutive output channels of R
// rows (rows py, py + NT/(CO/4), ...), keeps their 4·R sums in registers
// and walks K eight values at a time: 16-byte loads of eight activations
// per row, and eight 4-channel slices of the weight. Sums are float32; the
// products of bfloat16 inputs are exact in float32.
//
// The epilogue after each product is relu(h + b[co]) (BiasRelu, the DQNs'
// conv bias) or relu(h·a[co] + c[co]) (ScaleShiftRelu, a folded virtual
// batch norm); conv1_stage and conv2_stage take the bias pointer and use
// BiasRelu, their *_epi forms take either.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nevo_dqn {

constexpr int kH1 = 21, kP1 = kH1 * kH1;  // conv1 output 21×21
constexpr int kH2 = 11, kP2 = kH2 * kH2;  // conv2/conv3 output 11×11
constexpr int kKK1 = 256;                 // conv1 patch length 8·8·4

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a bf16 cast in JAX
}

// Eight consecutive values as float32; p is 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
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

// Four consecutive values as float32; p is aligned to 4 elements.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// acc[r][j] += Σ_{ci < C} src[r][ci] · w[ci·CO + j] for j < 4. A null
// src[r] is a row outside the output or a tap in the padding: it adds 0.
template <int R, int C, int CO, typename TA, typename TW>
__device__ __forceinline__ void tap_fma(float (&acc)[R][4], const TA* const (&src)[R],
                                        const TW* __restrict__ w) {
  static_assert(C % 8 == 0, "a tap's channels are walked eight at a time");
#pragma unroll 1
  for (int ci = 0; ci < C; ci += 8) {
    float wv[8][4];
#pragma unroll
    for (int u = 0; u < 8; ++u) load4(w + (ci + u) * CO, wv[u]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (src[r] == nullptr) continue;
      float a[8];
      load8(src[r] + ci, a);
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(a[u], wv[u][j], acc[r][j]);
    }
  }
}

// relu(h + b[co]).
struct BiasRelu {
  const float* b;
  __device__ __forceinline__ float operator()(float h, int co) const { return fmaxf(h + b[co], 0.f); }
};

// relu(h·a[co] + c[co]), the product and the sum each rounded (no FMA), as
// the separate multiply and add of the plain PyTorch version.
struct ScaleShiftRelu {
  const float* a;
  const float* c;
  __device__ __forceinline__ float operator()(float h, int co) const {
    return fmaxf(__fadd_rn(__fmul_rn(h, a[co]), c[co]), 0.f);
  }
};

// out[p·CO + co] = epi(acc, co), rounded to TO, for the rows in range.
template <int R, int P, int CO, int TPY, typename Epi, typename TO>
__device__ __forceinline__ void store_epi(const float (&acc)[R][4], Epi epi, int py, int co0,
                                          TO* __restrict__ out) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = py + r * TPY;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[p * CO + co0 + j] = from_f32<TO>(epi(acc[r][j], co0 + j));
  }
}

// conv1: x1 = epi(patches [441, 256] · w1 [256, CO]), stored as TO.
template <int CO, int NT, typename TI, typename Epi, typename TO>
__device__ __forceinline__ void conv1_stage_epi(const TI* __restrict__ patches, const TI* __restrict__ w1,
                                                Epi epi, TO* __restrict__ x1) {
  static_assert(CO % 4 == 0 && NT % (CO / 4) == 0, "threads must tile the output channels");
  constexpr int TCO = CO / 4, TPY = NT / TCO, R = (kP1 + TPY - 1) / TPY;
  const int co0 = (threadIdx.x % TCO) * 4, py = threadIdx.x / TCO;
  float acc[R][4] = {};
  const TI* src[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = py + r * TPY;
    src[r] = p < kP1 ? patches + p * kKK1 : nullptr;
  }
  tap_fma<R, kKK1, CO>(acc, src, w1 + co0);
  store_epi<R, kP1, CO, TPY>(acc, epi, py, co0, x1);
}

// conv1: x1 = relu(patches [441, 256] · w1 [256, CO] + b1), stored as TO.
template <int CO, int NT, typename TI, typename TO>
__device__ __forceinline__ void conv1_stage(const TI* __restrict__ patches, const TI* __restrict__ w1,
                                            const float* __restrict__ b1, TO* __restrict__ x1) {
  conv1_stage_epi<CO, NT>(patches, w1, BiasRelu{b1}, x1);
}

// A SAME conv over the HIN×HIN×CI activations x (shared memory, 16-byte
// aligned rows): out = epi(im2col(x) [HOUT², KS²·CI] · w [KS²·CI, CO]).
template <int KS, int STRIDE, int PAD, int HIN, int HOUT, int CI, int CO, int NT, typename TA,
          typename TW, typename Epi, typename TO>
__device__ __forceinline__ void conv_stage(const TA* __restrict__ x, const TW* __restrict__ w, Epi epi,
                                           TO* __restrict__ out) {
  static_assert(CO % 4 == 0 && NT % (CO / 4) == 0, "threads must tile the output channels");
  constexpr int P = HOUT * HOUT, TCO = CO / 4, TPY = NT / TCO, R = (P + TPY - 1) / TPY;
  const int co0 = (threadIdx.x % TCO) * 4, py = threadIdx.x / TCO;
  float acc[R][4] = {};
#pragma unroll 1
  for (int i = 0; i < KS; ++i) {
#pragma unroll 1
    for (int j = 0; j < KS; ++j) {
      const TA* src[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = py + r * TPY;
        const int ih = (p / HOUT) * STRIDE - PAD + i, iw = (p % HOUT) * STRIDE - PAD + j;
        const bool in = p < P && ih >= 0 && ih < HIN && iw >= 0 && iw < HIN;
        src[r] = in ? x + (ih * HIN + iw) * CI : nullptr;
      }
      tap_fma<R, CI, CO>(acc, src, w + (i * KS + j) * CI * CO + co0);
    }
  }
  store_epi<R, P, CO, TPY>(acc, epi, py, co0, out);
}

// conv2 k4 s2 SAME, 21 → 11 (pads 1 low, 2 high), out = epi(product).
template <int CI, int CO, int NT, typename TA, typename TW, typename Epi, typename TO>
__device__ __forceinline__ void conv2_stage_epi(const TA* x1, const TW* w2, Epi epi, TO* out) {
  conv_stage<4, 2, 1, kH1, kH2, CI, CO, NT>(x1, w2, epi, out);
}

// conv2 k4 s2 SAME, 21 → 11, out = relu(product + b2).
template <int CI, int CO, int NT, typename TA, typename TW, typename TO>
__device__ __forceinline__ void conv2_stage(const TA* x1, const TW* w2, const float* b2, TO* out) {
  conv2_stage_epi<CI, CO, NT>(x1, w2, BiasRelu{b2}, out);
}

// conv3 k3 s1 SAME, 11 → 11 (pads 1, 1).
template <int CI, int CO, int NT, typename TA, typename TW, typename TO>
__device__ __forceinline__ void conv3_stage(const TA* x2, const TW* w3, const float* b3, TO* out) {
  conv_stage<3, 1, 1, kH2, kH2, CI, CO, NT>(x2, w3, BiasRelu{b3}, out);
}

// Dynamic shared memory above 48 KB must be allowed per kernel first; the
// launchers call this before every launch and return its error.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace nevo_dqn
