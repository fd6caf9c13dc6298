// Near ties of the DQNs' bf16 convs on tensor cores, for kernels K5
// (dqn_conv_chain.cu) and K4/K6 (vbn_dqn_fused.cu).
//
// A bf16 intermediate is relu(epi(sum)) rounded to bf16, where epi is the
// conv's epilogue: h + b[co] (the DQNs' bias, K5) or h·a[co] + c[co] (a
// folded virtual batch norm, K4 and K6). The plain versions' sums (cuBLAS
// at B = 128 and 256, and the first CUDA-core kernels) are sequential
// float32 FMA chains, k in (i, j, c) order from 0; the tensor cores sum in
// steps. Where a float32 value v lies within kTieUlps float32 ulps of a
// bf16 rounding midpoint the two may round apart, and one flip in x1
// moves the next conv's sums enough to flip more of x2: on an H100 that
// took the LargeDQN's output past its 1e-3·max limit. So the stores note
// those values, and after the conv each noted value is recomputed as the
// sequential chain, with the same epilogue, one a thread. The ulps are
// those of the value the epilogue's `shift` names: v's own for a bias (K5:
// about 1.6% of the positive values noted on random frames);
// max(|v|, |h·a|) for a scale and shift, whose c may cancel most of h·a
// and leave v's ulps far finer than the sums' difference (a few ulps of
// h·a; emulated on the CPU it reached 131,072 ulps of v, 92 of
// max(|v|, |h·a|)), so 7-10% of the positive values are noted. The list holds `max` entries; past that
// (where a frame's patches repeat, their ties repeat too), every value of
// the conv is recomputed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dqn_conv_mma.cuh"

namespace nevo_ties {

using bf16 = __nv_bfloat16;

constexpr int kH1 = 21, kP1 = kH1 * kH1;  // conv1 output 21×21
constexpr int kH2 = 11, kP2 = kH2 * kH2;  // conv2 output 11×11
constexpr int kKK1 = 256;                 // conv1 patch length 8·8·4
constexpr int kConsumers = 32 * nevo_mma::kWarps;  // the threads that recompute
constexpr int kTieUlps = 512;

__device__ __forceinline__ int exponent(float x) { return (int)((__float_as_uint(x) >> 23) & 0xffu); }

// h + b[co]; a near tie's window is kTieUlps ulps of v itself (`shift`,
// the window's log2 in v's ulps over kTieUlps, is 0).
struct Bias {
  const float* b;
  __device__ __forceinline__ float operator()(float h, int co) const { return h + __ldg(b + co); }
  __device__ __forceinline__ int shift(float, float, int) const { return 0; }
};

// h·a[co] + c[co], the product and the sum each rounded (no FMA), as the
// separate multiply and add of the plain PyTorch version; a near tie's
// window is kTieUlps ulps of m = max(|v|, |h·a|), an ulp of m being
// 2^(e_m − e_v) of v's (capped where the window covers every value).
struct ScaleShift {
  const float* a;
  const float* c;
  __device__ __forceinline__ float operator()(float h, int co) const {
    return __fadd_rn(__fmul_rn(h, __ldg(a + co)), __ldg(c + co));
  }
  __device__ __forceinline__ int shift(float h, float v, int co) const {
    return min(exponent(fmaxf(fabsf(v), fabsf(__fmul_rn(h, __ldg(a + co))))) - exponent(v), 7);
  }
};

// A conv's near ties: their count and a list of MAX entries.
template <int MAX>
struct Ties {
  int* count;
  int* list;  // p << 8 | co

  // v is a near tie if it lies within kTieUlps << shift of v's ulps (the
  // epilogue's window) of a bf16 midpoint, where v's bits below bf16's are
  // 0x8000.
  __device__ __forceinline__ void note(float v, int shift, int p, int co) const {
    const int lo = (int)(__float_as_uint(v) & 0xffffu);
    if (v > 0.f && abs(lo - 0x8000) < (kTieUlps << shift)) {
      const int e = atomicAdd(count, 1);
      if (e < MAX) list[e] = p << 8 | co;
    }
  }
  // The values of a [P, C] conv to recompute: the noted ones, or all P·C
  // once more were noted than the list holds; entry e as p << 8 | co.
  __device__ __forceinline__ int size(int P, int C) const { return *count <= MAX ? *count : P * C; }
  __device__ __forceinline__ int entry(int e, int C) const {
    return *count <= MAX ? list[e] : (e / C) << 8 | (e % C);
  }
};

// relu(epi(h)) rounded to bf16 into rows of `pitch` elements, as
// nevo_mma::StoreBf16Rows, noting the near ties as row p0 + p.
template <typename Epi, int MAX>
struct StoreBf16RowsTies {
  bf16* x;
  int pitch;
  Epi epi;
  Ties<MAX> ties;
  int p0;
  __device__ __forceinline__ void operator()(int p, int co, float h0, float h1) const {
    const float v0 = epi(h0, co), v1 = epi(h1, co + 1);
    *reinterpret_cast<__nv_bfloat162*>(x + p * pitch + co) = __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    ties.note(v0, epi.shift(h0, v0, co), p0 + p, co);
    ties.note(v1, epi.shift(h1, v1, co + 1), p0 + p, co + 1);
  }
};

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// conv1's values to recompute (Ties), x1[p, co] = relu(epi(Σ_k patches[p, k]·w1[k, co])),
// each the chain over k = 0..255: patches the member's [441, 256] in device
// memory (a row's 32 loads issued before its chain), w1 [256, C] in shared
// memory; thread t of the kConsumers.
template <int C, typename Epi, int MAX>
__device__ void fix_ties_conv1(const bf16* __restrict__ patches, const bf16* w1, Epi epi, bf16* x1, int pitch,
                               Ties<MAX> ties, int t) {
  const int n = ties.size(kP1, C);
  for (int e = t; e < n; e += kConsumers) {
    const int v = ties.entry(e, C), p = v >> 8, co = v & 255;
    const uint4* row = reinterpret_cast<const uint4*>(patches + p * kKK1);
    uint4 r[kKK1 / 8];
#pragma unroll
    for (int k8 = 0; k8 < kKK1 / 8; ++k8) r[k8] = __ldg(row + k8);
    float acc = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < kKK1 / 8; ++k8) {
      float a[8];
      unpack8(r[k8], a);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(a[i], __bfloat162float(w1[(8 * k8 + i) * C + co]), acc);
    }
    x1[p * pitch + co] = __float2bfloat16(fmaxf(epi(acc, co), 0.f));
  }
}

__device__ __forceinline__ uint4 ldg_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// The same chains with w1 transposed in shared memory, w1t[co·WTP + k]
// (rows of WTP bf16, padded so that different channels' 16-byte loads
// meet on few banks), 8 k a 16-byte load, and the patch row's 32 loads
// issued in order before the chain (K4/K6: 1-4% faster than the form
// above on an H100, the same sums).
template <int C, int WTP, typename Epi, int MAX>
__device__ void fix_ties_conv1_t(const bf16* __restrict__ patches, const bf16* w1t, Epi epi, bf16* x1, int pitch,
                                 Ties<MAX> ties, int t) {
  static_assert(WTP % 8 == 0 && WTP >= kKK1, "w1t rows hold K in 16-byte units");
  const int n = ties.size(kP1, C);
  for (int e = t; e < n; e += kConsumers) {
    const int v = ties.entry(e, C), p = v >> 8, co = v & 255;
    const uint4* row = reinterpret_cast<const uint4*>(patches + p * kKK1);
    const uint4* wt = reinterpret_cast<const uint4*>(w1t + co * WTP);
    uint4 r[kKK1 / 8];
#pragma unroll
    for (int k8 = 0; k8 < kKK1 / 8; ++k8) r[k8] = ldg_nc(row + k8);
    float acc = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < kKK1 / 8; ++k8) {
      float a[8], w[8];
      unpack8(r[k8], a);
      unpack8(wt[k8], w);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(a[i], w[i], acc);
    }
    x1[p * pitch + co] = __float2bfloat16(fmaxf(epi(acc, co), 0.f));
  }
}

// conv2's (k4 s2, 21 → 11) values to recompute, x2[p, co] = relu(epi(Σ_k im2col(x1)[p, k]
// ·w[k, co])), each the chain over k = 0..16·CI - 1 in (i, j, c) order,
// taps in the padding skipped (they add 0); x1 rows of XP elements; w as
// conv_mma reads it: rows of 2·CO bytes swizzled by swizzle_rows8 (CO = 64)
// or swizzle_rows4 (CO = 32).
template <int CI, int XP, int CO, typename Epi, int MAX>
__device__ void fix_ties_conv2(const bf16* x1, const unsigned char* w, Epi epi, bf16* x2, int pitch, Ties<MAX> ties,
                               int t) {
  static_assert(CI % 8 == 0 && (CO == 64 || CO == 32), "x1 rows in 16-byte units; w rows of 128 or 64 bytes");
  const int n = ties.size(kP2, CO);
  for (int e = t; e < n; e += kConsumers) {
    const int v = ties.entry(e, CO), p = v >> 8, co = v & 255;
    const int oh = p / kH2, ow = p % kH2, cu = co >> 3, ce = (co & 7) * 2;
    float acc = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 16; ++tap) {
      const int ih = 2 * oh - 1 + (tap >> 2), iw = 2 * ow - 1 + (tap & 3);
      if (ih < 0 || ih >= kH1 || iw < 0 || iw >= kH1) continue;
      const uint4* xr = reinterpret_cast<const uint4*>(x1 + (ih * kH1 + iw) * XP);
      float wv[CI];
#pragma unroll
      for (int ci = 0; ci < CI; ++ci) {  // row k = tap·CI + ci, its unit cu moved by the row's swizzle
        const int k = tap * CI + ci;
        const int unit = cu ^ (CO == 64 ? nevo_mma::swz8(k) : nevo_mma::swz4(k));
        wv[ci] = __bfloat162float(*reinterpret_cast<const bf16*>(w + k * (2 * CO) + unit * 16 + ce));
      }
#pragma unroll
      for (int c8 = 0; c8 < CI / 8; ++c8) {
        float a[8];
        unpack8(xr[c8], a);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(a[i], wv[8 * c8 + i], acc);
      }
    }
    x2[p * pitch + co] = __float2bfloat16(fmaxf(epi(acc, co), 0.f));
  }
}

}  // namespace nevo_ties
