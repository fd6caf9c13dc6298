// vbn_dqn_fused: the whole VBN small-DQN population forward, one block per
// member, → padded action scores [B, 64] float32. Two entry points share
// one kernel template:
//
//   nevo_vbn_dqn_fused1  replaces `vbn_dqn_fused1_scores`
//                        (`_vbn_fused1_kernel`) of
//                        deep_neuroevolution_tpu/ops/pallas_fused_dqn.py,
//                        the `forward_impl='fused1'` route (K4);
//   nevo_vbn_dqn_fused   replaces `vbn_dqn_fused_scores` (`_conv_kernel`
//                        and `_head_kernel` of the same file), the
//                        `forward_impl='fused'` route (K6).
//
// Inputs follow `VirtualBNDQN.fuse_prepare` (models/batchnorm.py:304-349):
//
//   patches1 [B, 441, 256] bf16   im2col of the frames, k8 s4 SAME
//   w1 [B, 256, 16], w2 [B, 256, 32] bf16, (i, j, c) rows
//   a1, c1 [B, 1, 16], a2, c2 [B, 1, 32], a3, c3 [B, 1, 256] float32: each
//                                 virtual batch norm folded into
//                                 x̂ = h·a + c, a = inv_σ·(1 + γ), c = b − μ·a
//   K4: wf_cm [B, 32, 121, 256] bf16, wf_cm[b, c, p, :] = fc/w[b, p·32 + c, :]
//   K6: wf    [B, 3872, 256] bf16, the fc rows in (p, c) flatten order
//   wo [B, 256, 64] float32; bo [B, 1, 64] float32 (−1e9 past the actions)
//
// and the TPU kernels' rounding points: conv1's output is rounded to bf16
// as conv2's operand; conv2's output x2 stays float32 in K4's fc and is
// rounded to bf16 in K6's (the TPU pair's flatten and cast between its two
// kernels); the out layer is float32; every sum is float32. h·a + c is a
// rounded product and a rounded sum (__fmul_rn, __fadd_rn: no FMA), as in
// the plain PyTorch version. K6's two TPU kernels exist only because
// Mosaic rejects the in-kernel flatten; here the flatten is a shared-memory
// index, so one kernel computes what the pair computes.
//
// What bounds it on the H100: bytes. A member reads 2,301,312 bytes, 86% of
// them its fc weights (1,982,464), for about 7.6 MFLOP: 0.088 ms for
// B = 128 at 3.35 TB/s, against 0.015 ms for the operations even at the
// float32 rate. K4 and K6 do the same work and have the same bound.
//
// What the design does about it: each member's weights are read once and
// nothing but the scores goes back to device memory. The two convs run from
// shared memory (conv_stage in dqn_conv.cuh, with the scale-and-shift
// epilogue): x1 [441, 16] in bf16, x2 [121, 32] in float32 (K4) or bf16
// (K6), 47 KB in all with the fc's partial sums. The fc streams the
// member's 3872 rows of 256 bf16 with 16-byte loads: 32 threads cover one
// row, 16 groups of them take every 16th row, x2 comes from shared memory
// as a broadcast, and the groups' partial sums meet in shared memory. The
// out layer is a 256 × 64 product split over eight groups. The convs are
// float32 FMAs on the CUDA cores and run before the fc's stream starts;
// one member per block leaves most SMs idle at small B (the eval episodes'
// B = 8).

#include <type_traits>

#include "dqn_conv.cuh"

namespace {

using nevo_dqn::kKK1;
using nevo_dqn::kP1;
using nevo_dqn::kP2;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kC1 = 16, kC2 = 32, kFC = 256, kNOut = 64;
constexpr int kKK2 = 16 * kC1;              // conv2 patch length 4·4·16
constexpr int kRows = kP2 * kC2;            // fc rows: 3872
constexpr int kLanes = kFC / 8;             // threads per fc row: 32
constexpr int kGroups = kThreads / kLanes;  // row groups of the fc stream: 16

// shared memory layout, every offset 16-byte aligned
constexpr int kX1Bytes = kP1 * kC1 * 2;  // bf16
constexpr int kX2Bytes = kP2 * kC2 * 4;  // float32 (K6 uses half of it, as bf16)
constexpr int kRedBytes = kGroups * kFC * 4;
constexpr int kX3Bytes = kFC * 4;
constexpr int kX2Off = kX1Bytes;
constexpr int kRedOff = kX2Off + kX2Bytes;
constexpr int kX3Off = kRedOff + kRedBytes;
constexpr int kSmemBytes = kX3Off + kX3Bytes;
static_assert(kX2Off % 16 == 0 && kRedOff % 16 == 0 && kX3Off % 16 == 0,
              "shared-memory regions must be 16-byte aligned");
static_assert(kSmemBytes <= 48 * 1024, "above 48 KB the launch needs the opt-in attribute");
static_assert(kRows % kGroups == 0, "every group streams the same number of fc rows");

// kChannelMajor: K4 (x2 float32, fc row r = c·121 + p of wf_cm multiplies
// x2[p, c]); else K6 (x2 bf16, fc row r = p·32 + c of wf multiplies the
// flattened x2[r]).
template <bool kChannelMajor>
__global__ void __launch_bounds__(kThreads)
    vbn_dqn_fused_kernel(const bf16* __restrict__ patches1, const bf16* __restrict__ w1,
                         const float* __restrict__ a1, const float* __restrict__ c1,
                         const bf16* __restrict__ w2, const float* __restrict__ a2,
                         const float* __restrict__ c2, const bf16* __restrict__ wf,
                         const float* __restrict__ a3, const float* __restrict__ c3,
                         const float* __restrict__ wo, const float* __restrict__ bo,
                         float* __restrict__ out) {
  using TX2 = std::conditional_t<kChannelMajor, float, bf16>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* x1 = reinterpret_cast<bf16*>(smem);
  TX2* x2 = reinterpret_cast<TX2*>(smem + kX2Off);
  float* red = reinterpret_cast<float*>(smem + kRedOff);
  float* x3 = reinterpret_cast<float*>(smem + kX3Off);

  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;

  nevo_dqn::conv1_stage_epi<kC1, kThreads>(patches1 + b * kP1 * kKK1, w1 + b * kKK1 * kC1,
                                           nevo_dqn::ScaleShiftRelu{a1 + b * kC1, c1 + b * kC1}, x1);
  __syncthreads();
  nevo_dqn::conv2_stage_epi<kC1, kC2, kThreads>(x1, w2 + b * kKK2 * kC2,
                                                nevo_dqn::ScaleShiftRelu{a2 + b * kC2, c2 + b * kC2}, x2);
  __syncthreads();

  // fc: h[n] = Σ_r x(r) · wf[r, n] over the member's 3872 rows
  {
    const int n0 = (tid % kLanes) * 8, grp = tid / kLanes;
    const bf16* wfb = wf + b * kRows * kFC + n0;
    float acc[8] = {};
#pragma unroll 4
    for (int r = grp; r < kRows; r += kGroups) {
      float xv;
      if constexpr (kChannelMajor) {
        xv = x2[(r % kP2) * kC2 + r / kP2];
      } else {
        xv = nevo_dqn::to_f32(x2[r]);
      }
      float w[8];
      nevo_dqn::load8(wfb + r * kFC, w);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(xv, w[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) red[grp * kFC + n0 + j] = acc[j];
  }
  __syncthreads();
  if (tid < kFC) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) s += red[g * kFC + tid];
    x3[tid] = nevo_dqn::ScaleShiftRelu{a3 + b * kFC, c3 + b * kFC}(s, tid);
  }
  __syncthreads();

  // out: scores[a] = Σ_k x3[k] · wo[k, a] + bo[a], K split over the groups
  {
    constexpr int kSplit = kThreads / kNOut, kSpan = kFC / kSplit;
    const int a = tid % kNOut, part = tid / kNOut;
    const float* wob = wo + b * kFC * kNOut + a;
    float s = 0.f;
    for (int k = part * kSpan; k < (part + 1) * kSpan; ++k) s = fmaf(x3[k], wob[k * kNOut], s);
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

template <bool kChannelMajor>
int launch(const void* patches1, const void* w1, const void* a1, const void* c1, const void* w2,
           const void* a2, const void* c2, const void* wf, const void* a3, const void* c3,
           const void* wo, const void* bo, void* out, int B, void* stream) {
  if (B <= 0) return 0;
  vbn_dqn_fused_kernel<kChannelMajor><<<B, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(patches1), static_cast<const bf16*>(w1), static_cast<const float*>(a1),
      static_cast<const float*>(c1), static_cast<const bf16*>(w2), static_cast<const float*>(a2),
      static_cast<const float*>(c2), static_cast<const bf16*>(wf), static_cast<const float*>(a3),
      static_cast<const float*>(c3), static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers as `fuse_prepare` lays them out (see the top of this file);
// patches1, w1, w2 and wf_cm / wf 16-byte aligned. out is float32 [B, 64].
// Each returns the cudaError_t of the launch.
extern "C" int nevo_vbn_dqn_fused1(const void* patches1, const void* w1, const void* a1, const void* c1,
                                   const void* w2, const void* a2, const void* c2, const void* wf_cm,
                                   const void* a3, const void* c3, const void* wo, const void* bo,
                                   void* out, int B, void* stream) {
  return launch<true>(patches1, w1, a1, c1, w2, a2, c2, wf_cm, a3, c3, wo, bo, out, B, stream);
}

extern "C" int nevo_vbn_dqn_fused(const void* patches1, const void* w1, const void* a1, const void* c1,
                                  const void* w2, const void* a2, const void* c2, const void* wf,
                                  const void* a3, const void* c3, const void* wo, const void* bo,
                                  void* out, int B, void* stream) {
  return launch<false>(patches1, w1, a1, c1, w2, a2, c2, wf, a3, c3, wo, bo, out, B, stream);
}
