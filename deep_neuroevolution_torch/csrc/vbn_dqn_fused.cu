// vbn_dqn_fused: the whole VBN small-DQN population forward → padded
// action scores [B, 64] float32. Two entry points share one kernel
// template:
//
//   nevo_vbn_dqn_fused1  replaces `vbn_dqn_fused1_scores`
//                        (`_vbn_fused1_kernel`) of
//                        deep_neuroevolution_tpu/ops/pallas_fused_dqn.py,
//                        the `forward_impl='fused1'` route (K4);
//   nevo_vbn_dqn_fused   replaces `vbn_dqn_fused_scores` (`_conv_kernel`
//                        and `_head_kernel` of the same file), the
//                        `forward_impl='fused'` route (K6);
//
// and each has a `_split` form that splits every member over several
// blocks, for small B (below).
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
// The design, at large B (the ES rounds' B = 128 and 256): a persistent
// grid, one block an SM, each taking ⌈B/SMs⌉ or one fewer members
// (blockIdx.x, + gridDim.x, ...), one producer warp and eight consumer
// warps, as K5. The producer's thread streams every byte of a member, in
// order, through one ring of five 32 KB stages fed by TMA bulk copies
// (bulk_ring.cuh): w1, patches1 in 64-row pieces, w2, wf in 64-row pieces
// (61 stages), wo in two. The sequence runs on into the block's next
// member, so that member's w1 and patches land while this member's fc
// tail and out layer finish. The consumers:
//
// * run the convs on mma.sync with K5's SmallDQN bf16 stages
//   (dqn_conv_mma.cuh: conv1_rows on each patches piece as it lands,
//   conv_mma with CO = 32 and two taps a 32-k chunk), each store applying
//   the folded normalization, relu(h·a + c). x1 is rounded to bf16; x2
//   stays float32 (K4, stored channel-major, so that fc row r = c·121 + p
//   meets x2[r]) or is rounded to bf16 (K6, row-major: r = p·32 + c). A
//   value rounded to bf16 whose float32 sum lies near a rounding midpoint
//   is recomputed as the sequential float32 chain with the same scale and
//   shift (dqn_ties.cuh, shared with K5): x1 in both, x2 in K6;
// * run the fc h[n] = Σ_r x2(r)·wf[r, n] as float32 FMAs on the CUDA cores
//   over each wf stage as it lands (M = 1: a byte stream): 32 threads cover
//   a 256-wide row, eight row groups take every eighth row of a stage, and
//   the groups' sums meet in shared memory in order;
// * then x3 = relu(h·a3 + c3) and the out layer, 256 × 64, from wo's two
//   stages, its four row parts summed in order.
//
// At small B (the eval episodes' B = 4, and B = 1 and 8; ops/fused_dqn.py's
// `vbn_plan` picks S and the B where the split takes over) one block an SM
// would leave most SMs idle, so each member is split over S blocks
// (S·B ≤ SMs). Block (b, s) recomputes member b's convs (its patches come
// from L2 once the first block has read them), streams rows
// [s·3872/S, (s+1)·3872/S) of wf through the same ring, and writes its 256
// sums to partials[b, s]. The block that brings member b's counter (zeroed
// by the caller) to S sums the S partial rows in rank order and runs the
// head; the others wait for wo's stages and stop. The scores do not depend
// on which block comes last, and no second launch is needed.
//
// Every sum runs in a fixed order, so the same inputs give bit-identical
// scores.

#include <type_traits>

#include "bulk_ring.cuh"
#include "dqn_conv_mma.cuh"
#include "dqn_ties.cuh"

namespace {

using bf16 = __nv_bfloat16;
using nevo_ties::fix_ties_conv1_t;
using nevo_ties::fix_ties_conv2;
using nevo_ties::kH1;
using nevo_ties::kH2;
using nevo_ties::kKK1;
using nevo_ties::kP1;
using nevo_ties::kP2;
using nevo_ties::ScaleShift;

constexpr int kC1 = 16, kC2 = 32, kFC = 256, kNOut = 64;
constexpr int kK2 = 16 * kC1;     // conv2's K: 4·4·16
constexpr int kRows = kP2 * kC2;  // the fc's rows: 3872
constexpr int kConsumerWarps = nevo_mma::kWarps;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStages = 5, kStageBytes = 32768;
// The near ties' list: a conv notes 7-10% of its positive values, up to
// about 380 of x1's a member on random frames (CPU emulation)
constexpr int kMaxTies = 1024;
using Ties = nevo_ties::Ties<kMaxTies>;
using StoreBf16RowsTies = nevo_ties::StoreBf16RowsTies<ScaleShift, kMaxTies>;

// A unit's items, in stream order: w1; patches1 in pieces of 64 rows (the
// last of 57); w2; the unit's wf rows in pieces of 64 (512 bytes a row);
// wo in pieces of 128 rows (256 bytes a row).
constexpr int kPRows = 64, kNP = (kP1 + kPRows - 1) / kPRows;
constexpr int kFRows = kStageBytes / (kFC * 2);
constexpr int kORows = kStageBytes / (kNOut * 4), kNO = kFC / kORows;
constexpr int kItemW1 = 0, kItemP = 1, kItemW2 = kItemP + kNP, kItemF = kItemW2 + 1;
static_assert(kKK1 * kC1 * 2 <= kStageBytes && kK2 * kC2 * 2 <= kStageBytes, "w1 and w2 must fit a stage");
static_assert(kPRows * kKK1 * 2 <= kStageBytes && kFC % kORows == 0, "a patches piece fits a stage; wo fills stages");

// Shared memory, every region on 128 bytes.
__host__ __device__ constexpr int round128(int bytes) { return (bytes + 127) & ~127; }
constexpr int kGroups = kConsumers / (kFC / 8);  // the fc's row groups: 8
constexpr int kParts = kConsumers / kNOut;       // the out layer's row parts: 4
constexpr int kX1Off = kStages * kStageBytes;    // x1 [441, 16] bf16, 32-byte rows
constexpr int kW1tPitch = kKK1 + 8;  // bf16: 528-byte rows, so 16 channels' loads meet on few banks
constexpr int kW1Off = kX1Off + round128(kP1 * kC1 * 2);  // w1 transposed, [16, 264], for the near ties
constexpr int kX2Off = kW1Off + round128(kC1 * kW1tPitch * 2);  // x2: [32, 121] float32 (K4) or [121, 32] bf16 (K6)
constexpr int kRedOff = kX2Off + round128(kP2 * kC2 * 4);  // [kGroups, 256] the fc's sums
constexpr int kX3Off = kRedOff + kGroups * kFC * 4;        // x3 [256]
constexpr int kRedOutOff = kX3Off + kFC * 4;               // [kParts, 64] the out layer's sums
constexpr int kZeroOff = kRedOutOff + kParts * kNOut * 4;  // 256 zero bytes for the SAME padding
constexpr int kTiesOff = kZeroOff + 256;  // the count, the list, then the last-block flag
constexpr int kBarOff = round128(kTiesOff + 4 * (2 + kMaxTies));
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "more shared memory than a block may have");

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// A block's unit of work: the fc rows [r0, r1) of member b, rank s of S.
struct Unit {
  size_t b;
  int s, r0, r1;
  __device__ int items() const { return kItemF + (r1 - r0 + kFRows - 1) / kFRows + kNO; }
};

// S = 1: the block's m-th member, blockIdx.x + m·gridDim.x, every row;
// S > 1: block i is rank i % S of member i / S, its only unit.
__device__ __forceinline__ Unit unit(int m, int S) {
  if (S == 1) return Unit{blockIdx.x + (size_t)m * gridDim.x, 0, 0, kRows};
  const int s = blockIdx.x % S;
  return Unit{blockIdx.x / S, s, s * kRows / S, (s + 1) * kRows / S};
}
__device__ __forceinline__ int block_units(int B, int S) {
  return S == 1 ? (B - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 1;
}

// relu(h·a[co] + c[co]) in float32, channel-major: x[co·121 + p] (K4's x2).
struct StoreX2ChannelMajor {
  float* x;
  ScaleShift epi;
  __device__ __forceinline__ void operator()(int p, int co, float h0, float h1) const {
    x[co * kP2 + p] = fmaxf(epi(h0, co), 0.f);
    x[(co + 1) * kP2 + p] = fmaxf(epi(h1, co + 1), 0.f);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// kChannelMajor: K4 (x2 float32, fc row r = c·121 + p of wf_cm multiplies
// x2[p, c]); else K6 (x2 bf16, fc row r = p·32 + c of wf multiplies the
// flattened x2[r]). S = 1: the persistent grid; S > 1: the split, with
// partials [B, S, 256] and counters [B] (zero at launch).
template <bool kChannelMajor>
__global__ void __launch_bounds__(kThreads, 1)
    vbn_dqn_fused_kernel(const bf16* __restrict__ patches1, const bf16* __restrict__ w1,
                         const float* __restrict__ a1, const float* __restrict__ c1,
                         const bf16* __restrict__ w2, const float* __restrict__ a2,
                         const float* __restrict__ c2, const bf16* __restrict__ wf,
                         const float* __restrict__ a3, const float* __restrict__ c3,
                         const float* __restrict__ wo, const float* __restrict__ bo,
                         float* __restrict__ out, float* __restrict__ partials, int* __restrict__ counters,
                         int B, int S) {
  using TX2 = std::conditional_t<kChannelMajor, float, bf16>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* x1 = reinterpret_cast<bf16*>(smem + kX1Off);
  bf16* w1t = reinterpret_cast<bf16*>(smem + kW1Off);
  TX2* x2 = reinterpret_cast<TX2*>(smem + kX2Off);
  float* red = reinterpret_cast<float*>(smem + kRedOff);
  float* x3 = reinterpret_cast<float*>(smem + kX3Off);
  float* red_out = reinterpret_cast<float*>(smem + kRedOutOff);
  const bf16* zero = reinterpret_cast<const bf16*>(smem + kZeroOff);
  int* tie_words = reinterpret_cast<int*>(smem + kTiesOff);
  const Ties ties{tie_words, tie_words + 1};
  int* last = tie_words + 1 + kMaxTies;
  const auto ring =
      nevo_ring::ring_init<kStages, kStageBytes>(smem, reinterpret_cast<uint64_t*>(smem + kBarOff), kConsumerWarps);
  if (threadIdx.x < 16) reinterpret_cast<uint4*>(smem + kZeroOff)[threadIdx.x] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) *ties.count = 0;
  __syncthreads();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int units = block_units(B, S);

  if (warp == kConsumerWarps) {
    // producer: one thread streams the units' items through the ring
    if (lane == 0) {
      int i = 0;
      for (int m = 0; m < units; ++m) {
        const Unit u = unit(m, S);
        const size_t b = u.b;
        ring.put(i++, w1 + b * kKK1 * kC1, kKK1 * kC1 * 2);
        for (int piece = 0; piece < kNP; ++piece) {
          const int r0 = piece * kPRows;
          ring.put(i++, patches1 + (b * kP1 + r0) * kKK1, min(kPRows, kP1 - r0) * kKK1 * 2);
        }
        ring.put(i++, w2 + b * kK2 * kC2, kK2 * kC2 * 2);
        for (int r = u.r0; r < u.r1; r += kFRows)
          ring.put(i++, wf + (b * kRows + r) * kFC, min(kFRows, u.r1 - r) * kFC * 2);
        for (int o = 0; o < kNO; ++o) ring.put(i++, wo + (b * kFC + o * kORows) * kNOut, kStageBytes);
      }
    }
    return;
  }

  int i0 = 0;  // the unit's first item
  for (int m = 0; m < units; ++m) {
    const Unit u = unit(m, S);
    const size_t b = u.b;
    const ScaleShift epi1{a1 + b * kC1, c1 + b * kC1}, epi2{a2 + b * kC2, c2 + b * kC2};

    // conv1: x1 = relu(patches1 · w1 · a1 + c1) in bf16; warp w takes
    // m-tile w / 2 of each 64-row piece and n-tile w % 2, its w1 fragments
    // in registers; then the near ties, from w1 transposed
    {
      uint32_t bw1[1][8][4];
      const unsigned char* w = ring.acquire(i0 + kItemW1);
      nevo_mma::load_w1_frags<2>(bw1, w, warp & 1, lane);
      {  // thread t moves row t of w1 [256, 16] into column t of w1t
        static_assert(kKK1 == kConsumers && kC1 == 16, "a thread a row of two 16-byte units");
        const uint4 lo = nevo_mma::lds128(w + 32 * tid), hi = nevo_mma::lds128(w + 32 * tid + 16);
        const bf16* l = reinterpret_cast<const bf16*>(&lo);
        const bf16* h = reinterpret_cast<const bf16*>(&hi);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          w1t[c * kW1tPitch + tid] = l[c];
          w1t[(c + 8) * kW1tPitch + tid] = h[c];
        }
      }
      ring.release(i0 + kItemW1, lane);
#pragma unroll 1
      for (int piece = 0; piece < kNP; ++piece) {
        const int i = i0 + kItemP + piece, p0 = piece * kPRows;
        nevo_mma::conv1_rows(ring.acquire(i), min(kPRows, kP1 - p0), bw1, warp, lane,
                             StoreBf16RowsTies{x1 + p0 * kC1, kC1, epi1, ties, p0});
        ring.release(i, lane);
      }
      consumers_sync();
      fix_ties_conv1_t<kC1, kW1tPitch>(patches1 + b * kP1 * kKK1, w1t, epi1, x1, kC1, ties, tid);
    }
    consumers_sync();
    if (tid == 0) *ties.count = 0;  // every thread read it before the sync above

    // conv2 k4 s2: x2 = relu(im2col(x1) · w2 · a2 + c2), two taps a chunk,
    // w2's 64-byte rows swizzled in place; K6 rounds x2 to bf16 and
    // recomputes its near ties
    {
      unsigned char* w = ring.acquire(i0 + kItemW2);
      nevo_mma::swizzle_rows4(w, kK2, tid, kConsumers);
      consumers_sync();
      if constexpr (kChannelMajor) {
        nevo_mma::conv_mma<4, 2, 1, kH1, kH2, kC1, kC1, kC2>(x1, zero, w, warp, lane, StoreX2ChannelMajor{x2, epi2});
      } else {
        nevo_mma::conv_mma<4, 2, 1, kH1, kH2, kC1, kC1, kC2>(x1, zero, w, warp, lane,
                                                             StoreBf16RowsTies{x2, kC2, epi2, ties, 0});
        consumers_sync();
        fix_ties_conv2<kC1, kC1, kC2>(x1, w, epi2, x2, kC2, ties, tid);
      }
      ring.release(i0 + kItemW2, lane);
    }
    consumers_sync();
    if (tid == 0) *ties.count = 0;

    // fc: h[n] = Σ_r x2(r) · wf[r, n] over the unit's rows in order; thread
    // t sums columns 8·(t % 32)..+7 of every eighth row of a stage, from
    // row t / 32 on
    const int fc_items = (u.r1 - u.r0 + kFRows - 1) / kFRows;
    {
      const int col = tid % (kFC / 8), grp = tid / (kFC / 8);
      float acc[8] = {};
#pragma unroll 1
      for (int f = 0; f < fc_items; ++f) {
        const int i = i0 + kItemF + f, r0 = u.r0 + f * kFRows, rows = min(kFRows, u.r1 - r0);
        const unsigned char* ws = ring.acquire(i) + col * 16;
#pragma unroll
        for (int j = 0; j < kFRows / kGroups; ++j) {
          const int r = grp + kGroups * j;
          if (r < rows) {
            const float xv = to_f32(x2[r0 + r]);
            float wv[8];
            nevo_ties::unpack8(nevo_mma::lds128(ws + r * kFC * 2), wv);
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[k] = fmaf(xv, wv[k], acc[k]);
          }
        }
        ring.release(i, lane);
      }
      float* rg = red + grp * kFC + col * 8;
      *reinterpret_cast<float4*>(rg) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      *reinterpret_cast<float4*>(rg + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    consumers_sync();
    float h = 0.f;  // column tid: the unit's sum, its row groups in order
#pragma unroll
    for (int g = 0; g < kGroups; ++g) h += red[g * kFC + tid];

    // the split: this block's sums to partials[b, s]; the block that
    // brings the member's counter to S sums the ranks in order and runs
    // the head
    bool head = true;
    if (S > 1) {
      partials[(b * S + u.s) * kFC + tid] = h;
      __threadfence();
      consumers_sync();
      if (tid == 0) *last = atomicAdd(counters + b, 1) == S - 1;
      consumers_sync();
      head = *last;
      if (head) {
        __threadfence();
        const float* p = partials + b * S * kFC + tid;
        h = 0.f;
#pragma unroll 1
        for (int s0 = 0; s0 < S; s0 += 16) {  // 16 loads in flight, then their sums in rank order
          float v[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) v[j] = s0 + j < S ? __ldcg(p + (s0 + j) * kFC) : 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (s0 + j < S) h += v[j];
        }
      }
    }
    if (head) x3[tid] = fmaxf(ScaleShift{a3 + b * kFC, c3 + b * kFC}(h, tid), 0.f);
    consumers_sync();

    // out: scores[a] = Σ_k x3[k] · wo[k, a] + bo[a]; thread t sums column
    // t % 64 over rows 32·(t / 64)..+31 of each of wo's stages (a block
    // that runs no head only waits for them)
    {
      const int a = tid % kNOut, part = tid / kNOut;
      constexpr int kSpan = kORows / kParts;
      float s = 0.f;
#pragma unroll 1
      for (int o = 0; o < kNO; ++o) {
        const int i = i0 + kItemF + fc_items + o;
        const float* ws = reinterpret_cast<const float*>(ring.acquire(i)) + part * kSpan * kNOut + a;
        if (head) {
          const float* xk = x3 + o * kORows + part * kSpan;
#pragma unroll 8
          for (int k = 0; k < kSpan; ++k) s = fmaf(xk[k], ws[k * kNOut], s);
        }
        ring.release(i, lane);
      }
      red_out[part * kNOut + a] = s;
    }
    consumers_sync();
    if (head && tid < kNOut) {
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < kParts; ++q) t += red_out[q * kNOut + tid];
      out[b * kNOut + tid] = t + __ldg(bo + b * kNOut + tid);
    }
    i0 += u.items();
    // x3 and red_out are next written after the next unit's first syncs
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The persistent grid: ⌈B / SMs⌉ members a block at most, and as few
// blocks as that allows, so every block takes that many or one fewer.
cudaError_t persistent_grid(int B, int* grid) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int per = (B + sms - 1) / sms;
  *grid = (B + per - 1) / per;
  return cudaSuccess;
}

template <bool kChannelMajor>
int launch(const void* patches1, const void* w1, const void* a1, const void* c1, const void* w2,
           const void* a2, const void* c2, const void* wf, const void* a3, const void* c3,
           const void* wo, const void* bo, void* out, void* partials, void* counters, int B, int S,
           void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || (S > 1 && (partials == nullptr || counters == nullptr))) return (int)cudaErrorInvalidValue;
  if (!aligned16(patches1) || !aligned16(w1) || !aligned16(w2) || !aligned16(wf) || !aligned16(wo))
    return (int)cudaErrorInvalidValue;
  const auto kernel = vbn_dqn_fused_kernel<kChannelMajor>;
  int grid = B * S;
  cudaError_t err = nevo_ring::allow_smem(kernel, kSmemBytes);
  if (err == cudaSuccess && S == 1) err = persistent_grid(B, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(patches1), static_cast<const bf16*>(w1), static_cast<const float*>(a1),
      static_cast<const float*>(c1), static_cast<const bf16*>(w2), static_cast<const float*>(a2),
      static_cast<const float*>(c2), static_cast<const bf16*>(wf), static_cast<const float*>(a3),
      static_cast<const float*>(c3), static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<float*>(out), static_cast<float*>(partials), static_cast<int*>(counters), B, S);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers as `fuse_prepare` lays them out (see the top of this file);
// patches1, w1, w2, wf_cm / wf and wo 16-byte aligned (the bulk copies'
// sources), else cudaErrorInvalidValue. out is float32 [B, 64]. These two
// run the persistent grid; each returns the cudaError_t of the shared-memory
// attribute or of the launch.
extern "C" int nevo_vbn_dqn_fused1(const void* patches1, const void* w1, const void* a1, const void* c1,
                                   const void* w2, const void* a2, const void* c2, const void* wf_cm,
                                   const void* a3, const void* c3, const void* wo, const void* bo,
                                   void* out, int B, void* stream) {
  return launch<true>(patches1, w1, a1, c1, w2, a2, c2, wf_cm, a3, c3, wo, bo, out, nullptr, nullptr, B, 1, stream);
}

extern "C" int nevo_vbn_dqn_fused(const void* patches1, const void* w1, const void* a1, const void* c1,
                                  const void* w2, const void* a2, const void* c2, const void* wf,
                                  const void* a3, const void* c3, const void* wo, const void* bo,
                                  void* out, int B, void* stream) {
  return launch<false>(patches1, w1, a1, c1, w2, a2, c2, wf, a3, c3, wo, bo, out, nullptr, nullptr, B, 1, stream);
}

// The same, each member split over S ≥ 2 blocks (B·S blocks in all):
// partials float32 [B, S, 256] scratch, counters int32 [B] all zero.
extern "C" int nevo_vbn_dqn_fused1_split(const void* patches1, const void* w1, const void* a1, const void* c1,
                                         const void* w2, const void* a2, const void* c2, const void* wf_cm,
                                         const void* a3, const void* c3, const void* wo, const void* bo,
                                         void* out, void* partials, void* counters, int B, int S, void* stream) {
  return launch<true>(patches1, w1, a1, c1, w2, a2, c2, wf_cm, a3, c3, wo, bo, out, partials, counters, B, S,
                      stream);
}

extern "C" int nevo_vbn_dqn_fused_split(const void* patches1, const void* w1, const void* a1, const void* c1,
                                        const void* w2, const void* a2, const void* c2, const void* wf,
                                        const void* a3, const void* c3, const void* wo, const void* bo,
                                        void* out, void* partials, void* counters, int B, int S, void* stream) {
  return launch<false>(patches1, w1, a1, c1, w2, a2, c2, wf, a3, c3, wo, bo, out, partials, counters, B, S,
                       stream);
}
