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
// The card reaches the bound only if every SM keeps bytes in flight from
// its block's first cycle to its last.
//
// What the design does about it: one block per member streams every byte
// the member reads, in order, through one ring of five 32 KB shared-memory
// stages fed by TMA bulk copies (bulk_ring.cuh): w1, patches1 in 64-row
// pieces, w2, w3, wf in 32-row pieces, then wo. One producer thread starts
// at kernel entry and keeps the ring full; eight consumer warps take the
// stages in the same order:
//
// * conv1 reads w1's B fragments into registers and frees its stage, then
//   multiplies each patches piece as it lands (dqn_conv_mma.cuh: mma.sync
//   on the tensor cores), so the patches stream through without waiting;
// * conv2 and conv3 hold their weights' stages (2 and 3 of the 5), which
//   are swizzled in place, while the next stages (w3, then wf) land;
// * the fc h[n] = Σ_c Σ_p x3[p, c] · wf[c, p, n] runs float32 FMAs on the
//   CUDA cores: x3 is stored channel-major, so wf's row c·121 + p meets
//   x3[c·121 + p]; 64 threads cover a 512-wide row, four row groups split
//   a stage's rows, and the groups' sums meet in shared memory in order;
// * the out layer streams wo's four stages the same way.
//
// Shared memory: the ring (160 KB), x1 [441, 32] bf16 in 80-byte rows (x3
// [64, 121] float32 later in the same place), x2 [121, 64] bf16 in 144-byte
// rows (the fc's and the out layer's sums later in the same place) and a
// zero row for the SAME padding: 211.8 KB, one block an SM. Every sum runs
// in a fixed order, so the same inputs give bit-identical scores.
// Overlapping one member's stream with the next member's convs (a
// persistent grid) and splitting a member over several SMs for small B are
// later work.

#include "bulk_ring.cuh"
#include "dqn_conv.cuh"
#include "dqn_conv_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using nevo_dqn::kH1;
using nevo_dqn::kH2;
using nevo_dqn::kKK1;
using nevo_dqn::kP1;
using nevo_dqn::kP2;

constexpr int kC1 = 32, kC2 = 64, kC3 = 64, kFC = 512, kNOut = 64;
constexpr int kConsumerWarps = nevo_mma::kWarps;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStages = 5, kStageBytes = 32768;

// The ring's items, in stream order: w1; patches1 in pieces of 64 rows; w2
// and w3 in pieces of 256 rows (128 bytes a row); wf in pieces of 32 rows
// (1 KB a row); wo in pieces of 128 rows (256 bytes a row).
constexpr int kPRows = 64, kNP = (kP1 + kPRows - 1) / kPRows;
constexpr int kWRows = kStageBytes / (kC2 * 2);
constexpr int kK2 = 16 * kC1, kK3 = 9 * kC2;  // conv2's and conv3's K
constexpr int kFRows = kStageBytes / (kFC * 2), kNF = kC3 * kP2 / kFRows;
constexpr int kORows = kStageBytes / (kNOut * 4), kNO = kFC / kORows;
constexpr int kItemW1 = 0, kItemP = 1, kItemW2 = kItemP + kNP;
constexpr int kItemW3 = kItemW2 + kK2 / kWRows;
constexpr int kItemF = kItemW3 + (kK3 + kWRows - 1) / kWRows;
constexpr int kItemO = kItemF + kNF, kItems = kItemO + kNO;
static_assert(kC3 * kP2 % kFRows == 0 && kFC % kORows == 0, "wf and wo must fill whole stages");
// conv2 and conv3 read their weights as one buffer of rows: their stages
// must be neighbours in the ring
static_assert(kItemW2 % kStages + kK2 / kWRows <= kStages, "w2's stages must not wrap around the ring");
static_assert(kItemW3 % kStages + (kK3 + kWRows - 1) / kWRows <= kStages, "w3's stages must not wrap");

// Shared memory, every region on 128 bytes.
__host__ __device__ constexpr int round128(int bytes) { return (bytes + 127) & ~127; }
constexpr int kX1Pitch = kC1 + 8;  // elements: 80-byte rows
constexpr int kX2Pitch = kC2 + 8;  // 144-byte rows
constexpr int kGroups = kConsumers / (kFC / 8);  // the fc's row groups: 4
constexpr int kX1Off = kStages * kStageBytes;
constexpr int kX2Off = kX1Off + round128(kP1 * kX1Pitch * 2);
constexpr int kZeroOff = kX2Off + round128(kP2 * kX2Pitch * 2);
constexpr int kBarOff = kZeroOff + 128;
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;
static_assert(kC3 * kP2 * 4 <= kX2Off - kX1Off, "x3 must fit in x1's place");
static_assert((kGroups * kFC + kFC + kGroups * kNOut) * 4 <= kZeroOff - kX2Off, "the sums must fit in x2's place");
static_assert(kSmemBytes <= 232448, "more shared memory than a block may have");

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    large_dqn_fused_kernel(const bf16* __restrict__ patches1, const bf16* __restrict__ w1,
                           const float* __restrict__ b1, const bf16* __restrict__ w2,
                           const float* __restrict__ b2, const bf16* __restrict__ w3,
                           const float* __restrict__ b3, const bf16* __restrict__ wf,
                           const float* __restrict__ bfc, const float* __restrict__ wo,
                           const float* __restrict__ bo, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* x1 = reinterpret_cast<bf16*>(smem + kX1Off);
  float* x3 = reinterpret_cast<float*>(smem + kX1Off);  // channel-major [64, 121], once x1 is spent
  bf16* x2 = reinterpret_cast<bf16*>(smem + kX2Off);
  float* red = reinterpret_cast<float*>(smem + kX2Off);  // [kGroups, 512], once x2 is spent
  float* x4 = red + kGroups * kFC;
  float* red_out = x4 + kFC;  // [kGroups, 64]
  bf16* zero = reinterpret_cast<bf16*>(smem + kZeroOff);
  const auto ring =
      nevo_ring::ring_init<kStages, kStageBytes>(smem, reinterpret_cast<uint64_t*>(smem + kBarOff), kConsumerWarps);

  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid < 8) reinterpret_cast<uint4*>(zero)[tid] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one thread streams the member's items through the ring
    if (lane == 0) {
      for (int i = 0; i < kItems; ++i) {
        const void* src;
        int bytes;
        if (i == kItemW1) {
          src = w1 + b * kKK1 * kC1;
          bytes = kKK1 * kC1 * 2;
        } else if (i < kItemW2) {
          const int r0 = (i - kItemP) * kPRows;
          src = patches1 + (b * kP1 + r0) * kKK1;
          bytes = min(kPRows, kP1 - r0) * kKK1 * 2;
        } else if (i < kItemW3) {
          src = w2 + (b * kK2 + (i - kItemW2) * kWRows) * kC2;
          bytes = kStageBytes;
        } else if (i < kItemF) {
          const int r0 = (i - kItemW3) * kWRows;
          src = w3 + (b * kK3 + r0) * kC3;
          bytes = min(kWRows, kK3 - r0) * kC3 * 2;
        } else if (i < kItemO) {
          src = wf + (b * kC3 * kP2 + (size_t)(i - kItemF) * kFRows) * kFC;
          bytes = kStageBytes;
        } else {
          src = wo + (b * kFC + (i - kItemO) * kORows) * kNOut;
          bytes = kStageBytes;
        }
        ring.put(i, src, bytes);
      }
    }
    return;
  }

  // consumers: take item i from its stage (ring.acquire), free it when the
  // warp is done with it (ring.release, behind the proxy fence).
  // conv1: x1 = relu(patches1 · w1 + b1) in bf16, piece by piece; w1's
  // fragments stay in registers
  {
    uint32_t bw1[2][8][4];
    nevo_mma::load_w1_frags<4>(bw1, ring.acquire(kItemW1), 2 * (warp & 1), lane);
    ring.release(kItemW1, lane);
    const float* b1b = b1 + b * kC1;
#pragma unroll 1
    for (int piece = 0; piece < kNP; ++piece) {
      const int p0 = piece * kPRows;
      bf16* x1p = x1 + p0 * kX1Pitch;
      nevo_mma::conv1_rows(ring.acquire(kItemP + piece), min(kPRows, kP1 - p0), bw1, warp, lane,
                           nevo_mma::StoreBf16Rows{x1p, kX1Pitch, b1b});
      ring.release(kItemP + piece, lane);
    }
  }
  consumers_sync();

  // conv2 k4 s2: x2 = relu(im2col(x1) · w2 + b2) in bf16
  {
    unsigned char* w = ring.stage(kItemW2);
    for (int i = kItemW2; i < kItemW3; ++i) ring.acquire(i);
    nevo_mma::swizzle_rows8(w, kK2, tid, kConsumers);
    consumers_sync();
    nevo_mma::conv_mma<4, 2, 1, kH1, kH2, kC1, kX1Pitch>(x1, zero, w, warp, lane,
                                                          nevo_mma::StoreBf16Rows{x2, kX2Pitch, b2 + b * kC2});
    for (int i = kItemW2; i < kItemW3; ++i) ring.release(i, lane);
  }
  consumers_sync();

  // conv3 k3 s1: x3 = relu(im2col(x2) · w3 + b3) in float32, channel-major
  {
    unsigned char* w = ring.stage(kItemW3);
    for (int i = kItemW3; i < kItemF; ++i) ring.acquire(i);
    nevo_mma::swizzle_rows8(w, kK3, tid, kConsumers);
    consumers_sync();
    nevo_mma::conv_mma<3, 1, 1, kH2, kH2, kC2, kX2Pitch>(x2, zero, w, warp, lane,
                                                          nevo_mma::StoreF32ChannelMajor{x3, kP2, b3 + b * kC3});
    for (int i = kItemW3; i < kItemF; ++i) ring.release(i, lane);
  }
  consumers_sync();

  // fc: h[n] = Σ_r x3[r] · wf[r, n] over wf's rows r = c·121 + p in order;
  // thread t sums columns 8·(t % 64)..+7 of the rows of group t / 64
  {
    const int col = tid % (kFC / 8), grp = tid / (kFC / 8);
    float acc[8] = {};
#pragma unroll 1
    for (int f = 0; f < kNF; ++f) {
      const bf16* ws = reinterpret_cast<const bf16*>(ring.acquire(kItemF + f)) + col * 8;
      const float* xr = x3 + f * kFRows;
#pragma unroll
      for (int r = grp; r < kFRows; r += kGroups) {
        const float xv = xr[r];
        float w[8];
        nevo_dqn::load8(ws + r * kFC, w);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(xv, w[j], acc[j]);
      }
      ring.release(kItemF + f, lane);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) red[grp * kFC + col * 8 + j] = acc[j];
  }
  consumers_sync();
  for (int n = tid; n < kFC; n += kConsumers) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) s += red[g * kFC + n];
    x4[n] = fmaxf(s + __ldg(bfc + b * kFC + n), 0.f);
  }
  consumers_sync();

  // out: scores[a] = Σ_k x4[k] · wo[k, a] + bo[a]; thread t sums column
  // t % 64 over rows 32·(t / 64)..+31 of each of wo's stages
  {
    const int a = tid % kNOut, part = tid / kNOut;
    constexpr int kSpan = kORows / kGroups;
    float s = 0.f;
#pragma unroll 1
    for (int o = 0; o < kNO; ++o) {
      const float* ws = reinterpret_cast<const float*>(ring.acquire(kItemO + o)) + part * kSpan * kNOut + a;
      const float* xk = x4 + o * kORows + part * kSpan;
#pragma unroll 8
      for (int k = 0; k < kSpan; ++k) s = fmaf(xk[k], ws[k * kNOut], s);
      ring.release(kItemO + o, lane);
    }
    red_out[part * kNOut + a] = s;
  }
  consumers_sync();
  if (tid < kNOut) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) t += red_out[q * kNOut + tid];
    out[b * kNOut + tid] = t + __ldg(bo + b * kNOut + tid);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Pointers as `fuse_prepare` lays them out (see the top of this file);
// patches1, w1, w2, w3, wf and wo 16-byte aligned (the bulk copies'
// sources), else cudaErrorInvalidValue. out is float32 [B, 64]. Returns the
// cudaError_t of the shared-memory attribute or of the launch.
extern "C" int nevo_large_dqn_fused(const void* patches1, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* w3, const void* b3,
                                    const void* wf, const void* bf, const void* wo, const void* bo,
                                    void* out, int B, void* stream) {
  if (B <= 0) return 0;
  if (!aligned16(patches1) || !aligned16(w1) || !aligned16(w2) || !aligned16(w3) || !aligned16(wf) ||
      !aligned16(wo))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = nevo_ring::allow_smem(large_dqn_fused_kernel, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  large_dqn_fused_kernel<<<B, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(patches1), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const bf16*>(w3), static_cast<const float*>(b3), static_cast<const bf16*>(wf),
      static_cast<const float*>(bf), static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
