// Tensor-core conv stages of the LargeDQN, for kernel K3 (large_dqn_fused.cu).
//
// The same three SAME convs as dqn_conv.cuh (conv1 k8 s4 from im2col
// patches [441, 256], conv2 k4 s2 21 → 11, conv3 k3 s1 11 → 11, K in
// (i, j, c) order, weights [K, CO] bf16), with each product on
// `mma.sync.aligned.m16n8k16` (bf16 × bf16 → float32). The products of two
// bf16 values are exact in float32, so only the order of each sum changes.
//
// K is walked in chunks of 32 (two mma k-steps). Inside a chunk, the thread
// at quad position q (lane % 4) holds the 16 bytes k 8q..8q+7 of each of its
// A rows: logical k {2q, 2q+1, 2q+8, 2q+9} of step 0 are k 8q..8q+3, those of
// step 1 are 8q+4..8q+7. So an A fragment is one 16-byte shared-memory load
// per row and chunk, from any row (an im2col row is gathered by its
// address, a tap in the SAME padding reads a zero row), and `ldmatrix.trans`
// gathers the B rows in the same order (`chunk_row`). Sums are float32:
// each step's 16 products in the tensor core, the steps in order.
//
// Layouts in shared memory (16-byte units; a warp's 16-byte loads are
// spread over all 32 banks when no two of 8 rows share a unit mod 8):
//
// * A rows: patches as they land from a bulk copy (512 bytes a row: the
//   8 rows of a load meet in 4 units, 2 loads a bank); x1 with 80-byte rows
//   (conv2 gathers every other pixel: 160 bytes apart); x2 with 144-byte
//   rows (conv3 reads neighbouring pixels).
// * B: w1 [256, 32] as it lands (64-byte rows, read once into registers);
//   w2 and w3 [K, 64] (128-byte rows) swizzled in place after they land
//   (`swizzle_rows8`), since the 8 rows of an ldmatrix would otherwise all
//   fall on one bank group.
//
// The warp tilings assume eight consumer warps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace nevo_mma {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 32;  // k a chunk: two m16n8k16 steps
constexpr int kWarps = 8;   // consumer warps the tilings below assume

// The row of a chunk that holds logical k 8h + r (r < 8) of step s.
__device__ __forceinline__ int chunk_row(int r, int s, int h) { return 8 * (r >> 1) + 4 * s + 2 * h + (r & 1); }

// The unit of row k that holds unit u of a 128-byte row swizzled by
// swizzle_rows8 is u ^ swz8(k). For the 8 rows of one ldmatrix (k0 a
// multiple of 32, r < 8), swz8(k0 + chunk_row(r, s, h)) = r.
__device__ __forceinline__ int swz8(int k) { return (((k >> 3) & 3) << 1) | (k & 1); }

__device__ __forceinline__ uint4 lds128(const void* p) { return *reinterpret_cast<const uint4*>(p); }

// d += A · B for one m16n8k16 step; A rows g (a0, a2) and g + 8 (a1, a3).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One chunk: lo and hi are the 16-byte loads of rows g and g + 8, b the
// chunk's B fragments from load_b.
__device__ __forceinline__ void mma_chunk(float (&d)[4], const uint4& lo, const uint4& hi, const uint32_t (&b)[4]) {
  mma_bf16(d, lo.x, hi.x, lo.y, hi.y, b[0], b[1]);  // step 0: k 8q..8q+3
  mma_bf16(d, lo.z, hi.z, lo.w, hi.w, b[2], b[3]);  // step 1: k 8q+4..8q+7
}

// B fragments of n-tile nt (8 output channels) for the chunk whose first
// row is k0, from a [K, 8·R] bf16 buffer (R 16-byte units a row), swizzled
// by swizzle_rows8 (R = 8) or not. b[2s + h] holds step s, half h.
template <int R, bool SWZ>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const unsigned char* buf, int k0, int nt, int lane) {
  static_assert(!SWZ || R == 8, "only 128-byte rows are swizzled");
  const int m = lane >> 3;
  const int k = k0 + chunk_row(lane & 7, m >> 1, m & 1);
  const int unit = SWZ ? (nt ^ swz8(k)) : nt;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(nevo_ring::smem_addr(buf + (k * R + unit) * 16))
               : "memory");
}

// Moves unit u of each 128-byte row k < rows of buf to u ^ swz8(k), one
// row per thread (t of nthreads). Each thread reads its whole row before it
// writes, and starts at a unit rotated by its lane, so that a warp's 32
// rows spread over the banks.
__device__ __forceinline__ void swizzle_rows8(unsigned char* buf, int rows, int t, int nthreads) {
  const int rot = t & 7;
  for (int k = t; k < rows; k += nthreads) {
    unsigned char* row = buf + k * 128;
    uint4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = lds128(row + ((i + rot) & 7) * 16);
    const int sw = swz8(k);
#pragma unroll
    for (int i = 0; i < 8; ++i) *reinterpret_cast<uint4*>(row + ((((i + rot) & 7) ^ sw) * 16)) = v[i];
  }
}

// Stores of one fragment: rows p (sums d0, d1) and p + 8 (d2, d3), output
// channels co and co + 1, rows at or past P skipped.
template <typename Store>
__device__ __forceinline__ void store_frag(const float (&d)[4], int p, int co, int P, Store store) {
  if (p < P) store(p, co, d[0], d[1]);
  if (p + 8 < P) store(p + 8, co, d[2], d[3]);
}

// relu(h + b[co]), rounded to bf16, into rows of `pitch` elements.
struct StoreBf16Rows {
  bf16* x;
  int pitch;
  const float* b;
  __device__ __forceinline__ void operator()(int p, int co, float h0, float h1) const {
    *reinterpret_cast<__nv_bfloat162*>(x + p * pitch + co) =
        __floats2bfloat162_rn(fmaxf(h0 + __ldg(b + co), 0.f), fmaxf(h1 + __ldg(b + co + 1), 0.f));
  }
};

// relu(h + b[co]) in float32, channel-major: x[co·P + p].
struct StoreF32ChannelMajor {
  float* x;
  int P;
  const float* b;
  __device__ __forceinline__ void operator()(int p, int co, float h0, float h1) const {
    x[co * P + p] = fmaxf(h0 + __ldg(b + co), 0.f);
    x[(co + 1) * P + p] = fmaxf(h1 + __ldg(b + co + 1), 0.f);
  }
};

// conv1's B fragments for n-tiles nt0 and nt0 + 1 over all of K = 256, from
// w1 [256, 32] bf16 as it lands (64-byte rows).
__device__ __forceinline__ void load_w1_frags(uint32_t (&b)[2][8][4], const unsigned char* w1, int nt0, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) load_b<4, false>(b[j][c], w1, c * kChunk, nt0 + j, lane);
}

// conv1 on `rows` (≤ 64) patch rows [rows, 256] bf16 as they land (512-byte
// rows): warp w computes m-tile w / 2 and n-tiles 2·(w % 2), +1 (b from
// load_w1_frags), and calls store(row, co, h0, h1) for the rows in range.
// A row past the end reads the last row; its sums are not stored.
template <typename Store>
__device__ __forceinline__ void conv1_rows(const unsigned char* patches, int rows, const uint32_t (&b)[2][8][4],
                                           int warp, int lane, Store store) {
  const int g = lane >> 2, q = lane & 3;
  const int m0 = 16 * (warp >> 1), nt0 = 2 * (warp & 1);
  const unsigned char* lo_row = patches + min(m0 + g, rows - 1) * 512 + q * 16;
  const unsigned char* hi_row = patches + min(m0 + g + 8, rows - 1) * 512 + q * 16;
  float acc[2][4] = {};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint4 lo = lds128(lo_row + c * 64), hi = lds128(hi_row + c * 64);
    mma_chunk(acc[0], lo, hi, b[0][c]);
    mma_chunk(acc[1], lo, hi, b[1][c]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) store_frag(acc[j], m0 + g, 8 * (nt0 + j) + 2 * q, rows, store);
}

// A SAME conv with 64 output channels: out = im2col(x) [HOUT², KS²·CI] ·
// w [KS²·CI, 64], then store(p, co, h0, h1). x: HIN×HIN pixels of CI bf16
// channels, rows of XP elements; zero: at least CI zero bf16 values; w:
// 128-byte rows swizzled by swizzle_rows8. Warp w computes m-tiles
// 2·(w / 2), +1 and n-tiles 4·(w % 2)..+3: each A row is loaded by two
// warps and each B fragment by four.
template <int KS, int STRIDE, int PAD, int HIN, int HOUT, int CI, int XP, typename Store>
__device__ __forceinline__ void conv_mma(const bf16* x, const bf16* zero, const unsigned char* w, int warp,
                                         int lane, Store store) {
  constexpr int P = HOUT * HOUT, CPT = CI / kChunk;
  static_assert(CI % kChunk == 0 && P <= 2 * 16 * (kWarps / 2), "the warps' m-tiles must cover the output");
  static_assert((XP * 2) % 16 == 0, "x rows must be 16-byte aligned");
  const int g = lane >> 2, q = lane & 3;
  const int m0 = 32 * (warp >> 1), nt0 = 4 * (warp & 1);
  int oh[4], ow[4];  // rows g and g + 8 of the warp's two m-tiles
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = m0 + 16 * (r >> 1) + 8 * (r & 1) + g;
    oh[r] = p < P ? p / HOUT : -HIN;  // a row past the output reads zeros
    ow[r] = p % HOUT;
  }
  float acc[2][4][4] = {};
#pragma unroll 1
  for (int tap = 0; tap < KS * KS; ++tap) {
    const int i = tap / KS, j = tap % KS;
    const unsigned char* src[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ih = oh[r] * STRIDE - PAD + i, iw = ow[r] * STRIDE - PAD + j;
      const bool in = ih >= 0 && ih < HIN && iw >= 0 && iw < HIN;
      src[r] = reinterpret_cast<const unsigned char*>(in ? x + (ih * HIN + iw) * XP : zero) + q * 16;
    }
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int k0 = tap * CI + cc * kChunk;
      uint32_t b[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) load_b<8, true>(b[n], w, k0, nt0 + n, lane);
      uint4 a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = lds128(src[r] + cc * kChunk * 2);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_chunk(acc[m][n], a[2 * m], a[2 * m + 1], b[n]);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) store_frag(acc[m][n], m0 + 16 * m + g, 8 * (nt0 + n) + 2 * q, P, store);
}

}  // namespace nevo_mma
