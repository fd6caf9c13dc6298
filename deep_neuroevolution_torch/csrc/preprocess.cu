// The device half of an Atari step's observation (envs/preprocess.py):
//
// - nevo_preprocess_frames: uint8 frame pairs [B, 2, H, W] → float32
//   [B, out_h, out_w] (the caller's [..., 1]): each pixel's luminance
//   max(T[a], T[b]) over the pair through a 256-entry float32 table T,
//   then the align-corners bilinear resize, rows first, columns second.
// - nevo_stack_push: the 4-frame stack's push, out[p, :n-1] = stack[p, 1:]
//   and out[p, n-1] = frame[p], into a new [P, n] float32 stack.
//
// Replaces no TPU kernel: XLA lowered deep_neuroevolution_tpu/envs/
// preprocess.py, and the port ran the same chain as stock PyTorch ops (a
// uint8 pair max, a cast, a scale, two float32 matmuls with the mostly-zero
// interpolation matrices, a cat). Added on the benchmark's spans of the
// population step, where that chain took 5.3 of 17.4 device ms a step
// (5000 VBN-DQN members) and 1.1 of 4.3 (1000 LargeDQN members) on an H100,
// about ten times what its bytes need.
//
// What bounds both on the H100: HBM bytes. The frames kernel reads a
// member's 2 · H · W bytes and writes out_h · out_w floats (95 KB at 210 ×
// 160 → 84 × 84) and does a few multiply-adds an output; the stack push reads
// and writes 4 floats a pixel and reads one. What the design does about it:
// - Nothing in between goes to device memory. A block takes a few output
//   rows of one member: it reads only the input rows their taps name (at
//   210 → 84 about 4 in 5), 16 bytes a load from both frames at once, and
//   keeps the row pass in shared memory ([rows][W] float32) for the column
//   pass, which writes the outputs 16 bytes a store. Blocks are small (128
//   threads of 40 registers, 8.5 KB of shared memory at 84 × 160), so 12
//   of them, 1536 threads each with 64 bytes of loads, are in flight on
//   each SM, and the grid (7 blocks a member there) leaves a short tail.
// - The taps (lo, hi, w_lo, w_hi) of every output row and column come from
//   the wrapper, read off the interpolation matrices' nonzeros, so the
//   weights are the matrices' own. Each output is
//   fma(w_hi, v[hi], w_lo · v[lo]), rows then columns: the product R·img·C
//   with its zeros left out, in the order of its sums.
// - A table that never decreases (the gray scale) takes the max of the two
//   bytes and one lookup: max(T[a], T[b]) = T[max(a, b)] for such a table.
//   The palette of indexed frames takes both lookups.
// - The stack push at n = 4 is one 16-byte load, one 4-byte load and one
//   16-byte store a pixel; any other n or an unaligned stack takes one
//   thread an element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTableSize = 256;
constexpr int kMaxSmem = 48 * 1024;  // a block's shared memory without the opt-in

struct __align__(16) Tap {  // one output row's or column's two input taps, as the wrapper packs them
  int lo, hi;
  float wlo, whi;
};

__device__ __forceinline__ float luma(const float* T, unsigned a, unsigned b, bool monotone) {
  return monotone ? T[a > b ? a : b] : fmaxf(T[a], T[b]);
}

__device__ __forceinline__ float tap(const Tap& t, float lo, float hi) {
  return fmaf(t.whi, hi, __fmul_rn(t.wlo, lo));
}

// Grid (B, chunks): block (b, c) computes output rows [c · rows, c · rows +
// rows) of member b. kInVec: W % 16 == 0 and the frames 16-byte aligned;
// kOutVec: out_w % 4 == 0.
template <bool kInVec, bool kOutVec>
__global__ void __launch_bounds__(kThreads) preprocess_frames_kernel(const uint8_t* __restrict__ frames,
                                                                     const float* __restrict__ table,
                                                                     const Tap* __restrict__ row_taps,
                                                                     const Tap* __restrict__ col_taps,
                                                                     float* __restrict__ out, int H, int W,
                                                                     int out_h, int out_w, int rows, int monotone) {
  extern __shared__ float4 smem[];
  float* T = reinterpret_cast<float*>(smem);
  float* Y = T + kTableSize;  // the row pass, [rows][W]
  for (int i = threadIdx.x; i < kTableSize; i += kThreads) T[i] = table[i];
  __syncthreads();

  const int r0 = blockIdx.y * rows;
  const int nr = min(rows, out_h - r0);
  const size_t plane = (size_t)H * W;
  const uint8_t* f0 = frames + (size_t)blockIdx.x * 2 * plane;
  const uint8_t* f1 = f0 + plane;
  const bool mono = monotone != 0;

  if (kInVec) {
    const int nv = W / 16;
    for (int it = threadIdx.x; it < nr * nv; it += kThreads) {
      const int r = it / nv, x = (it - r * nv) * 16;
      const Tap t = row_taps[r0 + r];
      const uint4 a0 = __ldcs(reinterpret_cast<const uint4*>(f0 + (size_t)t.lo * W + x));
      const uint4 a1 = __ldcs(reinterpret_cast<const uint4*>(f1 + (size_t)t.lo * W + x));
      const uint4 b0 = __ldcs(reinterpret_cast<const uint4*>(f0 + (size_t)t.hi * W + x));
      const uint4 b1 = __ldcs(reinterpret_cast<const uint4*>(f1 + (size_t)t.hi * W + x));
      const unsigned wa0[4] = {a0.x, a0.y, a0.z, a0.w}, wa1[4] = {a1.x, a1.y, a1.z, a1.w};
      const unsigned wb0[4] = {b0.x, b0.y, b0.z, b0.w}, wb1[4] = {b1.x, b1.y, b1.z, b1.w};
      float4* dst = reinterpret_cast<float4*>(Y + r * W + x);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int s = 8 * k;
          const float lo = luma(T, (wa0[w] >> s) & 0xFF, (wa1[w] >> s) & 0xFF, mono);
          const float hi = luma(T, (wb0[w] >> s) & 0xFF, (wb1[w] >> s) & 0xFF, mono);
          v[k] = tap(t, lo, hi);
        }
        dst[w] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  } else {
    for (int it = threadIdx.x; it < nr * W; it += kThreads) {
      const int r = it / W, x = it - r * W;
      const Tap t = row_taps[r0 + r];
      const size_t lo = (size_t)t.lo * W + x, hi = (size_t)t.hi * W + x;
      Y[r * W + x] = tap(t, luma(T, f0[lo], f1[lo], mono), luma(T, f0[hi], f1[hi], mono));
    }
  }
  __syncthreads();

  float* o = out + ((size_t)blockIdx.x * out_h + r0) * out_w;
  if (kOutVec) {
    const int nq = out_w / 4;
    for (int it = threadIdx.x; it < nr * nq; it += kThreads) {
      const int r = it / nq, j = (it - r * nq) * 4;
      const float* y = Y + r * W;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const Tap t = col_taps[j + k];
        v[k] = tap(t, y[t.lo], y[t.hi]);
      }
      *reinterpret_cast<float4*>(o + (size_t)r * out_w + j) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int it = threadIdx.x; it < nr * out_w; it += kThreads) {
      const int r = it / out_w, j = it - r * out_w;
      const Tap t = col_taps[j];
      o[(size_t)r * out_w + j] = tap(t, Y[r * W + t.lo], Y[r * W + t.hi]);
    }
  }
}

__global__ void __launch_bounds__(256) stack_push4_kernel(const float4* __restrict__ stack,
                                                         const float* __restrict__ frame,
                                                         float4* __restrict__ out, long long P) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float4 s = __ldcs(stack + p);
  out[p] = make_float4(s.y, s.z, s.w, frame[p]);
}

__global__ void __launch_bounds__(256) stack_push_kernel(const float* __restrict__ stack,
                                                        const float* __restrict__ frame, float* __restrict__ out,
                                                        long long P, int n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P * n) return;
  const long long p = e / n;
  out[e] = e - p * n < n - 1 ? stack[e + 1] : frame[p];
}

template <bool kInVec, bool kOutVec>
cudaError_t launch_frames(dim3 grid, int smem, cudaStream_t stream, const uint8_t* frames, const float* table,
                          const Tap* taps, float* out, int H, int W, int out_h, int out_w, int rows, int monotone) {
  preprocess_frames_kernel<kInVec, kOutVec><<<grid, kThreads, smem, stream>>>(
      frames, table, taps, taps + out_h, out, H, W, out_h, out_w, rows, monotone);
  return cudaGetLastError();
}

}  // namespace

// frames: uint8 [B, 2, H, W]; table: float32 [256]; taps: [out_h + out_w]
// Taps, the rows' then the columns'; out: float32 [B, out_h, out_w].
// monotone: the table never decreases. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int nevo_preprocess_frames(const void* frames, const void* table, const void* taps, void* out, int B,
                                      int H, int W, int out_h, int out_w, int monotone, void* stream) {
  if (B < 0 || H < 1 || W < 1 || out_h < 1 || out_w < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const bool in_vec = W % 16 == 0 && reinterpret_cast<uintptr_t>(frames) % 16 == 0;
  const bool out_vec = out_w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // output rows a block: about one item of the row pass a thread, within
  // 48 KB of shared memory, and spread evenly over the chunks
  const int items = in_vec ? W / 16 : W;
  const int fit = (kMaxSmem - kTableSize * 4) / (W * 4);
  int rows = max(1, kThreads / items);
  rows = min(rows, fit);
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const int chunks0 = (out_h + rows - 1) / rows;
  rows = (out_h + chunks0 - 1) / chunks0;
  const int chunks = (out_h + rows - 1) / rows;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, chunks);
  const int smem = (kTableSize + rows * W) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  const float* T = static_cast<const float*>(table);
  const Tap* tp = static_cast<const Tap*>(taps);
  float* o = static_cast<float*>(out);
  cudaError_t e;
  if (in_vec)
    e = out_vec ? launch_frames<true, true>(grid, smem, s, f, T, tp, o, H, W, out_h, out_w, rows, monotone)
                : launch_frames<true, false>(grid, smem, s, f, T, tp, o, H, W, out_h, out_w, rows, monotone);
  else
    e = out_vec ? launch_frames<false, true>(grid, smem, s, f, T, tp, o, H, W, out_h, out_w, rows, monotone)
                : launch_frames<false, false>(grid, smem, s, f, T, tp, o, H, W, out_h, out_w, rows, monotone);
  return (int)e;
}

// stack: float32 [P, n]; frame: float32 [P]; out: float32 [P, n], a new
// buffer. Returns the cudaError_t of the launch (0 on success).
extern "C" int nevo_stack_push(const void* stack, const void* frame, void* out, long long P, int n, void* stream) {
  if (P < 0 || n < 1) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec =
      n == 4 && reinterpret_cast<uintptr_t>(stack) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long work = vec ? P : P * n;
  const long long blocks = (work + 255) / 256;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (vec)
    stack_push4_kernel<<<(unsigned)blocks, 256, 0, s>>>(static_cast<const float4*>(stack),
                                                        static_cast<const float*>(frame), static_cast<float4*>(out), P);
  else
    stack_push_kernel<<<(unsigned)blocks, 256, 0, s>>>(static_cast<const float*>(stack),
                                                       static_cast<const float*>(frame), static_cast<float*>(out), P, n);
  return (int)cudaGetLastError();
}
