// The ring designs of K2 (deep_neuroevolution_torch/csrc/noise_gradient.cu),
// kept for scripts/torch_k2_ab.py --ring, which builds this file on its own
// and times it against the shipped kernel. Both compute the shipped
// kernel's g bit for bit: the same sorted order, the same persistent grid
// and tiles, each output one thread's accumulator. They differ only in how
// a tile's elements reach the SMs:
// - `nevo_noise_gradient_all_ring`: every output of a tile through a ring
//   of bulk copies (`nevo_ring::Ring`). A producer warp copies, for each
//   sorted pair, the 16-byte-aligned superset of the tile's window with one
//   `cp.async.bulk` into a stage; sixteen consumer warps read it at a shift
//   of (idx + j0) mod 4 floats and release the stage after the proxy fence.
// - `nevo_noise_gradient` (the entry the A/B calls): a tile's first 1024
//   outputs through the ring (four consumer warps), the rest by plain loads
//   (sixteen warps, each lane one float of a 128-byte row a load) that are
//   held to the ring's barriers, so a block's two halves read the same
//   stretch of the table.
// A window's copy stops at the last 16-byte boundary at or before the
// slice's own end, idx + D; the fewer than four floats of the slice past it
// are read with plain loads, so nothing past table[N - 1] is read. The
// table must start on a 16-byte boundary.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../deep_neuroevolution_torch/csrc/bulk_ring.cuh"

namespace {

constexpr int kTileMax = 8184;  // outputs a block sums at a time (a multiple of 4)
constexpr int kCap = 8192;      // pairs sorted at a time
constexpr int kKeyBytes = kCap * 8;

__host__ __device__ constexpr int round128(int bytes) { return (bytes + 127) & ~127; }

// How a block's warps split a tile of outputs: its first kRingLen outputs
// come through the ring (kRingWarps consumer warps, kRingPer outputs a
// thread, and the producer warp), the rest straight from the table
// (kDirectWarps warps, kDirectPer outputs a thread). A stage holds a ring
// window: kRingLen floats and up to 3 of alignment at each end.
template <int kRingWarps_, int kRingPer_, int kDirectWarps_, int kDirectPer_>
struct Split {
  static constexpr int kRingWarps = kRingWarps_, kRingPer = kRingPer_;
  static constexpr int kDirectWarps = kDirectWarps_, kDirectPer = kDirectPer_;
  static constexpr int kRing = 32 * kRingWarps, kDirect = 32 * kDirectWarps;
  static constexpr int kThreads = kRing + kDirect + (kRingWarps ? 32 : 0);
  static constexpr int kRingLen = kRing * kRingPer < kTileMax ? kRing * kRingPer : kTileMax;
  static constexpr int kStageBytes = round128(4 * (kRingLen + 6));
  static constexpr int kStages = 131072 / kStageBytes < 8 ? 131072 / kStageBytes : 8;
  static constexpr int kKeysOff = kStages * kStageBytes;
  static constexpr int kBarOff = kKeysOff + kKeyBytes;
  static constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;
  static_assert(kRingLen + kDirect * kDirectPer >= kTileMax, "the warps must cover a tile");
  static_assert(kStageBytes <= 32768 && kStages >= 4, "a ring of at least four stages");
  static_assert(kSmemBytes <= 232448, "shared memory of one block an SM");
};
using RingSplit = Split<4, 8, 16, 14>;  // 1024 outputs a tile through the ring, 7160 or fewer by plain loads
using AllRing = Split<16, 16, 0, 1>;    // every output through the ring

// Outputs are cut into `tiles` tiles of `tile` floats (the last shorter);
// block b takes tiles b, b + grid, ... (`rounds` at most), as in the shipped
// kernel.
struct Geometry {
  long long tile, tiles;
  int grid, rounds;
};

Geometry geometry(long long D, int sms) {
  const long long need = (D + kTileMax - 1) / kTileMax;
  const long long rounds = (need + sms - 1) / sms;
  long long tile = (D + rounds * sms - 1) / (rounds * sms);
  tile = (tile + 3) & ~3LL;
  const long long tiles = (D + tile - 1) / tile;
  return Geometry{tile, tiles, (int)(tiles < sms ? tiles : sms), (int)rounds};
}

// Sorts pairs [p0, p0 + n) by (offset, pair index) into keys[0, n), then
// replaces each key by (offset << 32 | bits of the pair's weight). Entered
// and left by every thread of the block.
template <int kThreads>
__device__ void sort_chunk(unsigned long long* keys, const int* __restrict__ idx, const float* __restrict__ w,
                           int p0, int n) {
  int P = 1;
  while (P < n) P <<= 1;
  __syncthreads();  // every thread is done with the previous chunk's keys
  for (int k = threadIdx.x; k < P; k += kThreads)
    keys[k] = k < n ? (unsigned long long)(unsigned)idx[p0 + k] << 32 | (unsigned)(p0 + k) : ~0ull;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += kThreads) {
        const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const unsigned long long kv = keys[k];
    keys[k] = (kv & ~0xffffffffull) | __float_as_uint(w[(unsigned)kv]);
  }
  __syncthreads();
}

// Pair (offset `off`) at outputs [j0, j0 + len): its window starts at a =
// (off + j0) rounded down to 4 floats, shift = off + j0 - a; the copy is
// `copy` floats from a, ending at the 4-float boundary at or before
// off + D. Window positions shift + p with p < copy - shift come from the
// stage, the rest (fewer than 4) from the table.
struct Window {
  long long a;
  int shift, copy;
};

__device__ __forceinline__ Window window(long long off, long long j0, int len, long long D) {
  const long long s0 = off + j0, a = s0 & ~3LL;
  long long end = (s0 + len + 3) & ~3LL;
  const long long slice_end = (off + D) & ~3LL;
  if (end > slice_end) end = slice_end;
  return Window{a, (int)(s0 - a), end > a ? (int)(end - a) : 0};
}

enum Role { kProducerWarp, kRingWarp, kDirectWarp };

// One warp's walk of its block's tiles, every pair of each, in the sorted
// order. The roles walk in step: every warp sorts each chunk with the
// others, and the ring's barriers hold the direct warps too, so a block's
// warps stay within the ring's stages of each other and read the same
// stretch of the table.
template <class S, Role kRole>
__device__ __forceinline__ void walk(const float* __restrict__ table, const int* __restrict__ idx,
                                     const float* __restrict__ w, int B, long long D, const Geometry& geo,
                                     float* __restrict__ g, unsigned long long* keys,
                                     const nevo_ring::Ring<S::kStages, S::kStageBytes>& ring) {
  constexpr int kPer = kRole == kRingWarp ? S::kRingPer : S::kDirectPer;
  constexpr int kStride = kRole == kRingWarp ? S::kRing : S::kDirect;
  const int lane = threadIdx.x % 32;
  int item = 0;  // pairs walked so far, over every tile: the ring's item count
  for (int r = 0; r < geo.rounds; ++r) {
    const long long t = (long long)r * gridDim.x + blockIdx.x;
    if (t >= geo.tiles) break;
    const long long j0 = t * geo.tile;
    const int len = (int)(D - j0 < geo.tile ? D - j0 : geo.tile);
    const int lr = len < S::kRingLen ? len : S::kRingLen;  // [j0, j0 + lr) through the ring
    // this thread's outputs: j0 + first + m·kStride for m < kPer, below j0 + last
    const int first = kRole == kRingWarp ? (int)threadIdx.x : lr + (int)threadIdx.x - S::kRing;
    const int last = kRole == kRingWarp ? lr : len;
    float acc[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) acc[m] = 0.f;

    for (int p0 = 0; p0 < B; p0 += kCap) {
      const int n = B - p0 < kCap ? B - p0 : kCap;
      if (B > kCap || r == 0) sort_chunk<S::kThreads>(keys, idx, w, p0, n);
      if constexpr (kRole == kProducerWarp) {
        if (lane == 0)
          for (int k = 0; k < n; ++k) {
            const int i = item + k;
            const Window win = window((long long)(keys[k] >> 32), j0, lr, D);
            if (win.copy > 0) {
              ring.put(i, table + win.a, win.copy * 4);
            } else {  // the ring's outputs lie in the slice's last 4-float group: nothing to copy
              nevo_ring::mbar_wait(&ring.empty[i % S::kStages], ((i / S::kStages) & 1) ^ 1);
              nevo_ring::mbar_arrive(&ring.full[i % S::kStages]);
            }
          }
        __syncwarp();
      } else {
        for (int k = 0; k < n; ++k) {
          const unsigned long long kv = keys[k];
          const long long off = (long long)(kv >> 32);
          const float wk = __uint_as_float((unsigned)kv);
          float x[kPer];  // every load of the pair first, then the FMAs
          if constexpr (kRole == kRingWarp) {
            const Window win = window(off, j0, lr, D);
            const float* st = reinterpret_cast<const float*>(ring.acquire(item + k)) + win.shift;
            const int fast = win.copy - win.shift;  // positions p < fast come from the stage
            if (fast >= lr) {
#pragma unroll
              for (int m = 0; m < kPer; ++m) {
                const int p = first + m * kStride;
                x[m] = p < last ? st[p] : 0.f;
              }
            } else {
              const float* tail = table + off + j0;
#pragma unroll
              for (int m = 0; m < kPer; ++m) {
                const int p = first + m * kStride;
                x[m] = p < last ? (p < fast ? st[p] : __ldg(tail + p)) : 0.f;
              }
            }
            ring.release(item + k, lane);
          } else {
            if constexpr (S::kRingWarps > 0) {  // in step with the ring; the stage is not read
              ring.acquire(item + k);
              __syncwarp();
              if (lane == 0) nevo_ring::mbar_arrive(&ring.empty[(item + k) % S::kStages]);
            }
            const float* slice = table + off + j0;
#pragma unroll
            for (int m = 0; m < kPer; ++m) {
              const int p = first + m * kStride;
              x[m] = p < last ? __ldg(slice + p) : 0.f;
            }
          }
#pragma unroll
          for (int m = 0; m < kPer; ++m) acc[m] = fmaf(wk, x[m], acc[m]);
        }
      }
      item += n;
    }
    if constexpr (kRole != kProducerWarp) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int p = first + m * kStride;
        if (p < last) g[j0 + p] = acc[m];
      }
    }
  }
}

template <class S>
__global__ void __launch_bounds__(S::kThreads, 1)
    noise_gradient_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                          const float* __restrict__ w, int B, long long D, Geometry geo, float* __restrict__ g) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + S::kKeysOff);
  // every consumer warp, ring or direct, releases each stage
  const auto ring = nevo_ring::ring_init<S::kStages, S::kStageBytes>(
      smem, reinterpret_cast<uint64_t*>(smem + S::kBarOff), S::kRingWarps + S::kDirectWarps);
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (warp < S::kRingWarps)
    walk<S, kRingWarp>(table, idx, w, B, D, geo, g, keys, ring);
  else if (warp < S::kRingWarps + S::kDirectWarps)
    walk<S, kDirectWarp>(table, idx, w, B, D, geo, g, keys, ring);
  else
    walk<S, kProducerWarp>(table, idx, w, B, D, geo, g, keys, ring);
}

int sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = cached;
  return 0;
}

template <class S>
int launch(const void* table, const void* idx, const void* w, int B, long long D, void* g, void* stream) {
  if (D <= 0) return 0;
  if (B < 0 || reinterpret_cast<uintptr_t>(table) % 16) return (int)cudaErrorInvalidValue;
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  const Geometry geo = geometry(D, sms);
  err = (int)nevo_ring::allow_smem(noise_gradient_kernel<S>, S::kSmemBytes);
  if (err) return err;
  noise_gradient_kernel<S><<<geo.grid, S::kThreads, S::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx), static_cast<const float*>(w), B, D, geo,
      static_cast<float*>(g));
  return (int)cudaGetLastError();
}

}  // namespace

// The shipped entry's arguments and contract (table 16-byte aligned): a
// tile's first 1024 outputs through the ring, the rest by plain loads.
extern "C" int nevo_noise_gradient(const void* table, const void* idx, const void* w, int B, long long D, void* g,
                                   void* stream) {
  return launch<RingSplit>(table, idx, w, B, D, g, stream);
}

// The same, every output through the ring.
extern "C" int nevo_noise_gradient_all_ring(const void* table, const void* idx, const void* w, int B, long long D,
                                            void* g, void* stream) {
  return launch<AllRing>(table, idx, w, B, D, g, stream);
}
