// noise_gradient: g[d] = Σᵢ w[i] · table[idx[i] + d] for d in [0, D).
//
// Replaces the TPU kernel `gradient_from_noise_pallas` (`_grad_kernel`) of
// deep_neuroevolution_tpu/ops/pallas_kernels.py: the ES gradient, a sum of
// B noise-table slices of length D weighted by the pairs' rank weights.
// On the main path B = 2500 pairs and D ≈ 1.0 M parameters, over a table
// of 250 M floats.
//
// What bounds it on the H100. In principle HBM bytes: slices that overlap
// share bytes, so the least that must come from device memory is the
// union of the slices (about 1 GB at the main-path shape, 0.30 ms). In
// practice the delivery of B · D · 4 bytes (10 GB) from L2 to the SMs:
// every output needs every pair's element, and one slice's window repeats
// about 400 KB later in the table, too far apart for shared memory to
// keep. The FMAs (two operations per element) are cheap beside either.
//
// What the design does about it:
// - Sorted order, computed in the kernel. Each block sorts the (offset,
//   pair) keys in shared memory at entry (bitonic, ties broken by the pair
//   index, so the order is total and a repeat bit-identical), up to kCap
//   pairs at a time; past that it walks the pairs in consecutive chunks of
//   kCap, each sorted, into the same sums.
// - A persistent grid that walks the sorted pairs together. Each block
//   (one an SM) owns an equal contiguous tile of outputs (D / 132, about
//   7.6 K floats at the ES model) and walks every pair in sorted order, so
//   the grid reads a window of the table a few MB wide that moves forward:
//   a byte fetched from HBM by one block is read again from L2 by the
//   blocks below it, and HBM traffic falls toward the union.
// - L2-to-SM delivery by plain loads. Sixteen warps read a pair's slice of
//   the tile, each lane one float of a 128-byte row a load, and every
//   thread starts all of a pair's loads (one base address, immediate
//   offsets) before its FMAs. On the H100 this
//   drew L2's bytes faster than a ring of bulk copies (PERF.md §6: the ring
//   designs of scripts/torch_k2_ring.cu, timed by scripts/torch_k2_ab.py
//   --ring). Each output is one thread's register accumulator, summed in
//   the sorted order: no atomics.
// - The table's edges. A thread reads table[idx + d] only for d < D, so
//   with idx + D <= N (the wrapper checks it) nothing past table[N - 1] is
//   read. The loads are scalar: any offset and any table view will do.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 16;        // outputs a thread sums, kThreads apart
constexpr int kTileMax = 8184;  // outputs a block sums at a time (a multiple of 4, at most kThreads · kPer)
constexpr int kCap = 8192;      // pairs sorted at a time
constexpr int kSmemBytes = kCap * 8;
static_assert(kTileMax <= kThreads * kPer, "the threads must cover a tile");

// Outputs are cut into `tiles` tiles of `tile` floats (the last shorter);
// block b takes tiles b, b + grid, ... (`rounds` at most). ops/noise_gradient.py
// `plan` mirrors this.
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
__device__ void sort_chunk(unsigned long long* keys, const int* __restrict__ idx, const float* __restrict__ w, int p0,
                           int n) {
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

// Each block walks its tiles, every pair of each in the sorted order;
// thread t sums outputs j0 + t + m · kThreads of a tile for m < held.
__global__ void __launch_bounds__(kThreads, 1)
    noise_gradient_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                          const float* __restrict__ w, int B, long long D, Geometry geo, float* __restrict__ g) {
  extern __shared__ __align__(16) unsigned long long keys[];
  for (int r = 0; r < geo.rounds; ++r) {
    const long long t = (long long)r * gridDim.x + blockIdx.x;
    if (t >= geo.tiles) break;
    const long long j0 = t * geo.tile;
    const int len = (int)(D - j0 < geo.tile ? D - j0 : geo.tile);
    float acc[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) acc[m] = 0.f;
    const float* const mine = table + j0 + threadIdx.x;  // at offset 0, this thread's first output
    const int held = len > (int)threadIdx.x ? (len - (int)threadIdx.x + kThreads - 1) / kThreads : 0;

    for (int p0 = 0; p0 < B; p0 += kCap) {
      const int n = B - p0 < kCap ? B - p0 : kCap;
      if (B > kCap || r == 0) sort_chunk(keys, idx, w, p0, n);
      for (int k = 0; k < n; ++k) {
        const unsigned long long kv = keys[k];
        const float wk = __uint_as_float((unsigned)kv);
        const float* src = mine + (kv >> 32);
        // Opaque to the compiler: left visible, src + m·kThreads is split
        // into kPer 64-bit bases rebuilt every pair, and the loop is bound
        // by integer instructions (PERF.md §6); opaque, the loads take one
        // base and immediate offsets.
        asm("mov.b64 %0, %0;" : "+l"(src));
        float x[kPer];  // every load of the pair first, then the FMAs
#pragma unroll
        for (int m = 0; m < kPer; ++m) x[m] = m < held ? __ldg(src + m * kThreads) : 0.f;
#pragma unroll
        for (int m = 0; m < kPer; ++m) acc[m] = fmaf(wk, x[m], acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int p = threadIdx.x + m * kThreads;
      if (p < len) g[j0 + p] = acc[m];
    }
  }
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

// Repeated 16-byte reads of `n16` vectors at `buf` by every SM, `reps`
// times over, bypassing L1: with a buffer that fits L2, the rate at which
// L2 delivers bytes to the SMs. Each thread writes its sum to out.
__global__ void __launch_bounds__(512) l2_read_kernel(const float4* __restrict__ buf, long long n16, int reps,
                                                     float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  for (int r = 0; r < reps; ++r)
    for (long long i = t; i < n16; i += stride) {
      const float4 v = __ldcg(buf + i);
      s += (v.x + v.y) + (v.z + v.w);
    }
  out[t] = s;
}

}  // namespace

// table [N] f32; idx [B] int32 with 0 <= idx[i] and idx[i] + D <= N
// (checked by the caller); w [B] f32; g [D] f32 (written in full). Returns
// the cudaError_t of the shared-memory attribute or of the launch (0 on
// success); cudaErrorInvalidValue for B < 0.
extern "C" int nevo_noise_gradient(const void* table, const void* idx, const void* w, int B, long long D, void* g,
                                   void* stream) {
  if (D <= 0) return 0;
  if (B < 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  static bool smem_allowed = false;
  if (!smem_allowed) {
    err = (int)cudaFuncSetAttribute(noise_gradient_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err) return err;
    smem_allowed = true;
  }
  const Geometry geo = geometry(D, sms);
  noise_gradient_kernel<<<geo.grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx), static_cast<const float*>(w), B, D, geo,
      static_cast<float*>(g));
  return (int)cudaGetLastError();
}

// The kernel's geometry for D outputs on `sms` SMs, for the Python plan to
// be checked against: out = {tile, tiles, grid, rounds, kCap, kTileMax,
// kThreads, kPer}.
extern "C" void nevo_noise_gradient_geometry(long long D, int sms, long long* out) {
  const Geometry geo = geometry(D, sms);
  const long long v[8] = {geo.tile, geo.tiles, geo.grid, geo.rounds, kCap, kTileMax, kThreads, kPer};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// The L2 probe: grid·512 threads read n16 16-byte vectors `reps` times;
// out holds grid·512 floats. Returns the launch's cudaError_t.
extern "C" int nevo_l2_read_probe(const void* buf, long long n16, int reps, int grid, void* out, void* stream) {
  l2_read_kernel<<<grid, 512, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float4*>(buf), n16, reps,
                                                                      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
