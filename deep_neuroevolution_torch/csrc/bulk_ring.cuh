// Shared-memory rings fed by the TMA's 1D bulk copy (`cp.async.bulk`), for
// kernels K1 (population_linear.cu), K3 (large_dqn_fused.cu), K5
// (dqn_conv_chain.cu) and K4/K6 (vbn_dqn_fused.cu).
//
// A ring is a few stages of shared memory, each guarded by a pair of
// mbarriers: `full[s]` completes when the stage's bulk copies have landed
// (one arrival that announces the bytes, then the copies' completion), and
// `empty[s]` when the consumers have released it (one arrival per consumer
// warp). A producer thread waits on `empty`, announces the bytes on `full`
// and starts the copies; the consumers wait on `full`, read, and arrive on
// `empty`. The copies need no tensor map: source, destination and size
// are multiples of 16 bytes. `Ring` below wraps the pattern for K3-K6;
// K1 keeps its own loop over the barriers.
//
// A consumer runs `fence_proxy_async` before it arrives on `empty`: its
// reads (and any writes) of the stage go through the generic proxy, the
// TMA's refill through the async proxy, and only the fence orders the
// first before the second. Without it K3's first draft read refilled
// stages at small B.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nevo_ring {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// One arrival that also announces `bytes` of bulk copies to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory by the TMA; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier shared-memory reads and writes (generic
// proxy) before the TMA's later writes (async proxy) to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A ring of S stages of BYTES each at `base`, for one producer thread and
// warps of consumers (K3's to K6's). Item i of a block's stream sits in
// stage i % S, in its (i / S)-th use, so the counts may run on from one
// unit of work to the next (K5's members).
template <int S, int BYTES>
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;

  __device__ unsigned char* stage(int i) const { return base + (i % S) * BYTES; }
  // producer: waits for the stage to be free (the first pass finds every
  // stage free), then copies `bytes` from src into it
  __device__ void put(int i, const void* src, int bytes) const {
    const int s = i % S;
    mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[s], bytes);
    bulk_copy_g2s(base + s * BYTES, src, bytes, &full[s]);
  }
  // consumers: waits until item i has landed
  __device__ unsigned char* acquire(int i) const {
    mbar_wait(&full[i % S], (i / S) & 1);
    return stage(i);
  }
  // consumers: a warp frees item i's stage once it has used everything it
  // read from it; the fence orders those reads (and any writes) before the
  // TMA's refill (an ldmatrix whose registers are used only later too)
  __device__ void release(int i, int lane) const {
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % S]);
  }
};

// The ring at `base` with its 2·S barriers at `bars`, released by
// `consumer_warps` warps: thread 0 initialises the barriers, and the
// caller runs __syncthreads before using them.
template <int S, int BYTES>
__device__ __forceinline__ Ring<S, BYTES> ring_init(unsigned char* base, uint64_t* bars, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&bars[s], 1);
      mbar_init(&bars[S + s], consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return Ring<S, BYTES>{base, bars, bars + S};
}

// A ring kernel's dynamic shared memory is above 48 KB, which the runtime
// allows only on request; asked once per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  static const void* allowed[8] = {};
  const void* k = reinterpret_cast<const void*>(kernel);
  for (const void* a : allowed)
    if (a == k) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  for (const void*& a : allowed)
    if (err == cudaSuccess && a == nullptr) {
      a = k;
      break;
    }
  return err;
}

}  // namespace nevo_ring
