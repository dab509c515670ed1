// The sm_90 copy primitives shared by the Hopper kernels: mbarriers (with a
// trap on a wait that never completes), 1-D bulk copies from global to
// shared memory that complete an mbarrier's transaction bytes (no tensor
// map), and the launch helpers (the SM count, the dynamic shared memory
// opt-in, resident blocks an SM). sm90.cuh (the wgmma attention kernels),
// decode_attention.cu and woq_matmul.cu include it.
//
// A bulk copy needs its shared and global addresses and its size to be
// multiples of 16 bytes: one that is not stops the card with an illegal
// instruction, so bulk_load traps on it first (the wrappers check the
// tensors' alignment; this guards the offsets the kernels compute).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (then a block
// barrier makes them visible to the other threads)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed; a wait past 10 s
// (a pipeline fault: the kernel takes milliseconds) traps, so the launch
// fails with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

// `bytes` contiguous bytes from global `src` to shared `dst`; completes
// `bar`'s transaction bytes. All three must be multiples of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  if ((dst | bytes | static_cast<uint32_t>(reinterpret_cast<uintptr_t>(src))) &
      15)
    __trap();
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------ launch
// the current device's SMs, asked once per device
cudaError_t sm_count(int* count) {
  static int counts[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64)
    return cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev);
  if (counts[dev] == 0) {
    err = cudaDeviceGetAttribute(&counts[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *count = counts[dev];
  return cudaSuccess;
}

// Let kernel Fn take `bytes` of dynamic shared memory on the current device
// (above 48 KB a kernel must opt in), and say how many of its blocks of
// `threads` fit on an SM then. Both are asked of the runtime once per
// device and size: the decode step calls these kernels in every layer.
template <auto Fn>
cudaError_t fit_smem(int bytes, int threads, int* blocks_per_sm) {
  static int set_bytes[64] = {}, set_blocks[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && set_bytes[dev] == bytes && set_blocks[dev] > 0) {
    *blocks_per_sm = set_blocks[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(Fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, Fn,
                                                      threads, bytes);
  if (err != cudaSuccess) return err;
  if (*blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  if (dev < 64) {
    set_bytes[dev] = bytes;
    set_blocks[dev] = *blocks_per_sm;
  }
  return cudaSuccess;
}

}  // namespace
