// Hopper's warpgroup products (wgmma) as the port's kernels issue them
// (flash_attention's bfloat16 instantiation, dp_mix's large-N mix): the
// shared-memory matrix descriptor, the fences around the asynchronous
// window, and the waits.
#pragma once

#include <cstdint>

namespace repro_wgmma {

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets between core matrices (16-byte units), swizzle mode
// in bits 62-63 (0: none, 1: 128-byte, 2: 64-byte, 3: 32-byte)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most Pending of this warpgroup's committed groups are in flight
template <int Pending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(Pending) : "memory");
}

// keeps the compiler from moving reads or writes of these registers (an
// accumulator, an A fragment) across the asynchronous wgmma window
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

}  // namespace repro_wgmma
