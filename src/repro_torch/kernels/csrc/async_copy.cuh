// Block-wide copies between device memory and shared memory, shared by the
// shard-apply and checksum kernels.
//
// cp.async (sm_80+) moves words from device memory into shared memory
// without passing through registers, so a thread can have many of them in
// flight: a block issues every copy of a tile and then waits once
// (cp_async_wait_all + __syncthreads).  16-byte copies are used where the
// source is 16-byte aligned (the shared destination always is), 4-byte
// copies for the rest.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// BYTES (4, 8 or 16) from device memory to shared memory, asynchronously
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}

// wait until every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n contiguous words src -> dst (dst: 16-byte aligned shared memory), spread
// over the block's threads; completes at cp_async_wait_all()
__device__ __forceinline__ void copy_in(uint32_t* dst, const uint32_t* src,
                                        int n) {
  const int nv = aligned16(src) ? n / 4 : 0;
  for (int i = threadIdx.x; i < nv; i += blockDim.x)
    cp_async<16>(dst + 4 * i, src + 4 * i);
  for (int i = 4 * nv + threadIdx.x; i < n; i += blockDim.x)
    cp_async<4>(dst + i, src + i);
}

// n contiguous words src (16-byte aligned shared memory) -> dst, coalesced
// 16-byte stores where dst is 16-byte aligned
__device__ __forceinline__ void copy_out(uint32_t* dst, const uint32_t* src,
                                         int n) {
  const int nv = aligned16(dst) ? n / 4 : 0;
  for (int i = threadIdx.x; i < nv; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  for (int i = 4 * nv + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

}  // namespace repro
