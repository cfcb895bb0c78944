// Batched 64-bit key hash: (N, KW) uint32 keys -> (N, 2) uint32 [hi, lo],
// two murmur3 chains seeded 0x9E3779B9 (hi) and 0x85EBCA77 (lo).
//
// Replaces: repro/kernels/hash_kernel.py hash64_pallas (_hash_kernel).
//
// Bound on the H100: bytes.  Each key is read once (80 B at KW = 20) and
// 8 B are written; the two chains cost ~20 integer operations per word,
// about 800 per key, far below the ALUs' rate for the bytes moved.  At the
// main path's 65536 keys that is 5.8 MB, under 2 us at HBM rate.
//
// Design: one thread per key, 128 keys per block.  A thread reading its
// own key row would stride KW words across the warp, so the block first
// copies its 128 x KW tile into shared memory with consecutive threads on
// consecutive words (coalesced), then each thread runs both chains over
// its row.  The shared row stride is KW rounded up to odd, so the 32 rows
// a warp reads in one step fall in 32 different banks.  The pair is
// written as one 8-byte store.
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kThreads = 128;

__global__ void hash64_kernel(const uint32_t* __restrict__ keys,
                              uint2* __restrict__ out, int64_t n, int kw) {
  extern __shared__ uint32_t tile[];
  const int stride = kw | 1;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t left = n - row0;
  const int rows = left < kThreads ? static_cast<int>(left) : kThreads;
  const uint32_t* src = keys + row0 * kw;
  for (int i = threadIdx.x; i < rows * kw; i += kThreads) {
    const int r = i / kw;
    tile[r * stride + (i - r * kw)] = src[i];
  }
  __syncthreads();
  if (threadIdx.x >= rows) return;
  const uint32_t* k = tile + threadIdx.x * stride;
  uint32_t hi = repro::kSeedHi;
  uint32_t lo = repro::kSeedLo;
  for (int i = 0; i < kw; ++i) {
    hi = repro::murmur_step(hi, k[i]);
    lo = repro::murmur_step(lo, k[i]);
  }
  out[row0 + threadIdx.x] =
      make_uint2(repro::murmur_finish(hi, kw), repro::murmur_finish(lo, kw));
}

}  // namespace

// Largest KW whose 128-row tile fits the default 48 KB of shared memory.
extern "C" int repro_hash64_max_kw() { return 48 * 1024 / 4 / kThreads - 1; }

extern "C" int repro_hash64(const void* keys, void* out, long long n, int kw,
                            void* stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(kThreads) * (kw | 1) * 4;
  hash64_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<uint2*>(out), n, kw);
  return static_cast<int>(cudaGetLastError());
}
