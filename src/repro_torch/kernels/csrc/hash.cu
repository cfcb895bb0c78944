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
// Design: one thread per key, 128 keys per block, and at 65,536 keys one
// wave of ~16 warps an SM, so the kernel pays one memory latency and its
// launch, and what matters is how much of that latency each thread keeps
// in flight.  Where KW % 4 == 0 and the keys are 16-byte aligned (every
// row then is too), a thread loads its row straight into registers as
// KW / 4 16-byte vectors, all issued before the first chain step; the
// 32 rows a warp reads lie side by side, so the sectors one load
// instruction misses are the next instructions' hits in L1.  The word
// premix (k * C1, rotl 15, * C2) does not depend on h, so the whole key is
// premixed first and the hi and lo chains then run interleaved, two
// independent chains of KW dependent steps.  KW = 20, the main path's
// width, is a template instantiation, so both chains unroll; other widths
// that allow vectors run the same loop over a runtime chunk count.  Every
// other width or alignment takes 4-byte loads of its own row (the L1
// again serves the warp's neighbouring rows).  The pair is written as
// one 8-byte store.
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kThreads = 128;
// The widest key the wrapper takes (its contract; the kernels themselves
// would take any width).
constexpr int kMaxKw = 48 * 1024 / 4 / kThreads - 1;

__device__ __forceinline__ void fold4(uint4 v, uint32_t& hi, uint32_t& lo) {
  const uint32_t k0 = repro::murmur_premix(v.x);
  const uint32_t k1 = repro::murmur_premix(v.y);
  const uint32_t k2 = repro::murmur_premix(v.z);
  const uint32_t k3 = repro::murmur_premix(v.w);
  hi = repro::murmur_mix(hi, k0);
  lo = repro::murmur_mix(lo, k0);
  hi = repro::murmur_mix(hi, k1);
  lo = repro::murmur_mix(lo, k1);
  hi = repro::murmur_mix(hi, k2);
  lo = repro::murmur_mix(lo, k2);
  hi = repro::murmur_mix(hi, k3);
  lo = repro::murmur_mix(lo, k3);
}

__device__ __forceinline__ uint2 finish(uint32_t hi, uint32_t lo, int kw) {
  return make_uint2(repro::murmur_finish(hi, kw),
                    repro::murmur_finish(lo, kw));
}

// KW a multiple of 4 known at compile time: every load issued first
template <int KW>
__global__ void __launch_bounds__(kThreads)
    hash64_vec_kernel(const uint4* __restrict__ keys,
                      uint2* __restrict__ out, int64_t n) {
  constexpr int kChunks = KW / 4;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (row >= n) return;
  const uint4* src = keys + row * kChunks;
  uint4 v[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) v[c] = __ldg(src + c);
  uint32_t hi = repro::kSeedHi;
  uint32_t lo = repro::kSeedLo;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) fold4(v[c], hi, lo);
  out[row] = finish(hi, lo, KW);
}

// KW a multiple of 4 at run time
__global__ void __launch_bounds__(kThreads)
    hash64_vec_any_kernel(const uint4* __restrict__ keys,
                          uint2* __restrict__ out, int64_t n, int chunks) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (row >= n) return;
  const uint4* src = keys + row * chunks;
  uint32_t hi = repro::kSeedHi;
  uint32_t lo = repro::kSeedLo;
#pragma unroll 4
  for (int c = 0; c < chunks; ++c) fold4(__ldg(src + c), hi, lo);
  out[row] = finish(hi, lo, chunks * 4);
}

// any KW and alignment: 4-byte loads
__global__ void __launch_bounds__(kThreads)
    hash64_words_kernel(const uint32_t* __restrict__ keys,
                        uint2* __restrict__ out, int64_t n, int kw) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (row >= n) return;
  const uint32_t* src = keys + row * kw;
  uint32_t hi = repro::kSeedHi;
  uint32_t lo = repro::kSeedLo;
#pragma unroll 4
  for (int i = 0; i < kw; ++i) {
    const uint32_t k = repro::murmur_premix(__ldg(src + i));
    hi = repro::murmur_mix(hi, k);
    lo = repro::murmur_mix(lo, k);
  }
  out[row] = finish(hi, lo, kw);
}

}  // namespace

extern "C" int repro_hash64_max_kw() { return kMaxKw; }

extern "C" int repro_hash64(const void* keys, void* out, long long n, int kw,
                            void* stream) {
  if (kw < 1 || kw > kMaxKw) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint2*>(out);
  const bool vec = kw % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(keys) & 15u) == 0;
  if (vec && kw == 20) {
    hash64_vec_kernel<20><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(keys), o, n);
  } else if (vec) {
    hash64_vec_any_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(keys), o, n, kw / 4);
  } else {
    hash64_words_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(keys), o, n, kw);
  }
  return static_cast<int>(cudaGetLastError());
}
