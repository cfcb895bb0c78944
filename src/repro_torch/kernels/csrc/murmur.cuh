// murmur3-style 32-bit mixing shared by the hash and shard-apply kernels.
//
// Bit for bit the chain of repro.core.hashing.murmur32_words (and of its
// plain torch copy in repro_torch/core/hashing.py): per word
//   k *= C1; k = rotl(k, 15); k *= C2; h ^= k; h = rotl(h, 13); h = 5h + N
// then h ^= 4 * n_words and the fmix32 finalizer.  uint32 arithmetic wraps
// natively here, so no masking is needed.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr uint32_t kSeedHi = 0x9E3779B9u;
constexpr uint32_t kSeedLo = 0x85EBCA77u;
constexpr uint32_t kChecksumSeed = 0xB5297A4Du;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The two halves of a step: the word's premix, which does not depend on
// h (so a kernel can premix a whole key before either chain), and the
// chain step that folds a premixed word into h.  A zero word premixes to
// zero.
__device__ __forceinline__ uint32_t murmur_premix(uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  return k * 0x1B873593u;
}

__device__ __forceinline__ uint32_t murmur_mix(uint32_t h, uint32_t km) {
  h ^= km;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t murmur_step(uint32_t h, uint32_t k) {
  return murmur_mix(h, murmur_premix(k));
}

__device__ __forceinline__ uint32_t murmur_finish(uint32_t h, int n_words) {
  h ^= static_cast<uint32_t>(n_words) * 4u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

}  // namespace repro

// Every kernel library (one per .cu file) exports the runtime's text for an
// error code, so the Python wrapper can raise with it.  Expand once per .cu.
#define REPRO_DEFINE_ERROR_STRING()                          \
  extern "C" const char* repro_error_string(int err) {       \
    return cudaGetErrorString(static_cast<cudaError_t>(err)); \
  }
