// Bucket checksum over key || value: (N, KW) x (N, VW) uint32 -> (N,)
// uint32, one murmur3 chain seeded 0xB5297A4D over the KW key words and
// then the VW value words, finished with the byte length 4 * (KW + VW).
//
// Replaces: repro/kernels/checksum_kernel.py checksum_pallas
// (_checksum_kernel).
//
// Bound on the H100: bytes.  Each row is read once (184 B at KW + VW =
// 46) and 4 B are written; the chain costs ~11 integer operations per
// word, ~500 per row, far below the ALUs' rate for the bytes moved.  At
// the main path's 65536-row write pass that is 12.3 MB, 3.7 us at HBM
// rate.
//
// Design: as csrc/hash.cu.  One thread per row, 128 rows per block.  The
// block copies its key tile and then its value tile into one shared
// (128, KW + VW) tile, consecutive threads on consecutive words
// (coalesced), with the row stride rounded up to odd so the 32 rows a
// warp reads in one step fall in 32 banks; then each thread runs the
// chain over its row.  The key and value views may have any row stride
// (the write pass hands over slices), so nothing is concatenated or
// copied before the launch.
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kThreads = 128;

__global__ void checksum_kernel(const uint32_t* __restrict__ keys,
                                int64_t ld_keys,
                                const uint32_t* __restrict__ vals,
                                int64_t ld_vals, uint32_t* __restrict__ out,
                                int64_t n, int kw, int vw) {
  extern __shared__ uint32_t tile[];
  const int width = kw + vw;
  const int stride = width | 1;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t left = n - row0;
  const int rows = left < kThreads ? static_cast<int>(left) : kThreads;
  for (int i = threadIdx.x; i < rows * kw; i += kThreads) {
    const int r = i / kw;
    const int c = i - r * kw;
    tile[r * stride + c] = keys[(row0 + r) * ld_keys + c];
  }
  for (int i = threadIdx.x; i < rows * vw; i += kThreads) {
    const int r = i / vw;
    const int c = i - r * vw;
    tile[r * stride + kw + c] = vals[(row0 + r) * ld_vals + c];
  }
  __syncthreads();
  if (threadIdx.x >= rows) return;
  const uint32_t* w = tile + threadIdx.x * stride;
  uint32_t h = repro::kChecksumSeed;
  for (int i = 0; i < width; ++i) h = repro::murmur_step(h, w[i]);
  out[row0 + threadIdx.x] = repro::murmur_finish(h, width);
}

}  // namespace

// Largest KW + VW whose 128-row tile fits the default 48 KB of shared
// memory.
extern "C" int repro_checksum_max_width() {
  return 48 * 1024 / 4 / kThreads - 1;
}

extern "C" int repro_checksum(const void* keys, long long ld_keys,
                              const void* vals, long long ld_vals, void* out,
                              long long n, int kw, int vw, void* stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(kThreads) * ((kw + vw) | 1) * 4;
  checksum_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), ld_keys,
      static_cast<const uint32_t*>(vals), ld_vals,
      static_cast<uint32_t*>(out), n, kw, vw);
  return static_cast<int>(cudaGetLastError());
}
