// Bucket checksum over key || value: (N, KW) x (N, VW) uint32 -> (N,)
// uint32, one murmur3 chain seeded 0xB5297A4D over the KW key words and
// then the VW value words, finished with the byte length 4 * (KW + VW).
//
// Replaces: repro/kernels/checksum_kernel.py checksum_pallas
// (_checksum_kernel).
//
// Bound on the H100: bytes.  Each row is read once (184 B at KW + VW =
// 46) and 4 B are written; the chain costs ~11 integer operations per
// word, ~500 per row, below the ALUs' rate for the bytes moved.  At the
// write pass's 131,072 rows that is 24.6 MB, 7.4 us at HBM rate.  With a
// 128-row tile per block the whole call fits the card in one wave, so the
// time is that of one block: how long its tile takes to arrive, then its
// 46-step serial chain.  A staging loop that loads a word, stores it to
// shared memory and only then loads the next pays a DRAM latency per trip.
//
// Design: one thread per row, kRows rows per block.  The block's key tile and
// value tile arrive in shared memory in one step, with nothing held in
// registers:
//   - rows contiguous (ld == width, the write pass's case) and 16-byte
//     aligned: two TMA bulk copies (cp.async.bulk), issued by one thread and
//     completed on an mbarrier with the tile's byte count;
//   - any other view (a row-strided slice, a misaligned start, a ragged last
//     tile whose byte count is not a multiple of 16): every thread issues
//     4-byte cp.async copies for its words, row and column stepped without
//     a division per word, then waits once.
// The tiles keep the rows unpadded (stride KW and VW words), so a thread
// reads its key row as 16-byte vectors and its value row as 8-byte vectors
// where KW % 4 == 0 and VW % 2 == 0: at an 80-byte stride eight threads'
// 16-byte reads, and at a 104-byte stride sixteen threads' 8-byte reads,
// fall in distinct banks.  Then each thread runs the chain over its row.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "murmur.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kRows = 128;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   repro::smem_u32(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   repro::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(repro::smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from 16-byte aligned device memory to 16-byte
// aligned shared memory by the TMA unit, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(repro::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(repro::smem_u32(bar))
      : "memory");
}

// rows x width words at row stride ld -> dst (rows, width), 4-byte cp.async
// copies; thread t takes words t, t + kRows, ... in row-major order
__device__ __forceinline__ void stage_words(uint32_t* dst,
                                            const uint32_t* src, int64_t ld,
                                            int rows, int width) {
  if (width == 0) return;
  const int step_r = kRows / width, step_c = kRows % width;
  int r = threadIdx.x / width, c = threadIdx.x % width;
  for (int i = threadIdx.x; i < rows * width; i += kRows) {
    repro::cp_async<4>(dst + i, src + r * ld + c);
    r += step_r;
    c += step_c;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
}

// the chain over n words of a row; VEC: read it as n / VEC vectors
template <int VEC>
__device__ __forceinline__ uint32_t chain(uint32_t h, const uint32_t* row,
                                          int n) {
  if constexpr (VEC == 4) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
#pragma unroll 5
    for (int i = 0; i < n / 4; ++i) {
      const uint4 x = v[i];
      h = repro::murmur_step(h, x.x);
      h = repro::murmur_step(h, x.y);
      h = repro::murmur_step(h, x.z);
      h = repro::murmur_step(h, x.w);
    }
  } else if constexpr (VEC == 2) {
    const uint2* v = reinterpret_cast<const uint2*>(row);
#pragma unroll 13
    for (int i = 0; i < n / 2; ++i) {
      const uint2 x = v[i];
      h = repro::murmur_step(h, x.x);
      h = repro::murmur_step(h, x.y);
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < n; ++i) h = repro::murmur_step(h, row[i]);
  }
  return h;
}

__global__ void __launch_bounds__(kRows)
    checksum_kernel(const uint32_t* __restrict__ keys, int64_t ld_keys,
                    const uint32_t* __restrict__ vals, int64_t ld_vals,
                    uint32_t* __restrict__ out, int64_t n, int kw, int vw) {
  extern __shared__ __align__(16) uint32_t tile[];  // (kRows, kw), (kRows, vw)
  __shared__ uint64_t bar;
  uint32_t* ktile = tile;
  uint32_t* vtile = tile + kRows * kw;  // 16-byte aligned: 512 * kw bytes on
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = n - row0 < kRows ? static_cast<int>(n - row0) : kRows;
  const uint32_t* ksrc = keys + row0 * ld_keys;
  const uint32_t* vsrc = vals + row0 * ld_vals;
  const uint32_t kbytes = 4u * rows * kw, vbytes = 4u * rows * vw;
  const bool bulk = ld_keys == kw && ld_vals == vw && kbytes % 16 == 0 &&
                    vbytes % 16 == 0 && repro::aligned16(ksrc) &&
                    repro::aligned16(vsrc);
  if (bulk) {
    if (threadIdx.x == 0) mbar_init(&bar, 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar, kbytes + vbytes);
      if (kbytes) bulk_copy(ktile, ksrc, kbytes, &bar);
      if (vbytes) bulk_copy(vtile, vsrc, vbytes, &bar);
    }
    mbar_wait(&bar, 0);
  } else {
    stage_words(ktile, ksrc, ld_keys, rows, kw);
    stage_words(vtile, vsrc, ld_vals, rows, vw);
    repro::cp_async_wait_all();
    __syncthreads();
  }
  if (threadIdx.x >= rows) return;
  const uint32_t* krow = ktile + threadIdx.x * kw;
  const uint32_t* vrow = vtile + threadIdx.x * vw;
  uint32_t h = repro::kChecksumSeed;
  h = kw % 4 == 0 ? chain<4>(h, krow, kw) : chain<1>(h, krow, kw);
  h = vw % 2 == 0 ? chain<2>(h, vrow, vw) : chain<1>(h, vrow, vw);
  out[row0 + threadIdx.x] = repro::murmur_finish(h, kw + vw);
}

}  // namespace

// Largest KW + VW whose 128-row tile fits the default 48 KB of shared
// memory.
extern "C" int repro_checksum_max_width() {
  return 48 * 1024 / 4 / kRows - 1;
}

extern "C" int repro_checksum(const void* keys, long long ld_keys,
                              const void* vals, long long ld_vals, void* out,
                              long long n, int kw, int vw, void* stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((n + kRows - 1) / kRows);
  const size_t smem = static_cast<size_t>(kRows) * (kw + vw) * 4;
  checksum_kernel<<<blocks, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), ld_keys,
      static_cast<const uint32_t*>(vals), ld_vals,
      static_cast<uint32_t*>(out), n, kw, vw);
  return static_cast<int>(cudaGetLastError());
}
