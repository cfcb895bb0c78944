// Routing pack/unpack: move the fused (n, L) uint32 lane matrix between
// item order and bin order.
//
// Replaces: repro/kernels/route_kernel.py route_pack_pallas (_pack_kernel)
// and route_unpack_pallas (_unpack_kernel).
//
// Bound on the H100: bytes.  Each output word is one input word (or a fill
// word) plus a 4-byte index per row; there is no arithmetic to speak of.
// At the main path's shapes (131072 send rows of L = 22 or 48, 65536 reply
// rows of L = 28) the kernels move 15-38 MB, a few microseconds at HBM rate.
//
// Design: the TPU kernel walks one (1, L) row per sequential grid step with
// the row index scalar-prefetched.  Here one thread owns one output word:
// thread t writes out[t] and reads row t / L of the index array and word
// t % L of the source row, so neighbouring threads touch neighbouring words
// of both the output and each source row (coalesced 4-byte accesses; L is
// 22, 28 or 48, not a multiple of 4, so wider loads would need a ragged
// tail).  Blocks are independent; a grid-stride loop covers any size.
// Source indices past the end are clamped to the last row (XLA's gather
// semantics) so a bad index can never read outside the buffer.
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kThreads = 256;

__global__ void route_pack_kernel(const uint32_t* __restrict__ mat,
                                  const int32_t* __restrict__ inv,
                                  const uint32_t* __restrict__ fill,
                                  uint32_t* __restrict__ out, int64_t n,
                                  int64_t rows, int L) {
  const int64_t total = rows * L;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / L;
    const int w = static_cast<int>(i - r * L);
    const int64_t src = inv[r];
    out[i] = src >= 0 ? mat[(src < n ? src : n - 1) * L + w] : fill[w];
  }
}

__global__ void route_unpack_kernel(const uint32_t* __restrict__ buf,
                                    const int32_t* __restrict__ slot,
                                    const int32_t* __restrict__ kept,
                                    const uint32_t* __restrict__ fill,
                                    uint32_t* __restrict__ out, int64_t n,
                                    int64_t rows, int L) {
  const int64_t total = n * L;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / L;
    const int w = static_cast<int>(i - r * L);
    int64_t s = slot[r];
    s = s < 0 ? 0 : (s < rows ? s : rows - 1);
    out[i] = kept[r] != 0 ? buf[s * L + w] : fill[w];
  }
}

unsigned int grid_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t cap = int64_t{1} << 20;
  return static_cast<unsigned int>(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" int repro_route_pack(const void* mat, const void* inv,
                                const void* fill, void* out, long long n,
                                long long rows, int L, void* stream) {
  route_pack_kernel<<<grid_for(rows * L), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mat), static_cast<const int32_t*>(inv),
      static_cast<const uint32_t*>(fill), static_cast<uint32_t*>(out), n, rows,
      L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_route_unpack(const void* buf, const void* slot,
                                  const void* kept, const void* fill, void* out,
                                  long long n, long long rows, int L,
                                  void* stream) {
  route_unpack_kernel<<<grid_for(n * L), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(buf), static_cast<const int32_t*>(slot),
      static_cast<const int32_t*>(kept), static_cast<const uint32_t*>(fill),
      static_cast<uint32_t*>(out), n, rows, L);
  return static_cast<int>(cudaGetLastError());
}
