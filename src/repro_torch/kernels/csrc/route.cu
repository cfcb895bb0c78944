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
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W), into a
// cold L2: route_pack 0.0145 ms at L = 22 (bound 0.0053; index_select
// 0.0179) and 0.0207 ms at L = 48 (bound 0.0114; index_select 0.0845).
//
// The TPU kernel walks one (1, L) row per sequential grid step with the
// row index scalar-prefetched.
//
// route_pack: a group of G lanes (a power of two, 4 <= G <= 32, the
// smallest that covers the row) owns kRowsPerGroup consecutive output
// rows.  Lane u of the group reads inv of row u once and the group
// shares the indices by shuffle; then each lane copies chunks of its
// rows with the widest vector the rows allow: 16 bytes when L % 4 == 0,
// 8 when L % 2 == 0, else 4 (and only where the three buffers are as
// aligned), neighbouring lanes on neighbouring chunks.  All the group's
// loads are issued before its stores, so a lane keeps kRowsPerGroup
// copies in flight.  Rows map to groups by shifts and a grid-stride loop
// over warps, with no 64-bit divide.
//
// route_unpack: one thread owns one output word: thread t writes out[t]
// and reads row t / L of the index arrays and word t % L of the source
// row, so neighbouring threads touch neighbouring words of both the
// output and each source row (coalesced 4-byte accesses).  Blocks are
// independent; a grid-stride loop covers any size.
//
// Source indices past the end are clamped to the last row (XLA's gather
// semantics) so a bad index can never read outside the buffer.
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kThreads = 256;

constexpr int kRowsPerGroup = 4;   // output rows a lane group copies

template <int VW> struct Words;     // VW uint32 words as one access
template <> struct Words<1> { using type = uint32_t; };
template <> struct Words<2> { using type = uint2; };
template <> struct Words<4> { using type = uint4; };

// nv: vectors of VW words a row; lg: log2 of the group's lanes
template <int VW>
__global__ void route_pack_kernel(const uint32_t* __restrict__ mat,
                                  const int32_t* __restrict__ inv,
                                  const uint32_t* __restrict__ fill,
                                  uint32_t* __restrict__ out, int64_t n,
                                  int64_t rows, int nv, int lg) {
  using Vec = typename Words<VW>::type;
  const Vec* matv = reinterpret_cast<const Vec*>(mat);
  const Vec* fillv = reinterpret_cast<const Vec*>(fill);
  Vec* outv = reinterpret_cast<Vec*>(out);
  const int lane = threadIdx.x & 31;
  const int gl = lane & ((1 << lg) - 1);          // lane within the group
  const int per_warp = 32 >> lg;                  // groups a warp
  const int64_t n_groups = (rows + kRowsPerGroup - 1) / kRowsPerGroup;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  // the loop bound is the warp's, so every lane reaches every shuffle
  for (int64_t wg = (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                     (threadIdx.x >> 5)) * per_warp;
       wg < n_groups; wg += warps * per_warp) {
    const int64_t r0 = (wg + (lane >> lg)) * kRowsPerGroup;
    int32_t mine = -1;
    if (gl < kRowsPerGroup && r0 + gl < rows) mine = inv[r0 + gl];
    int64_t src[kRowsPerGroup];
#pragma unroll
    for (int u = 0; u < kRowsPerGroup; ++u) {
      const int32_t s = __shfl_sync(0xffffffffu, mine, u, 1 << lg);
      src[u] = s < 0 ? -1 : (s < n ? s : n - 1);
    }
    for (int c = gl; c < nv; c += 1 << lg) {
      Vec x[kRowsPerGroup];
#pragma unroll
      for (int u = 0; u < kRowsPerGroup; ++u) {
        if (r0 + u < rows) {
          x[u] = src[u] >= 0 ? matv[src[u] * nv + c] : fillv[c];
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerGroup; ++u) {
        if (r0 + u < rows) outv[(r0 + u) * nv + c] = x[u];
      }
    }
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

template <int VW>
int launch_pack(const void* mat, const void* inv, const void* fill, void* out,
                long long n, long long rows, int L, cudaStream_t stream) {
  const int nv = L / VW;
  int lg = 2;                                     // at least kRowsPerGroup
  while ((1 << lg) < nv && lg < 5) ++lg;
  const int64_t groups = (rows + kRowsPerGroup - 1) / kRowsPerGroup;
  route_pack_kernel<VW><<<grid_for(groups << lg), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(mat), static_cast<const int32_t*>(inv),
      static_cast<const uint32_t*>(fill), static_cast<uint32_t*>(out), n, rows,
      nv, lg);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" int repro_route_pack(const void* mat, const void* inv,
                                const void* fill, void* out, long long n,
                                long long rows, int L, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto fits = [&](int vw) {
    return L % vw == 0 && aligned(mat, 4 * vw) && aligned(fill, 4 * vw) &&
           aligned(out, 4 * vw);
  };
  if (fits(4)) return launch_pack<4>(mat, inv, fill, out, n, rows, L, s);
  if (fits(2)) return launch_pack<2>(mat, inv, fill, out, n, rows, L, s);
  return launch_pack<1>(mat, inv, fill, out, n, rows, L, s);
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
