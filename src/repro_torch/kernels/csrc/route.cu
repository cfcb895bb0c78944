// Routing pack/unpack: move the fused (n, L) uint32 lane matrix between
// item order and bin order.
//
// Replaces: repro/kernels/route_kernel.py route_pack_pallas (_pack_kernel)
// and route_unpack_pallas (_unpack_kernel).
//
// Bound on the H100: bytes.  Each output word is one input word (or a fill
// word) plus a 4-byte index per row (two for unpack: slot and kept); there
// is no arithmetic to speak of.  At the main path's shapes (131072 send
// rows of L = 22 or 48, 65536 reply rows of L = 28) the kernels move
// 15-38 MB, a few microseconds at HBM rate.  Measured by chip_smoke.py on
// an NVIDIA H100 80GB HBM3 (700 W), into a cold L2: route_pack 0.0156 ms
// at L = 22 (bound 0.0053; index_select 0.0178) and 0.0206 ms at L = 48
// (bound 0.0114; index_select 0.0845); route_unpack 0.0125 ms at L = 28
// (bound 0.0045; index_select 0.0452).
//
// The TPU kernel walks one (1, L) row per sequential grid step with the
// row index scalar-prefetched.
//
// Both are one gather of whole rows, out[r] = src[index(r)] or the fill
// row where index(r) is -1, and share one kernel template over the index:
//   route_pack:   index(r) = inv[r] < 0 ? -1 : min(inv[r], n - 1);
//   route_unpack: index(r) = kept[r] == 0 ? -1 : clamp(slot[r], 0, rows - 1).
// A group of G lanes (a power of two, 4 <= G <= 32, the smallest that
// covers the row) owns kRowsPerGroup consecutive output rows.  Lane u of
// the group loads row u's index words once and the group shares the
// resolved source row by shuffle; then each lane copies chunks of its rows
// with the widest vector the rows allow: 16 bytes when L % 4 == 0, 8 when
// L % 2 == 0, else 4 (and only where the source, fill and output buffers
// are as aligned), neighbouring lanes on neighbouring chunks.  All the
// group's loads are issued before its stores, so a lane keeps
// kRowsPerGroup copies in flight.  Rows map to groups by shifts and a
// grid-stride loop over warps, with no 64-bit divide.
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

// output row -> source row of route_pack, -1 for the fill row
struct PackIndex {
  const int32_t* inv;
  int64_t n;   // source rows
  __device__ __forceinline__ int32_t operator()(int64_t r) const {
    const int32_t s = __ldg(inv + r);
    return s < 0 ? -1 : (s < n ? s : static_cast<int32_t>(n - 1));
  }
};

// output row -> source row of route_unpack, -1 for the fill row
struct UnpackIndex {
  const int32_t* slot;
  const int32_t* kept;
  int64_t rows;   // source rows
  __device__ __forceinline__ int32_t operator()(int64_t r) const {
    const int32_t k = __ldg(kept + r);
    const int32_t s = __ldg(slot + r);
    if (k == 0) return -1;
    return s < 0 ? 0 : (s < rows ? s : static_cast<int32_t>(rows - 1));
  }
};

// out (rows, nv vectors of VW words) gathered from src by index; lg: log2
// of the group's lanes
template <int VW, typename Index>
__global__ void route_rows_kernel(const uint32_t* __restrict__ src,
                                  Index index,
                                  const uint32_t* __restrict__ fill,
                                  uint32_t* __restrict__ out, int64_t rows,
                                  int nv, int lg) {
  using Vec = typename Words<VW>::type;
  const Vec* srcv = reinterpret_cast<const Vec*>(src);
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
    if (gl < kRowsPerGroup && r0 + gl < rows) mine = index(r0 + gl);
    int64_t from[kRowsPerGroup];
#pragma unroll
    for (int u = 0; u < kRowsPerGroup; ++u)
      from[u] = __shfl_sync(0xffffffffu, mine, u, 1 << lg);
    for (int c = gl; c < nv; c += 1 << lg) {
      Vec x[kRowsPerGroup];
#pragma unroll
      for (int u = 0; u < kRowsPerGroup; ++u) {
        if (r0 + u < rows) {
          x[u] = from[u] >= 0 ? srcv[from[u] * nv + c] : fillv[c];
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerGroup; ++u) {
        if (r0 + u < rows) outv[(r0 + u) * nv + c] = x[u];
      }
    }
  }
}

unsigned int grid_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t cap = int64_t{1} << 20;
  return static_cast<unsigned int>(blocks < cap ? blocks : cap);
}

template <int VW, typename Index>
int launch_rows(const void* src, Index index, const void* fill, void* out,
                long long rows, int L, cudaStream_t stream) {
  const int nv = L / VW;
  int lg = 2;                                     // at least kRowsPerGroup
  while ((1 << lg) < nv && lg < 5) ++lg;
  const int64_t groups = (rows + kRowsPerGroup - 1) / kRowsPerGroup;
  route_rows_kernel<VW, Index><<<grid_for(groups << lg), kThreads, 0,
                                 stream>>>(
      static_cast<const uint32_t*>(src), index,
      static_cast<const uint32_t*>(fill), static_cast<uint32_t*>(out), rows,
      nv, lg);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the widest vector that L and the three buffers allow
template <typename Index>
int launch_widest(const void* src, Index index, const void* fill, void* out,
                  long long rows, int L, cudaStream_t stream) {
  const auto fits = [&](int vw) {
    return L % vw == 0 && aligned(src, 4 * vw) && aligned(fill, 4 * vw) &&
           aligned(out, 4 * vw);
  };
  if (fits(4)) return launch_rows<4>(src, index, fill, out, rows, L, stream);
  if (fits(2)) return launch_rows<2>(src, index, fill, out, rows, L, stream);
  return launch_rows<1>(src, index, fill, out, rows, L, stream);
}

}  // namespace

extern "C" int repro_route_pack(const void* mat, const void* inv,
                                const void* fill, void* out, long long n,
                                long long rows, int L, void* stream) {
  return launch_widest(mat, PackIndex{static_cast<const int32_t*>(inv), n},
                       fill, out, rows, L, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_route_unpack(const void* buf, const void* slot,
                                  const void* kept, const void* fill, void* out,
                                  long long n, long long rows, int L,
                                  void* stream) {
  return launch_widest(buf,
                       UnpackIndex{static_cast<const int32_t*>(slot),
                                   static_cast<const int32_t*>(kept), rows},
                       fill, out, n, L, static_cast<cudaStream_t>(stream));
}
