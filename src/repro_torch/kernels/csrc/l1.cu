// L1 probe: for each query, the first way of its L1 set that is coherent and
// key-equal; the locality tier's front end (core/l1cache.py l1_probe).
//
// Replaces: repro/kernels/l1_kernel.py l1_probe_pallas (_l1_kernel).  The
// coherence decision (live, epoch, watermark) is computed once per batch over
// the whole cache outside the kernel (l1cache.serve_flags) and comes in as
// one uint8 flag per line.
//
// Bound on the H100: bytes.  The cache itself is small (1024 sets x 4 ways x
// 188 B, about 0.8 MB at the main path's size) and stays in the 50 MB L2, so
// the device-memory traffic is each query's key and set index in and its
// value row and hit flag out: about 12.6 MB at 2^16 queries.  That is the
// shape of a row gather (route.cu): what the kernel must get right is
// coalesced query-key loads and value-row stores, and few dependent round
// trips to the L2 a query.
//
// The TPU kernel walks (query, way) pairs as sequential grid steps,
// carrying first-match state in its resident output block.  Design here:
// a group of kGroup lanes works on one query, kQueries queries a block.
//   1. the block's query keys, one contiguous run, go into shared memory by
//      cp.async (16 bytes where aligned, async_copy.cuh) while each group
//      loads its set index, clamped into the cache;
//   2. lane w of a group loads the flag and the first key chunk (16 bytes
//      where KW % 4 == 0 and the lines are 16-byte aligned, else 4) of ways
//      w, w + kGroup, ... of its set, both at once (the L2 holds the cache,
//      so a line's head costs no device-memory bytes whether or not it is
//      coherent), and a line's further chunks, kBatch at a time, only while
//      they are equal; a warp ballot gives the group's coherent key-equal
//      ways and __ffs the first of them.  More ways than kSeg are decided
//      kSeg at a time, and a warp stops after the segment in which each of
//      its queries hit;
//   3. the groups publish their lines in shared memory, and the block
//      writes its (rows, VW) output tile, one contiguous run, with the
//      widest vector the rows and buffers allow (16 bytes where VW % 4 ==
//      0, 8 where VW % 2 == 0, else 4), neighbouring threads on
//      neighbouring vectors, each thread's loads of the hit lines (zeros
//      for misses) issued before its stores; the first warp writes the
//      tile's hit bytes.
// Query keys too wide for a block's shared memory (KW above ~1,800 words)
// are read in place with 4-byte accesses.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "murmur.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kGroup = 4;                  // lanes that work on one query
constexpr int kQueries = 32;               // queries a block
constexpr int kThreads = kGroup * kQueries;
constexpr int kSeg = 32;                   // ways per mask word
constexpr int kBatch = 4;                  // further key chunks in flight
constexpr int kCopy = 4;                   // value vectors in flight
constexpr uint32_t kLaneMask = (1u << kGroup) - 1u;
constexpr size_t kSmemMax = 227 * 1024;    // dynamic shared memory a block

static_assert(32 % kGroup == 0 && kSeg % kGroup == 0, "group size");

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// shared memory of a block: its queries' lines, and, staged, their keys
constexpr size_t smem_bytes(int kw, bool staged) {
  return 8 * kQueries +
         (staged ? 4 * static_cast<size_t>(round4(kQueries * kw)) : 0);
}

__device__ __forceinline__ bool same(uint32_t a, uint32_t b) { return a == b; }
__device__ __forceinline__ bool same(uint4 a, uint4 b) {
  return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
}

// whether chunks 1 .. kwc - 1 of a line's key lk equal the query key qk's;
// loaded kBatch at a time, and only while equal
template <typename KT>
__device__ __forceinline__ bool rest_equal(const KT* __restrict__ lk,
                                           const KT* qk, int kwc) {
  for (int c0 = 1; c0 < kwc; c0 += kBatch) {
    KT got[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (c0 + i < kwc) got[i] = lk[c0 + i];
    bool eq = true;
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (c0 + i < kwc && !same(got[i], qk[c0 + i])) eq = false;
    if (!eq) return false;
  }
  return true;
}

// KT: the key chunk (uint4 or uint32_t); VT: the value vector (uint4,
// uint2 or uint32_t); kStaged: the query keys pass through shared memory
template <typename KT, typename VT, bool kStaged>
__global__ void __launch_bounds__(kThreads) l1_probe_kernel(
    const uint32_t* __restrict__ lkeys, const uint32_t* __restrict__ lvals,
    const uint8_t* __restrict__ flags, int sets, int ways,
    const uint32_t* __restrict__ qkeys, const int32_t* __restrict__ set_idx,
    int64_t n, int kw, int vw, uint8_t* __restrict__ out_hit,
    uint32_t* __restrict__ out_vals) {
  constexpr int kKW = sizeof(KT) / 4;      // key words a chunk
  constexpr int kVW = sizeof(VT) / 4;      // value words a vector
  extern __shared__ __align__(16) uint32_t smem[];
  int64_t* line_s = reinterpret_cast<int64_t*>(smem);
  uint32_t* qk_s = smem + 2 * kQueries;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kQueries;
  const int rows = static_cast<int>(n - q0 < kQueries ? n - q0 : kQueries);
  const int lane = threadIdx.x % kGroup;
  const int r = threadIdx.x / kGroup;      // this group's query in the block
  const bool live = r < rows;
  const unsigned gshift = (threadIdx.x & 31u) & ~(kGroup - 1u);

  // 1. the block's query keys into shared memory; this query's set
  int s = live ? set_idx[q0 + r] : 0;
  s = s < 0 ? 0 : (s < sets ? s : sets - 1);
  if constexpr (kStaged) {
    repro::copy_in(qk_s, qkeys + q0 * kw, rows * kw);
    repro::cp_async_wait_all();
    __syncthreads();
  }
  const KT* qk = reinterpret_cast<const KT*>(
      (kStaged ? qk_s : qkeys + q0 * kw) + (live ? r : 0) * kw);
  const int kwc = kw / kKW;                // chunks a key
  const int64_t set0 = static_cast<int64_t>(s) * ways;

  // 2. the first coherent key-equal way, kSeg ways at a time
  int first = -1;
  for (int s0 = 0; s0 < ways; s0 += kSeg) {
    const bool want = live && first < 0;
    if (!__any_sync(~0u, want)) break;     // every query of the warp hit
    const int nseg = ways - s0 < kSeg ? ways - s0 : kSeg;
    const int nu = (nseg + kGroup - 1) / kGroup;   // the same warp-wide
    uint32_t ok = 0;
    for (int u = 0; u < nu; ++u) {
      const int j = lane + kGroup * u;
      const int64_t l = set0 + s0 + j;
      const KT* lk = reinterpret_cast<const KT*>(lkeys + l * kw);
      bool eq = false;
      if (want && j < nseg) {
        const uint8_t flag = flags[l];
        const KT head = kwc > 0 ? lk[0] : KT{};
        eq = flag != 0 &&
             (kwc == 0 || (same(head, qk[0]) && rest_equal(lk, qk, kwc)));
      }
      const uint32_t b = __ballot_sync(~0u, eq);
      ok |= ((b >> gshift) & kLaneMask) << (kGroup * u);
    }
    if (ok) first = s0 + __ffs(static_cast<int>(ok)) - 1;
  }

  // 3. the tile's hit bytes and value rows
  if (live && lane == 0) line_s[r] = first >= 0 ? set0 + first : -1;
  __syncthreads();
  if (threadIdx.x < rows)
    out_hit[q0 + threadIdx.x] = line_s[threadIdx.x] >= 0 ? 1 : 0;
  const int nv = vw / kVW;                 // vectors a row
  const int total = rows * nv;
  const VT* lv = reinterpret_cast<const VT*>(lvals);
  VT* ov = reinterpret_cast<VT*>(out_vals + q0 * vw);
  for (int c0 = threadIdx.x; c0 < total; c0 += kThreads * kCopy) {
    VT x[kCopy];
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      const int c = c0 + u * kThreads;
      if (c < total) {
        const int row = c / nv;
        const int64_t line = line_s[row];
        x[u] = line >= 0 ? lv[line * nv + (c - row * nv)] : VT{};
      }
    }
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      const int c = c0 + u * kThreads;
      if (c < total) ov[c] = x[u];
    }
  }
}

template <typename KT, typename VT, bool kStaged>
int launch(const void* lkeys, const void* lvals, const void* flags, int sets,
           int ways, const void* qkeys, const void* set_idx, long long n,
           int kw, int vw, void* out_hit, void* out_vals,
           cudaStream_t stream) {
  auto kernel = l1_probe_kernel<KT, VT, kStaged>;
  const size_t smem = smem_bytes(kw, kStaged);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks =
      static_cast<unsigned int>((n + kQueries - 1) / kQueries);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(lkeys), static_cast<const uint32_t*>(lvals),
      static_cast<const uint8_t*>(flags), sets, ways,
      static_cast<const uint32_t*>(qkeys),
      static_cast<const int32_t*>(set_idx), n, kw, vw,
      static_cast<uint8_t*>(out_hit), static_cast<uint32_t*>(out_vals));
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the widest value vector that VW and the two value buffers allow
template <typename KT, bool kStaged>
int launch_widest(const void* lkeys, const void* lvals, const void* flags,
                  int sets, int ways, const void* qkeys, const void* set_idx,
                  long long n, int kw, int vw, void* out_hit, void* out_vals,
                  cudaStream_t stream) {
  const auto fits = [&](int words) {
    return vw % words == 0 && aligned(lvals, 4 * words) &&
           aligned(out_vals, 4 * words);
  };
  if (fits(4))
    return launch<KT, uint4, kStaged>(lkeys, lvals, flags, sets, ways, qkeys,
                                      set_idx, n, kw, vw, out_hit, out_vals,
                                      stream);
  if (fits(2))
    return launch<KT, uint2, kStaged>(lkeys, lvals, flags, sets, ways, qkeys,
                                      set_idx, n, kw, vw, out_hit, out_vals,
                                      stream);
  return launch<KT, uint32_t, kStaged>(lkeys, lvals, flags, sets, ways, qkeys,
                                       set_idx, n, kw, vw, out_hit, out_vals,
                                       stream);
}

}  // namespace

extern "C" int repro_l1_probe(const void* lkeys, const void* lvals,
                              const void* flags, int sets, int ways,
                              const void* qkeys, const void* set_idx,
                              long long n, int kw, int vw, void* out_hit,
                              void* out_vals, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (smem_bytes(kw, true) > kSmemMax)     // keys read in place, 4 bytes
    return launch_widest<uint32_t, false>(lkeys, lvals, flags, sets, ways,
                                          qkeys, set_idx, n, kw, vw, out_hit,
                                          out_vals, s);
  if (kw % 4 == 0 && aligned(lkeys, 16))
    return launch_widest<uint4, true>(lkeys, lvals, flags, sets, ways, qkeys,
                                      set_idx, n, kw, vw, out_hit, out_vals, s);
  return launch_widest<uint32_t, true>(lkeys, lvals, flags, sets, ways, qkeys,
                                       set_idx, n, kw, vw, out_hit, out_vals,
                                       s);
}
