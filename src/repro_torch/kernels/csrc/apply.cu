// Shard-apply: one pass over each query's probe window yields the read
// result (first live key-equal bucket, checksum-validated) and the write-slot
// decision of the paper's §3.1 policy.
//
// Replaces: repro/kernels/apply_kernel.py shard_apply_pallas (_apply_kernel),
// which the JAX engine computes in jnp (op_engine._probe_window,
// _choose_write_slot) under a vmap over the virtual shards.
//
// Bound on the H100: bytes.  A query reads its key, the meta word of each of
// its n_probe candidates, the key words of the occupied ones, and the value
// and checksum of the one it selects; it writes its value row and four
// result words.  The checksum of the selected bucket (KW + VW murmur words)
// is the only arithmetic.  Candidate rows are scattered over a multi-GB slab,
// so each costs at least a 32-byte sector, and a query's loads depend on each
// other (base -> meta -> keys -> value): what holds the kernel back is how
// many of those dependent latencies a query pays in series and how many
// queries keep loads in flight at once.
//
// Design: a group of kGroup lanes works on one query, kQueries queries a
// block, every virtual shard in one launch (the slab flattened to (S*B, .),
// absolute window bases).  The TPU kernel walks (query, candidate) pairs as
// grid steps with first-match state in its resident output block, and the
// one-thread-per-query loop that first replaced it paid a DRAM latency per
// candidate and per key word; here a query pays four, each a batch of loads
// in flight together:
//   1. the block's query keys, contiguous, into shared memory (cp.async,
//      16 bytes where aligned) while each group loads its window base;
//   2. each lane loads the meta words of candidates lane, lane + kGroup, ...
//      at once; warp ballots turn them into the group's occupied and INVALID
//      bit masks (one bit per candidate);
//   3. the lanes split the window's key rows into 16-byte chunks (4-byte
//      where KW % 4 != 0 or the slab is not 16-byte aligned) and load every
//      chunk of an occupied candidate before comparing any; a shuffle-OR
//      merges the lanes' not-equal bits.  The decision is bit arithmetic on
//      the masks: rsel = first occupied, non-INVALID, key-equal; wmatch =
//      first occupied key-equal; wfree = first empty or INVALID (__ffs).  A
//      window longer than 32 candidates is decided 32 at a time;
//   4. the selected value row (8-byte copies where VW is even) and its
//      checksum word are copied into shared memory with cp.async.
// Then one thread per query (all in the block's first warp) runs the serial
// murmur chain over key || value from shared memory, writes its result int4,
// and zeroes the staged row where nothing was found or the checksum failed;
// the block writes its value rows out as one contiguous run of 16-byte
// stores.  Only the selected candidate is checksum-validated: a failed
// checksum reports found = -1 and does not fall through to a later
// candidate (the engine flags that bucket INVALID).  Indices are clamped into
// the slab candidate by candidate, so a window cut by the clamp takes the
// same path.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "murmur.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kGroup = 4;                  // lanes that work on one query
constexpr int kQueries = 32;               // queries a block
constexpr int kThreads = kGroup * kQueries;
constexpr int kSeg = 32;                   // candidates per mask word
constexpr int kBatch = kSeg / kGroup;      // key chunks a lane has in flight
constexpr uint32_t kLaneMask = (1u << kGroup) - 1u;
constexpr size_t kSmemMax = 227 * 1024;    // dynamic shared memory a block
constexpr uint32_t kOccupied = 1u;
constexpr uint32_t kInvalid = 2u;
constexpr int kInsert = 1;  // W_INSERT
constexpr int kUpdate = 2;  // W_UPDATE
constexpr int kEvict = 3;   // W_EVICT

static_assert(32 % kGroup == 0 && kSeg % kGroup == 0, "group size");

__device__ __forceinline__ int64_t clamp_row(int64_t idx, int64_t nb) {
  return idx < 0 ? 0 : (idx < nb ? idx : nb - 1);
}

__device__ __forceinline__ bool same(uint32_t a, uint32_t b) { return a == b; }
__device__ __forceinline__ bool same(uint4 a, uint4 b) {
  return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
}

// next flat chunk of this lane: kGroup chunks on
__device__ __forceinline__ void advance(int& j, int& w, int kwc) {
  w += kGroup;
  while (w >= kwc) {
    w -= kwc;
    ++j;
  }
}

__device__ __forceinline__ uint32_t chain(uint32_t h, const uint32_t* w,
                                          int n) {
#pragma unroll 8
  for (int i = 0; i < n; ++i) h = repro::murmur_step(h, w[i]);
  return h;
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// shared memory of a block: its queries' keys (kQueries, kw), the staged
// value rows (kQueries, vw), and one int4 a query (rsel, wsel, wkind,
// checksum word)
constexpr size_t smem_bytes(int kw, int vw) {
  return 4 * static_cast<size_t>(round4(kQueries * kw) +
                                 round4(kQueries * vw)) +
         16 * kQueries;
}

// KT: the key chunk (uint4 or uint32_t); VB: bytes per value copy (8 or 4)
template <typename KT, int VB>
__global__ void __launch_bounds__(kThreads) shard_apply_kernel(
    const uint32_t* __restrict__ skeys, const uint32_t* __restrict__ svals,
    const uint32_t* __restrict__ smeta, const uint32_t* __restrict__ scsum,
    int64_t nb, const uint32_t* __restrict__ qkeys,
    const int32_t* __restrict__ base, int64_t c, int kw, int vw, int n_probe,
    uint32_t* __restrict__ out_vals, int4* __restrict__ out_res) {
  constexpr int kKW = sizeof(KT) / 4;  // key words a chunk
  constexpr int kVW = VB / 4;          // value words a copy
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qk_s = smem;
  uint32_t* val_s = smem + round4(kQueries * kw);
  int4* dec_s = reinterpret_cast<int4*>(val_s + round4(kQueries * vw));

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kQueries;
  const int rows = static_cast<int>(c - q0 < kQueries ? c - q0 : kQueries);
  const int lane = threadIdx.x % kGroup;
  const int r = threadIdx.x / kGroup;  // this group's query in the block
  const bool live = r < rows;
  const unsigned gshift = (threadIdx.x & 31u) & ~(kGroup - 1u);

  // 1. the block's query keys into shared memory; this query's base
  const int64_t b0 = live ? base[q0 + r] : 0;
  repro::copy_in(qk_s, qkeys + q0 * kw, rows * kw);
  repro::cp_async_wait_all();
  __syncthreads();

  const uint32_t* qk = qk_s + r * kw;
  const int kwc = kw / kKW;  // chunks a key row
  int rsel = -1;             // first occupied, non-INVALID, key-equal
  int wmatch = -1;           // first occupied key-equal (INVALID or not)
  int wfree = -1;            // first empty or INVALID
  for (int s0 = 0; s0 < n_probe; s0 += kSeg) {
    const int nseg = n_probe - s0 < kSeg ? n_probe - s0 : kSeg;
    const int64_t w0 = b0 + s0;
    // 2. meta words: lane holds candidates lane + kGroup * u
    uint32_t m[kSeg / kGroup];
#pragma unroll
    for (int u = 0; u < kSeg / kGroup; ++u) {
      const int j = lane + kGroup * u;
      m[u] = live && j < nseg ? smeta[clamp_row(w0 + j, nb)] : 0u;
    }
    uint32_t occ = 0, inv = 0;
#pragma unroll
    for (int u = 0; u < kSeg / kGroup; ++u) {
      const uint32_t bo = __ballot_sync(~0u, m[u] & kOccupied);
      const uint32_t bi = __ballot_sync(~0u, m[u] & kInvalid);
      occ |= ((bo >> gshift) & kLaneMask) << (kGroup * u);
      inv |= ((bi >> gshift) & kLaneMask) << (kGroup * u);
    }
    // 3. key chunks of the occupied candidates, all loaded before any
    // compare; flat chunk ci = j * kwc + w, this lane's are lane + kGroup*i
    uint32_t neq = 0;
    const int nch = nseg * kwc;
    for (int c0 = lane; c0 < nch; c0 += kGroup * kBatch) {
      KT got[kBatch];
      const int j0 = c0 / kwc;
      int j = j0, w = c0 - j0 * kwc;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (c0 + kGroup * i < nch && ((occ >> j) & 1u))
          got[i] = *reinterpret_cast<const KT*>(
              skeys + clamp_row(w0 + j, nb) * kw + w * kKW);
        advance(j, w, kwc);
      }
      j = j0;
      w = c0 - j0 * kwc;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (c0 + kGroup * i < nch && ((occ >> j) & 1u) &&
            !same(got[i], *reinterpret_cast<const KT*>(qk + w * kKW)))
          neq |= 1u << j;
        advance(j, w, kwc);
      }
    }
#pragma unroll
    for (int o = 1; o < kGroup; o <<= 1) neq |= __shfl_xor_sync(~0u, neq, o);
    const uint32_t win = nseg == kSeg ? ~0u : (1u << nseg) - 1u;
    const uint32_t eq = occ & ~neq;
    const uint32_t hit = eq & ~inv;
    const uint32_t vacant = (~occ | inv) & win;
    if (rsel < 0 && hit) rsel = s0 + __ffs(static_cast<int>(hit)) - 1;
    if (wmatch < 0 && eq) wmatch = s0 + __ffs(static_cast<int>(eq)) - 1;
    if (wfree < 0 && vacant) wfree = s0 + __ffs(static_cast<int>(vacant)) - 1;
  }

  // 4. the selected value row and checksum word into shared memory
  uint32_t* vrow = val_s + r * vw;
  if (live) {
    if (rsel >= 0) {
      const int64_t idx = clamp_row(b0 + rsel, nb);
      const uint32_t* src = svals + idx * vw;
      for (int v = lane; v < vw / kVW; v += kGroup)
        repro::cp_async<VB>(vrow + v * kVW, src + v * kVW);
      if (lane == 0) repro::cp_async<4>(&dec_s[r].w, scsum + idx);
    } else {
      for (int v = lane; v < vw; v += kGroup) vrow[v] = 0u;
    }
    if (lane == 0) {
      dec_s[r].x = rsel;
      dec_s[r].y = wmatch >= 0 ? wmatch : (wfree >= 0 ? wfree : n_probe - 1);
      dec_s[r].z = wmatch >= 0 ? kUpdate : (wfree >= 0 ? kInsert : kEvict);
    }
  }
  repro::cp_async_wait_all();
  __syncthreads();

  // the checksum of each selected candidate, one thread a query
  if (threadIdx.x < rows) {
    const int t = threadIdx.x;
    const int4 d = dec_s[t];
    int found = 0;
    if (d.x >= 0) {
      uint32_t* row = val_s + t * vw;
      uint32_t h = chain(repro::kChecksumSeed, qk_s + t * kw, kw);
      h = chain(h, row, vw);
      found = repro::murmur_finish(h, kw + vw) == static_cast<uint32_t>(d.w)
                  ? 1
                  : -1;
      if (found != 1)
        for (int v = 0; v < vw; ++v) row[v] = 0u;
    }
    out_res[q0 + t] = make_int4(found, d.x < 0 ? 0 : d.x, d.y, d.z);
  }
  __syncthreads();
  repro::copy_out(out_vals + q0 * vw, val_s, rows * vw);
}

template <typename KT, int VB>
int launch(size_t smem, cudaStream_t stream, const void* skeys,
           const void* svals, const void* smeta, const void* scsum,
           long long nb, const void* qkeys, const void* base, long long c,
           int kw, int vw, int n_probe, void* out_vals, void* out_res) {
  auto kernel = shard_apply_kernel<KT, VB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks =
      static_cast<unsigned int>((c + kQueries - 1) / kQueries);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(skeys), static_cast<const uint32_t*>(svals),
      static_cast<const uint32_t*>(smeta), static_cast<const uint32_t*>(scsum),
      nb, static_cast<const uint32_t*>(qkeys),
      static_cast<const int32_t*>(base), c, kw, vw, n_probe,
      static_cast<uint32_t*>(out_vals), static_cast<int4*>(out_res));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest KW + VW whose staged rows fit a block's shared memory.
extern "C" int repro_shard_apply_max_width() {
  return static_cast<int>((kSmemMax - smem_bytes(0, 0)) / (4 * kQueries));
}

extern "C" int repro_shard_apply(const void* skeys, const void* svals,
                                 const void* smeta, const void* scsum,
                                 long long nb, const void* qkeys,
                                 const void* base, long long c, int kw, int vw,
                                 int n_probe, void* out_vals, void* out_res,
                                 void* stream) {
  const size_t smem = smem_bytes(kw, vw);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const bool key16 = kw % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(skeys) & 15u) == 0;
  const bool val8 = vw % 2 == 0 &&
                    (reinterpret_cast<uintptr_t>(svals) & 7u) == 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (key16 && val8)
    return launch<uint4, 8>(smem, s, skeys, svals, smeta, scsum, nb, qkeys,
                            base, c, kw, vw, n_probe, out_vals, out_res);
  if (key16)
    return launch<uint4, 4>(smem, s, skeys, svals, smeta, scsum, nb, qkeys,
                            base, c, kw, vw, n_probe, out_vals, out_res);
  if (val8)
    return launch<uint32_t, 8>(smem, s, skeys, svals, smeta, scsum, nb,
                               qkeys, base, c, kw, vw, n_probe, out_vals,
                               out_res);
  return launch<uint32_t, 4>(smem, s, skeys, svals, smeta, scsum, nb,
                             qkeys, base, c, kw, vw, n_probe, out_vals,
                             out_res);
}
