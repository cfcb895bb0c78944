// Read probe: the first occupied, non-INVALID, key-equal bucket of each
// query's window, optionally checksum-validated.  The engine's read pass in
// every read, mixed and migrate round.
//
// Replaces: repro/kernels/probe_kernel.py probe_pallas (_probe_kernel), with
// the engine's semantics (repro/core/op_engine.py _probe_window and
// _validate_and_flag, repro/kernels/ref.py ref_probe): only the selected
// candidate is checksum-validated.  A failed checksum reports found = -1 and
// does not fall through to a later key-equal candidate, as the Pallas kernel
// does; the engine flags that bucket INVALID.  Without validation (the fine
// and coarse locking modes) found is 1 or 0.
//
// Bound on the H100: bytes.  A query reads its key and base, the meta word
// of each candidate up to the selected one, the key words of the occupied,
// non-INVALID ones among them, and the value and checksum of the one it
// selects; it writes its value row and two result words.  The checksum of
// the selected bucket (KW + VW murmur words) is the only arithmetic.
// Candidates are scattered over a multi-GB slab, so each one costs at least
// a 32-byte sector, and a query's loads depend on each other (base -> meta
// -> keys -> value): what holds the kernel back is how many of those
// dependent latencies a query pays in series and how many queries keep
// loads in flight at once.
//
// Design (the shard-apply kernel's, apply.cu): a group of kGroup lanes
// works on one query, kQueries queries a block, every virtual shard in one
// launch (the slab flattened to (S*B, .), absolute window bases).  The TPU
// kernel walks (query, candidate) pairs as grid steps with first-match state
// in its resident output block; a query here pays four latencies, each a
// batch of loads in flight together:
//   1. the block's query keys, contiguous, into shared memory (cp.async,
//      16 bytes where aligned) while each group loads its window base;
//   2. each lane loads the meta words of candidates lane, lane + kGroup, ...
//      at once; warp ballots turn them into occupied and INVALID bit masks,
//      and live = occupied & ~INVALID;
//   3. the lanes load every 16-byte key chunk of the live candidates (4-byte
//      where KW % 4 != 0 or the slab is not 16-byte aligned) before
//      comparing any; a shuffle-OR merges the lanes' not-equal bits and
//      rsel = __ffs(live & equal) - 1.  A window longer than 32 candidates
//      is decided one 32-candidate segment at a time, and a warp stops after
//      the segment in which each of its queries found a hit: the early exit;
//   4. the selected value row (8-byte copies where VW is even and the slab
//      8-byte aligned) and its checksum word are copied into shared memory
//      with cp.async.
// Steps 2 and 3 repeat apply.cu's (meta_masks, key_neq below): in one shared
// header they cost the shard-apply kernel's 4-byte variants two registers
// and 0.5% of their time, so each kernel keeps its own copy.  Then one
// thread per query (all in the block's first warp) runs the murmur chain
// over key || value from shared memory where validation is asked for,
// writes its (found, rsel) pair and zeroes the staged row where found != 1;
// the block writes its value rows out as one contiguous run of 16-byte
// stores.  Rows too wide for a block's shared memory (KW + VW above ~1,800
// words) take an unstaged variant: query keys read in place, value rows
// copied straight into the output with 4-byte accesses.  Indices are
// clamped into the slab candidate by candidate, so a window cut by the
// clamp takes the same path.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "murmur.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kGroup = 4;                  // lanes that work on one query
constexpr int kSeg = 32;                   // candidates per mask word
constexpr int kBatch = kSeg / kGroup;      // key chunks a lane has in flight
constexpr uint32_t kLaneMask = (1u << kGroup) - 1u;
constexpr uint32_t kOccupied = 1u;
constexpr uint32_t kInvalid = 2u;

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

// the murmur chain over n words
__device__ __forceinline__ uint32_t chain(uint32_t h, const uint32_t* w,
                                          int n) {
#pragma unroll 8
  for (int i = 0; i < n; ++i) h = repro::murmur_step(h, w[i]);
  return h;
}

// The occupied and INVALID masks of the nseg candidates from w0 (bit j:
// candidate w0 + j), for the group whose lanes sit at bit gshift of the
// warp; a group with want == false loads nothing and gets empty masks.
// Every lane of the warp must call it.
__device__ __forceinline__ void meta_masks(const uint32_t* __restrict__ smeta,
                                           int64_t nb, int64_t w0, int nseg,
                                           bool want, int lane,
                                           unsigned gshift, uint32_t& occ,
                                           uint32_t& inv) {
  uint32_t m[kSeg / kGroup];
#pragma unroll
  for (int u = 0; u < kSeg / kGroup; ++u) {
    const int j = lane + kGroup * u;
    m[u] = want && j < nseg ? smeta[clamp_row(w0 + j, nb)] : 0u;
  }
  occ = 0;
  inv = 0;
#pragma unroll
  for (int u = 0; u < kSeg / kGroup; ++u) {
    const uint32_t bo = __ballot_sync(~0u, m[u] & kOccupied);
    const uint32_t bi = __ballot_sync(~0u, m[u] & kInvalid);
    occ |= ((bo >> gshift) & kLaneMask) << (kGroup * u);
    inv |= ((bi >> gshift) & kLaneMask) << (kGroup * u);
  }
}

// The not-equal mask of the key rows of the candidates in `need` (bits of
// the segment from w0) against the query key qk, merged over the group.
// KT is the key chunk (uint4 where kw % 4 == 0 and skeys and qk are
// 16-byte aligned, else uint32_t).  Flat chunk ci = j * kwc + w; this
// lane's are lane + kGroup * i, all loaded before any is compared.  Every
// lane of the warp must call it.
template <typename KT>
__device__ __forceinline__ uint32_t key_neq(const uint32_t* __restrict__ skeys,
                                            int64_t nb, int kw, int64_t w0,
                                            int nseg, uint32_t need,
                                            const uint32_t* qk, int lane) {
  constexpr int kKW = sizeof(KT) / 4;  // key words a chunk
  const int kwc = kw / kKW;            // chunks a key row
  uint32_t neq = 0;
  const int nch = nseg * kwc;
  for (int c0 = lane; c0 < nch; c0 += kGroup * kBatch) {
    KT got[kBatch];
    const int j0 = c0 / kwc;
    int j = j0, w = c0 - j0 * kwc;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + kGroup * i < nch && ((need >> j) & 1u))
        got[i] = *reinterpret_cast<const KT*>(
            skeys + clamp_row(w0 + j, nb) * kw + w * kKW);
      advance(j, w, kwc);
    }
    j = j0;
    w = c0 - j0 * kwc;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + kGroup * i < nch && ((need >> j) & 1u) &&
          !same(got[i], *reinterpret_cast<const KT*>(qk + w * kKW)))
        neq |= 1u << j;
      advance(j, w, kwc);
    }
  }
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1) neq |= __shfl_xor_sync(~0u, neq, o);
  return neq;
}

constexpr int kQueries = 32;               // queries a block
constexpr int kThreads = kGroup * kQueries;
constexpr size_t kSmemMax = 227 * 1024;    // dynamic shared memory a block

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// shared memory of a block: staged, its queries' keys (kQueries, kw) and
// value rows (kQueries, vw); always one int2 a query (rsel, checksum word)
constexpr size_t smem_bytes(int kw, int vw, bool staged) {
  return (staged ? 4 * static_cast<size_t>(round4(kQueries * kw) +
                                           round4(kQueries * vw))
                 : 0) +
         8 * kQueries;
}

// BYTES from device memory to dst: by cp.async into shared memory where
// staged (completes at cp_async_wait_all), else by a load and a store
template <int BYTES, bool kStaged>
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src) {
  if constexpr (kStaged) {
    repro::cp_async<BYTES>(dst, src);
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else {
    *dst = *src;
  }
}

// KT: the key chunk (uint4 or uint32_t); VB: bytes per value copy (8 or 4);
// kStaged: keys and value rows pass through shared memory
template <typename KT, int VB, bool kStaged>
__global__ void __launch_bounds__(kThreads) probe_kernel(
    const uint32_t* __restrict__ skeys, const uint32_t* __restrict__ svals,
    const uint32_t* __restrict__ smeta, const uint32_t* __restrict__ scsum,
    int64_t nb, const uint32_t* __restrict__ qkeys,
    const int32_t* __restrict__ base, int64_t c, int kw, int vw, int n_probe,
    int validate, uint32_t* __restrict__ out_vals, int2* __restrict__ out_res) {
  constexpr int kVW = VB / 4;          // value words a copy
  extern __shared__ __align__(16) uint32_t smem[];
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kQueries;
  // row r of the block's keys and value rows: in shared memory where
  // staged, else the inputs and outputs themselves
  uint32_t* qk_s = smem;
  uint32_t* val_s = smem + (kStaged ? round4(kQueries * kw) : 0);
  int2* dec_s = reinterpret_cast<int2*>(
      val_s + (kStaged ? round4(kQueries * vw) : 0));
  const uint32_t* qk_b = kStaged ? qk_s : qkeys + q0 * kw;
  uint32_t* val_b = kStaged ? val_s : out_vals + q0 * vw;

  const int rows = static_cast<int>(c - q0 < kQueries ? c - q0 : kQueries);
  const int lane = threadIdx.x % kGroup;
  const int r = threadIdx.x / kGroup;  // this group's query in the block
  const bool live = r < rows;
  const unsigned gshift = (threadIdx.x & 31u) & ~(kGroup - 1u);

  // 1. the block's query keys into shared memory; this query's base
  const int64_t b0 = live ? base[q0 + r] : 0;
  if constexpr (kStaged) {
    repro::copy_in(qk_s, qkeys + q0 * kw, rows * kw);
    repro::cp_async_wait_all();
    __syncthreads();
  }

  const uint32_t* qk = qk_b + (live ? r : 0) * kw;
  int rsel = -1;  // first occupied, non-INVALID, key-equal
  for (int s0 = 0; s0 < n_probe; s0 += kSeg) {
    const bool want = live && rsel < 0;
    if (!__any_sync(~0u, want)) break;  // every query of the warp decided
    const int nseg = n_probe - s0 < kSeg ? n_probe - s0 : kSeg;
    const int64_t w0 = b0 + s0;
    // 2. meta words of candidates lane + kGroup * u -> bit masks
    uint32_t occ, inv;
    meta_masks(smeta, nb, w0, nseg, want, lane, gshift, occ, inv);
    const uint32_t lv = occ & ~inv;
    // 3. key chunks of the live candidates, all loaded before any compare
    const uint32_t hit =
        lv & ~key_neq<KT>(skeys, nb, kw, w0, nseg, lv, qk, lane);
    if (hit) rsel = s0 + __ffs(static_cast<int>(hit)) - 1;
  }

  // 4. the selected value row and checksum word into shared memory
  uint32_t* vrow = val_b + r * vw;
  if (live) {
    if (rsel >= 0) {
      const int64_t idx = clamp_row(b0 + rsel, nb);
      const uint32_t* src = svals + idx * vw;
      for (int v = lane; v < vw / kVW; v += kGroup)
        stage<VB, kStaged>(vrow + v * kVW, src + v * kVW);
      if (lane == 0)
        stage<4, kStaged>(reinterpret_cast<uint32_t*>(&dec_s[r].y),
                          scsum + idx);
    } else {
      for (int v = lane; v < vw; v += kGroup) vrow[v] = 0u;
    }
    if (lane == 0) dec_s[r].x = rsel;
  }
  if constexpr (kStaged) repro::cp_async_wait_all();
  __syncthreads();

  // the checksum of each selected candidate, one thread a query
  if (threadIdx.x < rows) {
    const int t = threadIdx.x;
    const int2 d = dec_s[t];
    int found = d.x >= 0 ? 1 : 0;
    if (found && validate) {
      uint32_t* row = val_b + t * vw;
      uint32_t h = chain(repro::kChecksumSeed, qk_b + t * kw, kw);
      h = chain(h, row, vw);
      if (repro::murmur_finish(h, kw + vw) != static_cast<uint32_t>(d.y)) {
        found = -1;
        for (int v = 0; v < vw; ++v) row[v] = 0u;
      }
    }
    out_res[q0 + t] = make_int2(found, d.x < 0 ? 0 : d.x);
  }
  if constexpr (kStaged) {
    __syncthreads();
    repro::copy_out(out_vals + q0 * vw, val_s, rows * vw);
  }
}

template <typename KT, int VB, bool kStaged>
int launch(size_t smem, cudaStream_t stream, const void* skeys,
           const void* svals, const void* smeta, const void* scsum,
           long long nb, const void* qkeys, const void* base, long long c,
           int kw, int vw, int n_probe, int validate, void* out_vals,
           void* out_res) {
  auto kernel = probe_kernel<KT, VB, kStaged>;
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
      static_cast<const int32_t*>(base), c, kw, vw, n_probe, validate,
      static_cast<uint32_t*>(out_vals), static_cast<int2*>(out_res));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_probe(const void* skeys, const void* svals,
                           const void* smeta, const void* scsum, long long nb,
                           const void* qkeys, const void* base, long long c,
                           int kw, int vw, int n_probe, int validate,
                           void* out_vals, void* out_res, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (smem_bytes(kw, vw, true) > kSmemMax)   // unstaged, 4-byte accesses
    return launch<uint32_t, 4, false>(smem_bytes(kw, vw, false), s, skeys,
                                      svals, smeta, scsum, nb, qkeys, base, c,
                                      kw, vw, n_probe, validate, out_vals,
                                      out_res);
  const size_t smem = smem_bytes(kw, vw, true);
  const bool key16 = kw % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(skeys) & 15u) == 0;
  const bool val8 = vw % 2 == 0 &&
                    (reinterpret_cast<uintptr_t>(svals) & 7u) == 0;
  if (key16 && val8)
    return launch<uint4, 8, true>(smem, s, skeys, svals, smeta, scsum, nb,
                                  qkeys, base, c, kw, vw, n_probe, validate,
                                  out_vals, out_res);
  if (key16)
    return launch<uint4, 4, true>(smem, s, skeys, svals, smeta, scsum, nb,
                                  qkeys, base, c, kw, vw, n_probe, validate,
                                  out_vals, out_res);
  if (val8)
    return launch<uint32_t, 8, true>(smem, s, skeys, svals, smeta, scsum, nb,
                                     qkeys, base, c, kw, vw, n_probe,
                                     validate, out_vals, out_res);
  return launch<uint32_t, 4, true>(smem, s, skeys, svals, smeta, scsum, nb,
                                   qkeys, base, c, kw, vw, n_probe, validate,
                                   out_vals, out_res);
}
