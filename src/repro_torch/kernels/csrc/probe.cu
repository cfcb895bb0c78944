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
// a 32-byte sector: the design reads as few of them as the answer needs.
//
// Design: one thread per query, all virtual shards in one launch (the slab is
// flattened to (S*B, .) and the window base is absolute, shard*B + base).
// The TPU kernel walks (query, candidate) pairs as sequential grid steps and
// carries first-match state in its resident output block; here the loop over
// the n_probe candidates runs inside the thread and stops at the first
// key-equal live bucket, so blocks are independent.  A candidate's key words
// are read only when its meta word says it is live, and the compare stops at
// the first unequal word.  Indices are clamped into the slab.
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kOccupied = 1u;
constexpr uint32_t kInvalid = 2u;

__device__ __forceinline__ int64_t clamp_row(int64_t idx, int64_t nb) {
  return idx < 0 ? 0 : (idx < nb ? idx : nb - 1);
}

__global__ void probe_kernel(
    const uint32_t* __restrict__ skeys, const uint32_t* __restrict__ svals,
    const uint32_t* __restrict__ smeta, const uint32_t* __restrict__ scsum,
    int64_t nb, const uint32_t* __restrict__ qkeys,
    const int32_t* __restrict__ base, int64_t c, int kw, int vw, int n_probe,
    int validate, uint32_t* __restrict__ out_vals, int2* __restrict__ out_res) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= c) return;
  const uint32_t* qk = qkeys + q * kw;
  const int64_t b0 = base[q];
  int rsel = -1;
  for (int j = 0; j < n_probe && rsel < 0; ++j) {
    const int64_t idx = clamp_row(b0 + j, nb);
    const uint32_t m = smeta[idx];
    if ((m & kOccupied) == 0 || (m & kInvalid) != 0) continue;
    const uint32_t* bk = skeys + idx * kw;
    bool eq = true;
    for (int w = 0; w < kw && eq; ++w) eq = bk[w] == qk[w];
    if (eq) rsel = j;
  }

  int found = 0;
  uint32_t* ov = out_vals + q * vw;
  if (rsel >= 0) {
    const int64_t idx = clamp_row(b0 + rsel, nb);
    const uint32_t* bv = svals + idx * vw;
    found = 1;
    if (validate) {
      uint32_t h = repro::kChecksumSeed;
      for (int w = 0; w < kw; ++w) h = repro::murmur_step(h, qk[w]);
      for (int w = 0; w < vw; ++w) h = repro::murmur_step(h, bv[w]);
      found = repro::murmur_finish(h, kw + vw) == scsum[idx] ? 1 : -1;
    }
    if (found == 1) {
      for (int w = 0; w < vw; ++w) ov[w] = bv[w];
    }
  }
  if (found != 1) {
    for (int w = 0; w < vw; ++w) ov[w] = 0u;
  }
  out_res[q] = make_int2(found, rsel < 0 ? 0 : rsel);
}

}  // namespace

extern "C" int repro_probe(const void* skeys, const void* svals,
                           const void* smeta, const void* scsum, long long nb,
                           const void* qkeys, const void* base, long long c,
                           int kw, int vw, int n_probe, int validate,
                           void* out_vals, void* out_res, void* stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((c + kThreads - 1) / kThreads);
  probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(skeys), static_cast<const uint32_t*>(svals),
      static_cast<const uint32_t*>(smeta), static_cast<const uint32_t*>(scsum),
      nb, static_cast<const uint32_t*>(qkeys), static_cast<const int32_t*>(base),
      c, kw, vw, n_probe, validate, static_cast<uint32_t*>(out_vals),
      static_cast<int2*>(out_res));
  return static_cast<int>(cudaGetLastError());
}
