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
// so each one costs at least a 32-byte sector: the design reads as few
// of them as the decision needs.
//
// Design: one thread per query, all virtual shards in one launch (the slab is
// passed flattened to (S*B, .) and the window base is absolute, shard*B +
// base).  The TPU kernel walks (query, candidate) pairs as sequential grid
// steps and carries first-match state in its resident output block; here a
// loop over the n_probe candidates inside the thread carries it in
// registers, so blocks are independent and run in any order.  The loop
// reads a candidate's key words only while the answer can still change (no
// write match yet, or no read match yet and the bucket is not INVALID), and
// stops comparing at the first unequal word.  Only the selected read
// candidate is checksum-validated: a failed checksum reports found = -1 and
// does not fall through to a later candidate (the engine flags that bucket
// INVALID).  Indices are clamped into the slab.
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kOccupied = 1u;
constexpr uint32_t kInvalid = 2u;
constexpr int kInsert = 1;  // W_INSERT
constexpr int kUpdate = 2;  // W_UPDATE
constexpr int kEvict = 3;   // W_EVICT

__global__ void shard_apply_kernel(
    const uint32_t* __restrict__ skeys, const uint32_t* __restrict__ svals,
    const uint32_t* __restrict__ smeta, const uint32_t* __restrict__ scsum,
    int64_t nb, const uint32_t* __restrict__ qkeys,
    const int32_t* __restrict__ base, int64_t c, int kw, int vw, int n_probe,
    uint32_t* __restrict__ out_vals, int4* __restrict__ out_res) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= c) return;
  const uint32_t* qk = qkeys + q * kw;
  const int64_t b0 = base[q];
  int rsel = -1;    // first occupied, non-INVALID, key-equal candidate
  int wmatch = -1;  // first occupied key-equal candidate (INVALID or not)
  int wfree = -1;   // first empty or INVALID candidate
  for (int j = 0; j < n_probe; ++j) {
    int64_t idx = b0 + j;
    idx = idx < 0 ? 0 : (idx < nb ? idx : nb - 1);
    const uint32_t m = smeta[idx];
    const bool occ = (m & kOccupied) != 0;
    const bool inv = (m & kInvalid) != 0;
    if ((!occ || inv) && wfree < 0) wfree = j;
    if (!occ || !(wmatch < 0 || (rsel < 0 && !inv))) continue;
    const uint32_t* bk = skeys + idx * kw;
    bool eq = true;
    for (int w = 0; w < kw && eq; ++w) eq = bk[w] == qk[w];
    if (!eq) continue;
    if (wmatch < 0) wmatch = j;
    if (!inv && rsel < 0) rsel = j;
  }

  int found = 0;
  uint32_t* ov = out_vals + q * vw;
  if (rsel >= 0) {
    int64_t idx = b0 + rsel;
    idx = idx < 0 ? 0 : (idx < nb ? idx : nb - 1);
    const uint32_t* bv = svals + idx * vw;
    uint32_t h = repro::kChecksumSeed;
    for (int w = 0; w < kw; ++w) h = repro::murmur_step(h, qk[w]);
    for (int w = 0; w < vw; ++w) h = repro::murmur_step(h, bv[w]);
    found = repro::murmur_finish(h, kw + vw) == scsum[idx] ? 1 : -1;
    if (found == 1) {
      for (int w = 0; w < vw; ++w) ov[w] = bv[w];
    }
  }
  if (found != 1) {
    for (int w = 0; w < vw; ++w) ov[w] = 0u;
  }
  const int wsel = wmatch >= 0 ? wmatch : (wfree >= 0 ? wfree : n_probe - 1);
  const int wkind = wmatch >= 0 ? kUpdate : (wfree >= 0 ? kInsert : kEvict);
  out_res[q] = make_int4(found, rsel < 0 ? 0 : rsel, wsel, wkind);
}

}  // namespace

extern "C" int repro_shard_apply(const void* skeys, const void* svals,
                                 const void* smeta, const void* scsum,
                                 long long nb, const void* qkeys,
                                 const void* base, long long c, int kw, int vw,
                                 int n_probe, void* out_vals, void* out_res,
                                 void* stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((c + kThreads - 1) / kThreads);
  shard_apply_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(skeys), static_cast<const uint32_t*>(svals),
      static_cast<const uint32_t*>(smeta), static_cast<const uint32_t*>(scsum),
      nb, static_cast<const uint32_t*>(qkeys), static_cast<const int32_t*>(base),
      c, kw, vw, n_probe, static_cast<uint32_t*>(out_vals),
      static_cast<int4*>(out_res));
  return static_cast<int>(cudaGetLastError());
}
