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
// value row and hit flag out: about 12.6 MB at 2^16 queries.
//
// Design: one thread per query.  The TPU kernel walks (query, way) pairs as
// sequential grid steps, carrying first-match state in its resident output
// block; here the thread loops over the ways of its set in registers and
// stops at the first hit.  A line's key words are read only when its flag is
// set, and the compare stops at the first unequal word.  Set indices are
// clamped into the cache (the caller's are always in range: fold32 % sets).
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kThreads = 128;

__global__ void l1_probe_kernel(
    const uint32_t* __restrict__ lkeys, const uint32_t* __restrict__ lvals,
    const uint8_t* __restrict__ flags, int sets, int ways,
    const uint32_t* __restrict__ qkeys, const int32_t* __restrict__ set_idx,
    int64_t n, int kw, int vw, uint8_t* __restrict__ out_hit,
    uint32_t* __restrict__ out_vals) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n) return;
  const uint32_t* qk = qkeys + q * kw;
  int s = set_idx[q];
  s = s < 0 ? 0 : (s < sets ? s : sets - 1);
  int64_t line = -1;
  for (int w = 0; w < ways && line < 0; ++w) {
    const int64_t l = static_cast<int64_t>(s) * ways + w;
    if (flags[l] == 0) continue;
    const uint32_t* lk = lkeys + l * kw;
    bool eq = true;
    for (int i = 0; i < kw && eq; ++i) eq = lk[i] == qk[i];
    if (eq) line = l;
  }
  uint32_t* ov = out_vals + q * vw;
  if (line >= 0) {
    const uint32_t* lv = lvals + line * vw;
    for (int i = 0; i < vw; ++i) ov[i] = lv[i];
  } else {
    for (int i = 0; i < vw; ++i) ov[i] = 0u;
  }
  out_hit[q] = line >= 0 ? 1 : 0;
}

}  // namespace

extern "C" int repro_l1_probe(const void* lkeys, const void* lvals,
                              const void* flags, int sets, int ways,
                              const void* qkeys, const void* set_idx,
                              long long n, int kw, int vw, void* out_hit,
                              void* out_vals, void* stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  l1_probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lkeys), static_cast<const uint32_t*>(lvals),
      static_cast<const uint8_t*>(flags), sets, ways,
      static_cast<const uint32_t*>(qkeys),
      static_cast<const int32_t*>(set_idx), n, kw, vw,
      static_cast<uint8_t*>(out_hit), static_cast<uint32_t*>(out_vals));
  return static_cast<int>(cudaGetLastError());
}
