// Fused stencil front end of the neighbourhood query: (n, D) f32 queries
// -> keys (n, M, KW) uint32 and window bases (n, M) int32.
//
// Per (row, entry) of the static enumeration (dim, off) that the wrapper
// passes as an (M, 2) int32 table (neighbors.stencil_offsets: the centre
// (-1, 0), then for r = 1..radius each dim (d, +r) before (d, -r), then
// the coarse tier (-2, 0)):
//   c      = round_sig(x, sig) per coordinate                 (the centre)
//   centre : p = c
//   coarse : p = round_sig(round_sig(c, sig - 1), sig)
//   (d, o) : p = round_sig(c'), c' = c except c'[d] = c[d] + o * step(c[d])
//   key    = p's f32 bits in even word slots, zeros in odd slots and in
//            the padding up to KW (layout.pack_floats)
//   base   = murmur3(key, seed 0x85EBCA77) mod max(B - P + 1, 1), unsigned
//            (hashing.base_bucket of the hash64 lo lane)
//
// Replaces: repro/kernels/stencil_kernel.py stencil_keys_pallas
// (_stencil_kernel, _pack_rows).
//
// Bound on the H100: bytes.  Each query row is read once (40 B at D = 10)
// and M * (KW + 1) words are written (1,848 B at M = 22, KW = 20): the
// output is 46x the input.  The arithmetic, D roundings (a logf each) and
// a KW-word chain per entry, is a few thousand operations per entry, far
// below the ALUs' rate for the bytes written.  At the main path's 2,978
// rows that is 5.6 MB, 1.7 us at HBM rate.
//
// Design: one thread per (row, entry), 128 per block.  A thread recomputes
// its row's centre from the D inputs (the M threads of a row read the
// same 40 B, served by L1) and writes its own KW-word key; the M entries
// of a row are consecutive threads, so a warp writes one contiguous run of
// keys.  The TPU kernel expands an (8, D) tile to all M entries in
// registers and stores (8, M * KW) at once; on Hopper the entry axis is
// spread over threads instead, so no thread holds more than one key.
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"
#include "siground.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kThreads = 128;

__global__ void stencil_keys_kernel(const float* __restrict__ x,
                                    const int* __restrict__ offsets,
                                    uint32_t* __restrict__ keys,
                                    int* __restrict__ base, int64_t n, int d,
                                    int m, int kw, int sig, uint32_t span) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * m) return;
  const int64_t row = t / m;
  const int entry = static_cast<int>(t - row * m);
  const int dim = offsets[2 * entry];
  const float off = static_cast<float>(offsets[2 * entry + 1]);
  const float* xr = x + row * d;
  uint32_t* out = keys + t * kw;

  uint32_t h = repro::kSeedLo;
  int j = 0;
  for (int c = 0; c < d && j < kw; ++c) {
    float p = repro::round_sig(xr[c], sig);
    if (dim == -2) {
      p = repro::round_sig(repro::round_sig(p, sig - 1), sig);
    } else if (dim >= 0) {
      if (c == dim) {
        p = __fadd_rn(p, __fmul_rn(off, repro::lattice_step(p, sig)));
      }
      p = repro::round_sig(p, sig);
    }
    const uint32_t w = __float_as_uint(p);
    out[j++] = w;
    h = repro::murmur_step(h, w);
    if (j < kw) {
      out[j++] = 0u;
      h = repro::murmur_step(h, 0u);
    }
  }
  for (; j < kw; ++j) {
    out[j] = 0u;
    h = repro::murmur_step(h, 0u);
  }
  base[t] = static_cast<int>(repro::murmur_finish(h, kw) % span);
}

}  // namespace

extern "C" int repro_stencil_keys(const void* x, const void* offsets,
                                  void* keys, void* base, long long n, int d,
                                  int m, int kw, int sig, long long span,
                                  void* stream) {
  const long long threads = n * m;
  const unsigned int blocks =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  stencil_keys_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(offsets),
      static_cast<uint32_t*>(keys), static_cast<int*>(base), n, d, m, kw, sig,
      static_cast<uint32_t>(span));
  return static_cast<int>(cudaGetLastError());
}
