// Fused stencil front end of the neighbourhood query: (n, D) f32 queries
// -> keys (n, M, KW) uint32 and window bases (n, M) int32.
//
// Per (row, entry) of the static enumeration neighbors.stencil_offsets
// (the centre, then for r = 1..radius each dim d, (d, +r) before (d, -r),
// then the coarse tier), derived here in closed form from the entry index:
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
// output is 46x the input.  The arithmetic is a few roundings (a logf
// each) per coordinate and per entry and a KW-word chain per entry, far
// below the ALUs' rate for the bytes written.  At the main path's 2,978
// rows that is 5.6 MB, 1.7 us at HBM rate.
//
// Design: one warp per row, four rows a block.  The work a row shares is
// done once: lanes take the coordinates that reach the key (the first
// Dk = min(D, ceil(KW / 2)); the rest are truncated away) and compute
// c = round_sig(x), rr = round_sig(c) (the value of every coordinate a
// neighbour entry does not shift), the coarse value and lattice_step(c)
// into the warp's shared memory.  Then lanes take entries, up to 32 at a
// time: a neighbour entry rounds only its one shifted coordinate,
// round_sig(c_d + o * step_d), the same operations on the same inputs as
// the plain version, so the bits are equal; each lane runs its entry's
// KW-word lo chain (zero words skip the premix) and stores the base.
// The keys of those entries are one contiguous run of the output; the
// warp writes it as 16-byte stores, each lane assembling four words from
// the shared values (4-byte stores for the run's unaligned ends, or all
// of it where the output is not 16-byte aligned).  Nothing is copied from
// the host: the enumeration is arithmetic on the entry index.
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"
#include "siground.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kWarps = 4;                  // rows a block
constexpr int kMaxSmem = 227 * 1024;       // a block's dynamic shared memory
constexpr int kEntryWords = 2 * 32;        // per warp: dim and shifted word

// entry e's dimension: -1 the centre, -2 the coarse tier, else the
// shifted dimension d of a neighbour entry, with its offset in *off
__device__ __forceinline__ int entry_dim(int e, int d, int m, bool coarse,
                                         float* off) {
  *off = 0.0f;
  if (e == 0) return -1;
  if (coarse && e == m - 1) return -2;
  const int j = e - 1;
  const int r = j / (2 * d) + 1;
  const int rem = j - (r - 1) * 2 * d;
  *off = static_cast<float>((rem & 1) ? -r : r);
  return rem >> 1;
}

// shared words of one warp: the Dk coordinates' centre, re-rounded, coarse
// and step values, then the dim and shifted word of the warp's entries
struct RowShared {
  float* cen;
  float* rr;
  float* crs;
  float* stp;
  int* dim;
  uint32_t* shifted;
};

__device__ __forceinline__ RowShared row_shared(uint32_t* ws, int dk) {
  RowShared s;
  s.cen = reinterpret_cast<float*>(ws);
  s.rr = s.cen + dk;
  s.crs = s.rr + dk;
  s.stp = s.crs + dk;
  s.dim = reinterpret_cast<int*>(s.stp + dk);
  s.shifted = reinterpret_cast<uint32_t*>(s.dim + 32);
  return s;
}

// word j of coordinate slot k = j / 2 of an entry whose dim code is dim
__device__ __forceinline__ uint32_t key_word(const RowShared& s, int dim,
                                             uint32_t shifted, int k) {
  if (k == dim) return shifted;
  const float* src = dim == -1 ? s.cen : dim == -2 ? s.crs : s.rr;
  return __float_as_uint(src[k]);
}

__global__ void stencil_keys_kernel(const float* __restrict__ x,
                                    uint32_t* __restrict__ keys,
                                    int* __restrict__ base, int64_t n, int d,
                                    int dk, int m, int coarse, int kw,
                                    int sig, uint32_t span, int vec) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      warp;
  if (row >= n) return;                    // warp-uniform
  const RowShared s = row_shared(smem + warp * (4 * dk + kEntryWords), dk);

  const float* xr = x + row * d;
  for (int k = lane; k < dk; k += 32) {
    const float c = repro::round_sig(xr[k], sig);
    s.cen[k] = c;
    s.rr[k] = repro::round_sig(c, sig);
    s.crs[k] = repro::round_sig(repro::round_sig(c, sig - 1), sig);
    s.stp[k] = repro::lattice_step(c, sig);
  }
  __syncwarp();

  const int64_t row0 = row * m * static_cast<int64_t>(kw);
  for (int e0 = 0; e0 < m; e0 += 32) {
    const int e = e0 + lane;
    if (e < m) {
      float off;
      const int dim = entry_dim(e, d, m, coarse != 0, &off);
      uint32_t shifted = 0u;
      if (dim >= 0 && dim < dk) {
        shifted = __float_as_uint(repro::round_sig(
            __fadd_rn(s.cen[dim], __fmul_rn(off, s.stp[dim])), sig));
      }
      uint32_t h = repro::kSeedLo;
      for (int k = 0; k < dk; ++k) {       // words 2k (value), 2k + 1 (zero)
        h = repro::murmur_step(h, key_word(s, dim, shifted, k));
        if (2 * k + 1 < kw) h = repro::murmur_mix(h, 0u);
      }
      for (int j = 2 * dk; j < kw; ++j) h = repro::murmur_mix(h, 0u);
      base[row * m + e] =
          static_cast<int>(repro::murmur_finish(h, kw) % span);
      s.dim[lane] = dim;
      s.shifted[lane] = shifted;
    }
    __syncwarp();

    // the run of these entries' keys: words [w0, w1) of the output
    const int e1 = m < e0 + 32 ? m : e0 + 32;
    const int64_t w0 = row0 + static_cast<int64_t>(e0) * kw;
    const int64_t w1 = row0 + static_cast<int64_t>(e1) * kw;
    // word j of the run's entry el, and the run's word at output index w
    auto word = [&](int el, int j) -> uint32_t {
      if ((j & 1) || (j >> 1) >= dk) return 0u;
      return key_word(s, s.dim[el], s.shifted[el], j >> 1);
    };
    auto word_at = [&](int64_t w) -> uint32_t {
      const int t = static_cast<int>(w - w0);
      const int el = t / kw;
      return word(el, t - el * kw);
    };
    int64_t a = w1, b = w1;                // the 16-byte-aligned middle
    if (vec) {
      const int64_t up = (w0 + 3) & ~int64_t{3};
      const int64_t down = w1 & ~int64_t{3};
      a = up < w1 ? up : w1;
      b = down > a ? down : a;
    }
    for (int64_t w = w0 + lane; w < a; w += 32) keys[w] = word_at(w);
    for (int64_t w = b + lane; w < w1; w += 32) keys[w] = word_at(w);
    for (int64_t w = a + 4 * lane; w < b; w += 128) {
      const int t = static_cast<int>(w - w0);
      int el = t / kw;
      int j = t - el * kw;
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = word(el, j);
        if (++j == kw) {
          j = 0;
          ++el;
        }
      }
      *reinterpret_cast<uint4*>(keys + w) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    __syncwarp();
  }
}

size_t warp_smem(int dk) {
  return static_cast<size_t>(4 * dk + kEntryWords) * 4;
}

}  // namespace

// The most coordinates a key can hold (min(D, ceil(KW / 2))): one warp's
// shared words must fit a block.
extern "C" int repro_stencil_keys_max_dims() {
  return (kMaxSmem / 4 - kEntryWords) / 4;
}

extern "C" int repro_stencil_keys(const void* x, void* keys, void* base,
                                  long long n, int d, int radius, int coarse,
                                  int kw, int sig, long long span,
                                  void* stream) {
  const int m = 1 + 2 * radius * d + (coarse ? 1 : 0);
  const int dk = d < (kw + 1) / 2 ? d : (kw + 1) / 2;
  if (dk > repro_stencil_keys_max_dims())
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = kWarps;
  if (warps * warp_smem(dk) > static_cast<size_t>(kMaxSmem)) warps = 1;
  const size_t smem = warps * warp_smem(dk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stencil_keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = (reinterpret_cast<uintptr_t>(keys) & 15u) == 0;
  const unsigned int blocks =
      static_cast<unsigned int>((n + warps - 1) / warps);
  stencil_keys_kernel<<<blocks, warps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint32_t*>(keys),
      static_cast<int*>(base), n, d, dk, m, coarse, kw, sig,
      static_cast<uint32_t>(span), vec);
  return static_cast<int>(cudaGetLastError());
}
