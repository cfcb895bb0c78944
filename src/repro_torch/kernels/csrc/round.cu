// Elementwise round to sig_digits significant decimal digits: (N,) f32 ->
// (N,) f32.  Zeros, -0 and denormals give +0; inf and nan keep their
// bits; the decimal exponent is clamped to [-38, 38] (siground.cuh).
//
// Replaces: repro/kernels/round_kernel.py round_sig_pallas
// (_round_kernel).
//
// Bound on the H100: bytes.  4 B read and 4 B written per value; one
// logf, a floor, two table reads and three products, a few dozen
// operations, against 8 B.  On the keys phase's 2 M values that is
// 16 MB, 4.8 us at HBM rate.
//
// The TPU kernel's (8, 128) tiling exists for the TPU's vector registers;
// on Hopper what matters is how many bytes are in flight and how the
// pow10 table is read.  Design:
//   - each thread loads kVecs 16-byte float4 vectors, all before it
//     computes or stores any, in a grid-stride loop over a grid sized to
//     the SM count (tiles of kThreads * kVecs vectors, index arithmetic
//     by shifts and products, no 64-bit divide); the first block rounds
//     the n % 4 tail;
//   - where the input or the output is not 16-byte aligned (a view that
//     starts a word in) the same loop runs on 4-byte words;
//   - the 77-word pow10 table is copied into shared memory once a block,
//     and pow10(-e) is word 76 - idx of it.  A warp's lookup then takes
//     at most three passes (exponents 32 apart share a bank), where the
//     table in constant memory (siground.cuh's pow10_of) serialises it
//     once per distinct exponent: a few dozen times a lookup on inputs
//     that span many decades.  A warp-resident table (words l, l + 32
//     and l + 64 in lane l's registers, three __shfl_sync and a select a
//     lookup) was measured 12% slower.
// The arithmetic is siground.cuh's round_sig, bit for bit: decade_of
// (full-precision logf, no fast math), __fmul_rn, rintf, __fmul_rn.  The
// stencil kernel keeps siground.cuh's constant-memory lookup unchanged.
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"
#include "siground.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;          // vectors a thread has in flight
constexpr int kBlocksPerSm = 4;   // resident blocks the grid is sized for

// The pow10 table in shared memory, copied in once a block; every thread
// of the block must construct it.  A warp's lookup costs at most three
// passes (exponents 32 apart share a bank).
struct SharedPow10 {
  const uint32_t* table;

  __device__ __forceinline__ SharedPow10() {
    __shared__ uint32_t words[77];
    for (int i = threadIdx.x; i < 77; i += blockDim.x)
      words[i] = repro::kPow10Bits[i];
    __syncthreads();
    table = words;
  }

  // word idx (0 .. 76) of the table
  __device__ __forceinline__ float operator()(int idx) const {
    return __uint_as_float(table[idx]);
  }
};

// siground.cuh's round_sig with the shared table; the lookups run for
// every value (any input's clamped exponent is a valid index) and the
// special cases are selected after them, so a warp does not branch
__device__ __forceinline__ float round_one(float x, int sig,
                                           const SharedPow10& pow10) {
  const float a = fabsf(x);
  const float e = static_cast<float>(sig - 1) - repro::decade_of(a);
  const int idx = static_cast<int>(fminf(fmaxf(e, -38.0f), 38.0f)) + 38;
  const float r = __fmul_rn(rintf(__fmul_rn(x, pow10(idx))), pow10(76 - idx));
  if (!isfinite(x)) return x;              // inf and nan keep their bits
  return a < repro::kTinyF32 ? 0.0f : r;   // +0: zeros, denormals
}

template <typename V> struct Lanes;        // the floats of one access
template <> struct Lanes<float> {
  static constexpr int kN = 1;
  __device__ static float& at(float& v, int) { return v; }
};
template <> struct Lanes<float4> {
  static constexpr int kN = 4;
  __device__ static float& at(float4& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
  }
};

// V: float4 where both buffers are 16-byte aligned, else float
template <typename V>
__global__ void __launch_bounds__(kThreads) round_sig_kernel(
    const float* __restrict__ x, float* __restrict__ out, int64_t n,
    int sig) {
  constexpr int kN = Lanes<V>::kN;
  const SharedPow10 pow10;
  const V* xv = reinterpret_cast<const V*>(x);
  V* ov = reinterpret_cast<V*>(out);
  const int64_t nv = n / kN;                       // whole vectors
  constexpr int64_t kTile = int64_t{kThreads} * kVecs;
  for (int64_t t0 = blockIdx.x * kTile; t0 < nv;
       t0 += int64_t{gridDim.x} * kTile) {
    V v[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t i = t0 + u * kThreads + threadIdx.x;
      if (i < nv) v[u] = xv[i];
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t i = t0 + u * kThreads + threadIdx.x;
      if (i < nv) {
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          float& f = Lanes<V>::at(v[u], k);
          f = round_one(f, sig, pow10);
        }
        ov[i] = v[u];
      }
    }
  }
  // the n % kN values after the last whole vector
  if (kN > 1 && blockIdx.x == 0 && threadIdx.x < n - nv * kN) {
    const int64_t i = nv * kN + threadIdx.x;
    out[i] = round_one(x[i], sig, pow10);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename V>
int launch(const void* x, void* out, long long n, int sig,
           cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr long long kPerBlock =
      static_cast<long long>(kThreads) * kVecs * (sizeof(V) / 4);
  const long long want = (n + kPerBlock - 1) / kPerBlock;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const unsigned int blocks =
      static_cast<unsigned int>(want < cap ? (want > 0 ? want : 1) : cap);
  round_sig_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, sig);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_round_sig(const void* x, void* out, long long n,
                               int sig, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (aligned16(x) && aligned16(out))
    return launch<float4>(x, out, n, sig, s);
  return launch<float>(x, out, n, sig, s);
}
