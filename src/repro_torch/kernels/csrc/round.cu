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
// Design: one thread per value, 256 per block, consecutive threads on
// consecutive values (coalesced 4-byte loads and stores).  The TPU
// kernel's (8, 128) tiling exists for the TPU's vector registers; on
// Hopper a flat index does the same job.  The pow10 table sits in
// constant memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"
#include "siground.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kThreads = 256;

__global__ void round_sig_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int64_t n,
                                 int sig) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = repro::round_sig(x[i], sig);
}

}  // namespace

extern "C" int repro_round_sig(const void* x, void* out, long long n,
                               int sig, void* stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  round_sig_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, sig);
  return static_cast<int>(cudaGetLastError());
}
