// Significant-digit rounding onto the key lattice, shared by the round and
// stencil kernels.
//
// Bit for bit the plain torch version in repro_torch/core/neighbors.py
// (round_significant, lattice_step) as torch computes it on the card:
//   decade  = floor(log(|x|) * f32(1/ln 10))        (the F1 form, no log10)
//   10^e    = the 77-entry table of the reference's f32 bits, e clamped
//             to [-38, 38]
//   rounded = rint(x * 10^e) * 10^-e,  e = (sig - 1) - decade
// Every product is an explicit __fmul_rn and the stencil's shift an
// explicit __fadd_rn, so no contraction into an FMA can differ from
// torch's separate elementwise kernels.  logf is the full-precision
// logf torch.log calls: build without --use_fast_math.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// f32 bits of the reference's pow10(e) for e = -38 .. 38
// (_POW10_BITS in repro_torch/core/neighbors.py)
static __constant__ uint32_t kPow10Bits[77] = {
    0x00000000u, 0x02081CEAu, 0x03AA2425u, 0x0554AD2Eu, 0x0704EC3Du,
    0x08A6274Cu, 0x0A4FB11Fu, 0x0C01CEB3u, 0x0DA24260u, 0x0F4AD2F8u,
    0x10FD87B6u, 0x129E74D2u, 0x14461206u, 0x15F79688u, 0x179ABE15u,
    0x19416D9Au, 0x1AF1C901u, 0x1C971DA0u, 0x1E3CE508u, 0x1FEC1E4Au,
    0x219392EFu, 0x233877AAu, 0x24E69595u, 0x26901D7Du, 0x283424DCu,
    0x29E12E13u, 0x2B8CBCCCu, 0x2D2FEBFFu, 0x2EDBE6FFu, 0x3089705Fu,
    0x322BCC77u, 0x33D6BF95u, 0x358637BDu, 0x3727C5ACu, 0x38D1B717u,
    0x3A83126Fu, 0x3C23D70Au, 0x3DCCCCCDu, 0x3F800000u, 0x41200000u,
    0x42C80000u, 0x447A0000u, 0x461C4000u, 0x47C35000u, 0x49742400u,
    0x4B189680u, 0x4CBEBC20u, 0x4E6E6B28u, 0x501502F9u, 0x51BA43B7u,
    0x5368D4A5u, 0x551184E7u, 0x56B5E621u, 0x58635FA9u, 0x5A0E1BCAu,
    0x5BB1A2BCu, 0x5D5E0B6Bu, 0x5F0AC723u, 0x60AD78ECu, 0x6258D727u,
    0x64078678u, 0x65A96816u, 0x6753C21Cu, 0x69045951u, 0x6AA56FA6u,
    0x6C4ECB8Fu, 0x6E013F39u, 0x6FA18F08u, 0x7149F2CAu, 0x72FC6F7Cu,
    0x749DC5AEu, 0x76453719u, 0x77F684DFu, 0x799A130Cu, 0x7B4097CEu,
    0x7CF0BDC2u, 0x7E967699u,
};

// smallest positive normal f32: smaller magnitudes (denormals, zeros)
// round to +0
constexpr float kTinyF32 = 1.17549435e-38f;
// f32(1 / ln 10)
constexpr uint32_t kInvLn10Bits = 0x3EDE5BD9u;

__device__ __forceinline__ float pow10_of(float e) {
  const float c = fminf(fmaxf(e, -38.0f), 38.0f);
  return __uint_as_float(kPow10Bits[static_cast<int>(c) + 38]);
}

// floor(log10 a) of a finite, normal magnitude a
__device__ __forceinline__ float decade_of(float a) {
  return floorf(__fmul_rn(logf(a), __uint_as_float(kInvLn10Bits)));
}

__device__ __forceinline__ float round_sig(float x, int sig) {
  if (!isfinite(x)) return x;  // inf and nan keep their bits
  const float a = fabsf(x);
  if (a < kTinyF32) return 0.0f;  // +0 for zeros of either sign, denormals
  const float e = static_cast<float>(sig - 1) - decade_of(a);
  return __fmul_rn(rintf(__fmul_rn(x, pow10_of(e))), pow10_of(-e));
}

// one lattice step at the magnitude of an already rounded coordinate;
// zeros, denormals and non-finite values step at 10^-(sig-1)
__device__ __forceinline__ float lattice_step(float c, int sig) {
  const float a = fabsf(c);
  const float safe = (isfinite(a) && !(a < kTinyF32)) ? a : 1.0f;
  return pow10_of(decade_of(safe) - static_cast<float>(sig - 1));
}

}  // namespace repro
