// Backward of causal sliding-window (local) attention with grouped KV heads:
// q (B, S, H, D), k/v (B, S, Hk, D), the forward's output o and its
// gradient dO (B, S, H, D), any strides with the feature axis contiguous,
// and the forward's per-row log-sum-exp lse (B, H, S) float32 (natural
// log of the scaled scores, as local_attn.cu writes it) -> dq (B, S, H, D),
// dk/dv (B, S, Hk, D) contiguous, in the input type (float32 or bfloat16),
// every sum in float32.  Query row i of head h attends over the keys j of
// KV head h / (H / Hk) with j <= i and i - j < window; scores q.k /
// sqrt(D); P = exp(s / sqrt(D) - lse).
//
// Replaces: nothing in repro/kernels/.  The JAX package has no backward
// kernel: XLA derives the gradient of the banded path of
// repro/models/flash.py.  This is the gradient of local_attn.cu's
// function, the plain version's autograd (kernels/ref.py).
//
// Two kernels, one launch each, no atomics: every output element is summed
// by one thread in a fixed order, so a second call gives the same bits.
//   dq kernel, a CTA per (64 query rows, b, h): delta_i = sum_d dO_id o_id
//     (o as the forward stored it), written for the second kernel; then
//     one walk over the band's key tiles: P from the forward's lse, dP =
//     dO V^T, dS = P (dP - delta), dQ += dS K; dQ / sqrt(D) at the end.
//   dkv kernel, a CTA per (64 keys, b, KV head): K and V staged once; it
//     walks the G query heads of the group and, for each, the query tiles
//     in [k0, k0 + 64 + window - 1): P^T, dP^T = V dO^T, dS^T from the
//     stored lse and delta; dV += P^T dO, dK += dS^T Q.  The G heads'
//     contributions sum in registers.
//
// bf16 at D in {64, 128, 256} (training's path): wgmma on the tensor
// cores, bf16 operands, float32 sums (dq_wg_kernel, dkv_wg_kernel).  Every
// tile is 64 rows, held in shared memory in wgmma's 128-byte-swizzled
// layout (wgmma.cuh, shared with the forward) and loaded with 16-byte
// cp.async copies; the streamed tiles go through a two-stage ring, so the
// next tile is in flight while this one is multiplied (cp.async rather
// than TMA: the views are strided and may start at any 16-byte row, which
// cp.async takes as the forward does, and the copies come from the
// threads that then compute, so no producer warp holds registers).
//   dq: one warpgroup (128 threads) and 64 rows a CTA.  Per 64-key tile:
//     S = Q K^T and dP = dO V^T (m64n64k16, A and B both K-major in shared
//     memory), issued together; then P and dS in registers; then dQ += dS
//     K with dS as the register A operand and K as the N-major B.
//     Shared memory at D = 256: Q, dO and 2 x (K, V), 32 KB each, 193 KB
//     with the 1 KB for the swizzle's alignment; one CTA per SM.
//   dkv: two warpgroups a CTA, split by product, not by features.
//     Warpgroup 0: S^T = K Q^T, P^T = 2^(s c - lse log2 e) (masked to 0),
//     P^T to shared memory, then dV += P^T dO.  Warpgroup 1: dP^T = V dO^T
//     (at the same time as warpgroup 0's S^T), then, after a named barrier,
//     dS^T = P^T (dP^T - delta) and dK += dS^T Q.  Each holds one 64 x D
//     float32 accumulator (128 registers a thread at D = 256) and its A
//     operand is already in its own registers.  Query tiles (Q, dO and
//     their 64 lse and delta) stream through the ring across the G heads.
//     Shared memory at D = 256: K and V 64 KB, 2 x (Q, dO) 128 KB, P^T
//     (64 x 64 float32) 16 KB, lse/delta 1 KB, + 1 KB alignment: 210 KB,
//     one CTA per SM.
//   Registers at D = 256 (ptxas): dq 234, dkv 232 a thread, no spills.
//   P and dS enter their products as single bf16 values (one rounding,
//   2^-9 of each term).  Held against autograd through the plain version
//   under the unchanged bwd_tolerance (one bf16 ulp at each gradient's
//   largest magnitude) on the card at every case chip_smoke.py and
//   tests/test_torch_cuda.py run, and emulated on the CPU by
//   tests/test_torch_kernels.py::test_bwd_kernel_arithmetic_within_tolerance.
//   The products with Q, K, V and dO are exact in float32.
// float32 (and bf16 at D < 64) runs on CUDA cores (dq_kernel, dkv_kernel):
// bf16 inputs are widened as they are staged, tiles of float32 rows padded
// by 4 floats; the dq kernel takes 64 rows and 32-key tiles, the dkv kernel
// 32 keys and 64-row query tiles; 204.5 and 212.5 KB of shared memory at
// D = 256.
//
// Bound on the H100: operations.  Per valid (query, key) pair of a head
// the backward does 5 products of length D (q.k again, dO.v, dS k, P dO,
// dS q): 10 D operations; at gemma3-12b's training shape (B = 2, S =
// 2048, H = 16, Hk = 8, D = 256, window 1024) the valid pairs are ~1.57 M
// a head, 10 * pairs * D = 129 GFLOP a call: 0.13 ms at the bf16
// tensor-core rate (989 TFLOP/s), 1.9 ms at the CUDA cores' 67 TFLOP/s.
// The wgmma path issues 14 D operations a pair (S twice, dP twice, dQ, dK,
// dV), on the 64 x 64 tiles the band touches: ~6% more pairs than the
// band's at that shape.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W) at that
// shape: 0.764 ms (5.9x the bound; SDPA's backward with a band mask
// 1.961 ms), split about evenly between the two kernels (0.408 and 0.402
// ms a call in a profiled training step).  The mma.sync version it
// replaced took 2.180 ms.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "murmur.cuh"  // REPRO_DEFINE_ERROR_STRING
#include "wgmma.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kQ = 64;     // dq kernel: query rows a CTA
constexpr int kK = 32;     // dq kernel: keys a tile
constexpr int kKB = 32;    // dkv kernel: keys a CTA
constexpr int kQT = 64;    // dkv kernel: query rows a tile
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool key_valid(int key, int row, int S,
                                          int window) {
  return row < S && key <= row && row - key < window;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [p0, p0 + ROWS) of a (., D) view with row stride rs into a (ROWS,
// DS) float tile; rows at or past lim are zero
template <typename T, int D, int DS, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* g, long long rs,
                                      int p0, int lim) {
  for (int c = threadIdx.x; c < ROWS * D; c += kThreads) {
    const int r = c / D;
    const int d = c - r * D;
    const int p = p0 + r;
    dst[r * DS + d] = p < lim ? widen(g[p * rs + d]) : 0.f;
  }
}

// The accumulator layout of a (ROWS, D) output tile over 256 threads: a
// thread owns R rows x C features, read in vectors of V.
template <int D, int ROWS>
struct AccTile {
  static constexpr int PER = ROWS * D / kThreads;   // values a thread
  static constexpr int C = PER < 8 ? PER : 8;
  static constexpr int V = C < 4 ? C : 4;
  static constexpr int NCG = D / C;                 // feature groups
  static constexpr int NRG = kThreads / NCG;        // row groups
  static constexpr int R = ROWS / NRG;
  static_assert(R >= 1 && NRG * R == ROWS && NCG * C == D, "layout");
};

template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float (&o)[N]) {
  if constexpr (N == 4) {
    const float4 t = ld4(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
    o[0] = *p;
  }
}

// acc[i][c] += sum_{x < n} w[row_i][x] * src[x][feature_c], rows of
// ``w`` (row stride ws) and of ``src`` (row stride DS) in shared memory;
// n a multiple of 4
template <int D, int DS, int ROWS>
__device__ __forceinline__ void acc_product(
    float (&acc)[AccTile<D, ROWS>::R][AccTile<D, ROWS>::C], const float* w,
    int ws, const float* src, int n) {
  using A = AccTile<D, ROWS>;
  const int cg = threadIdx.x % A::NCG;
  const int og = threadIdx.x / A::NCG;
#pragma unroll 2
  for (int kk = 0; kk < n; kk += 4) {
    float p[A::R][4];
#pragma unroll
    for (int i = 0; i < A::R; ++i) ld_vec<4>(w + (og + A::NRG * i) * ws + kk, p[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* row = src + (kk + e) * DS;
#pragma unroll
      for (int c = 0; c < A::C / A::V; ++c) {
        float vv[A::V];
        ld_vec<A::V>(row + (cg + A::NCG * c) * A::V, vv);
#pragma unroll
        for (int i = 0; i < A::R; ++i) {
#pragma unroll
          for (int x = 0; x < A::V; ++x) {
            acc[i][c * A::V + x] = fmaf(p[i][e], vv[x], acc[i][c * A::V + x]);
          }
        }
      }
    }
  }
}

// out[(b, p0 + row, head)] = acc / sqrt(D), rows at or past S skipped
template <typename T, int D, int ROWS>
__device__ __forceinline__ void store_acc(
    const float (&acc)[AccTile<D, ROWS>::R][AccTile<D, ROWS>::C], T* out,
    int b, int S, int NH, int head, int p0, float scale) {
  using A = AccTile<D, ROWS>;
  const int cg = threadIdx.x % A::NCG;
  const int og = threadIdx.x / A::NCG;
#pragma unroll
  for (int i = 0; i < A::R; ++i) {
    const int p = p0 + og + A::NRG * i;
    if (p >= S) continue;
    T* dst = out + ((static_cast<long long>(b) * S + p) * NH + head) * D;
#pragma unroll
    for (int c = 0; c < A::C / A::V; ++c) {
#pragma unroll
      for (int x = 0; x < A::V; ++x) {
        narrow(dst + (cg + A::NCG * c) * A::V + x, acc[i][c * A::V + x] / scale);
      }
    }
  }
}

template <int D>
struct Dims {
  static constexpr int DS = D + 4;         // padded row of a staged tile
  static constexpr int PS = kK + 4;        // dq kernel: row of the dS tile
  static constexpr int PT = kQT + 4;       // dkv kernel: row of P^T, dS^T
  static constexpr int DQ_FLOATS = 2 * kQ * DS + 2 * kK * DS + kQ * PS + 2 * kQ;
  static constexpr int DKV_FLOATS =
      2 * kKB * DS + 2 * kQT * DS + 2 * kKB * PT + 2 * kQT;
};

// ---------------------------------------------------------------------------
// dq kernel (and the rows' delta)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const T* __restrict__ dout, T* __restrict__ dq,
          const float* __restrict__ lse_in, float* __restrict__ delta_out,
          int S, int H, int G, int window, long long qsb, long long qss,
          long long qsh, long long ksb,
          long long kss, long long ksh, long long vsb, long long vss,
          long long vsh, long long osb, long long oss, long long osh,
          long long gsb, long long gss, long long gsh) {
  using Dm = Dims<D>;
  constexpr int DS = Dm::DS;
  constexpr int PS = Dm::PS;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // (kQ, DS)
  float* dos = qs + kQ * DS;                     // (kQ, DS)
  float* ks = dos + kQ * DS;                     // (kK, DS)
  float* vs = ks + kK * DS;                      // (kK, DS)
  float* dss = vs + kK * DS;                     // (kQ, PS)
  float* s_lse = dss + kQ * PS;                  // (kQ,)
  float* s_delta = s_lse + kQ;                   // (kQ,)

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / G;
  const int q0 = blockIdx.x * kQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k_lo = max(0, q0 - window + 1);
  const int k_hi = min(S, q0 + kQ);
  const int n_tiles = (k_hi - k_lo + kK - 1) / kK;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  const float sqrt_d = sqrtf(static_cast<float>(D));

  stage<T, D, DS, kQ>(qs, q + b * qsb + h * qsh, qss, q0, S);
  stage<T, D, DS, kQ>(dos, dout + b * gsb + h * gsh, gss, q0, S);
  __syncthreads();

  // delta: a warp a row, lanes over the features; the row's lse as the
  // forward stored it
  for (int r = warp; r < kQ; r += kThreads / 32) {
    const int row = q0 + r;
    const long long at = static_cast<long long>(bh) * S + row;
    float acc = 0.f;
    if (row < S) {
      const T* orow = o + b * osb + row * oss + h * osh;
      for (int d = lane; d < D; d += 32) acc = fmaf(dos[r * DS + d], widen(orow[d]), acc);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      s_delta[r] = acc;
      s_lse[r] = row < S ? lse_in[at] : 0.f;
      if (row < S) delta_out[at] = acc;
    }
  }

  // score layout: warp w owns rows 8w .. 8w + 7; lane (rg, kg) = (lane /
  // 8, lane % 8) rows 8w + rg + 4i (i < 2) and keys kg + 8j (j < 4)
  const int rg = lane >> 3;
  const int kg = lane & 7;
  const int srow0 = warp * 8 + rg;

  // dS and dQ
  using A = AccTile<D, kQ>;
  float acc[A::R][A::C];
#pragma unroll
  for (int i = 0; i < A::R; ++i) {
#pragma unroll
    for (int c = 0; c < A::C; ++c) acc[i][c] = 0.f;
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = k_lo + it * kK;
    __syncthreads();   // the K/V tiles and dS are free; lse and delta are
                       // visible
    stage<T, D, DS, kK>(ks, kb, kss, t0, k_hi);
    stage<T, D, DS, kK>(vs, vb, vss, t0, k_hi);
    __syncthreads();
    float s[2][4] = {}, dp[2][4] = {};
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qa[2], ga[2], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qa[i] = ld4(qs + (srow0 + 4 * i) * DS + d);
        ga[i] = ld4(dos + (srow0 + 4 * i) * DS + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ld4(ks + (kg + 8 * j) * DS + d);
        vv[j] = ld4(vs + (kg + 8 * j) * DS + d);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kv[j].w, s[i][j]);
          dp[i][j] = fmaf(ga[i].x, vv[j].x, dp[i][j]);
          dp[i][j] = fmaf(ga[i].y, vv[j].y, dp[i][j]);
          dp[i][j] = fmaf(ga[i].z, vv[j].z, dp[i][j]);
          dp[i][j] = fmaf(ga[i].w, vv[j].w, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = srow0 + 4 * i;
      const float lse = s_lse[r];
      const float delta = s_delta[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t0 + kg + 8 * j;
        const bool ok = key < k_hi && key_valid(key, q0 + r, S, window);
        const float p = ok ? expf(s[i][j] / sqrt_d - lse) : 0.f;
        dss[r * PS + kg + 8 * j] = p * (dp[i][j] - delta);
      }
    }
    __syncthreads();   // dS is complete
    acc_product<D, DS, kQ>(acc, dss, PS, ks, kK);
  }
  store_acc<T, D, kQ>(acc, dq, b, S, H, h, q0, sqrt_d);
}

// ---------------------------------------------------------------------------
// dk / dv kernel
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse_in,
           const float* __restrict__ delta_in, T* __restrict__ dk,
           T* __restrict__ dv, int S, int H, int Hk, int G, int window,
           long long qsb, long long qss, long long qsh, long long ksb,
           long long kss, long long ksh, long long vsb, long long vss,
           long long vsh, long long gsb, long long gss, long long gsh) {
  using Dm = Dims<D>;
  constexpr int DS = Dm::DS;
  constexpr int PT = Dm::PT;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // (kKB, DS)
  float* vs = ks + kKB * DS;                     // (kKB, DS)
  float* qs = vs + kKB * DS;                     // (kQT, DS)
  float* dos = qs + kQT * DS;                    // (kQT, DS)
  float* pt = dos + kQT * DS;                    // (kKB, PT): P^T
  float* dst = pt + kKB * PT;                    // (kKB, PT): dS^T
  float* s_lse = dst + kKB * PT;                 // (kQT,)
  float* s_delta = s_lse + kQT;                  // (kQT,)

  const int bk = blockIdx.y;
  const int b = bk / Hk;
  const int hk = bk - b * Hk;
  const int k0 = blockIdx.x * kKB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q_hi = static_cast<int>(
      min(static_cast<long long>(S), static_cast<long long>(k0) + kKB + window - 1));
  const int n_tiles = (q_hi - k0 + kQT - 1) / kQT;
  const float sqrt_d = sqrtf(static_cast<float>(D));

  stage<T, D, DS, kKB>(ks, k + b * ksb + hk * ksh, kss, k0, S);
  stage<T, D, DS, kKB>(vs, v + b * vsb + hk * vsh, vss, k0, S);

  // score layout: warp w owns keys 4w .. 4w + 3; lane (rg, kg) = (lane /
  // 16, lane % 16) keys 4w + rg + 2i (i < 2) and queries kg + 16j (j < 4)
  const int rg = lane >> 4;
  const int kg = lane & 15;
  const int skey0 = warp * 4 + rg;

  using A = AccTile<D, kKB>;
  float acc_k[A::R][A::C], acc_v[A::R][A::C];
#pragma unroll
  for (int i = 0; i < A::R; ++i) {
#pragma unroll
    for (int c = 0; c < A::C; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  }

  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const T* qb = q + b * qsb + h * qsh;
    const T* gb = dout + b * gsb + h * gsh;
    const float* lse_b = lse_in + (static_cast<long long>(b) * H + h) * S;
    const float* delta_b = delta_in + (static_cast<long long>(b) * H + h) * S;
    for (int it = 0; it < n_tiles; ++it) {
      const int t0 = k0 + it * kQT;
      __syncthreads();   // the Q/dO tiles, P^T and dS^T are free
      stage<T, D, DS, kQT>(qs, qb, qss, t0, S);
      stage<T, D, DS, kQT>(dos, gb, gss, t0, S);
      for (int r = tid; r < kQT; r += kThreads) {
        const bool in = t0 + r < S;
        s_lse[r] = in ? lse_b[t0 + r] : 0.f;
        s_delta[r] = in ? delta_b[t0 + r] : 0.f;
      }
      __syncthreads();
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 ka[2], va[2], qa[4], ga[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ka[i] = ld4(ks + (skey0 + 2 * i) * DS + d);
          va[i] = ld4(vs + (skey0 + 2 * i) * DS + d);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qa[j] = ld4(qs + (kg + 16 * j) * DS + d);
          ga[j] = ld4(dos + (kg + 16 * j) * DS + d);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(ka[i].x, qa[j].x, s[i][j]);
            s[i][j] = fmaf(ka[i].y, qa[j].y, s[i][j]);
            s[i][j] = fmaf(ka[i].z, qa[j].z, s[i][j]);
            s[i][j] = fmaf(ka[i].w, qa[j].w, s[i][j]);
            dp[i][j] = fmaf(va[i].x, ga[j].x, dp[i][j]);
            dp[i][j] = fmaf(va[i].y, ga[j].y, dp[i][j]);
            dp[i][j] = fmaf(va[i].z, ga[j].z, dp[i][j]);
            dp[i][j] = fmaf(va[i].w, ga[j].w, dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kr = skey0 + 2 * i;
        const int key = k0 + kr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = kg + 16 * j;
          const bool ok = key < S && key_valid(key, t0 + qr, S, window);
          const float p = ok ? expf(s[i][j] / sqrt_d - s_lse[qr]) : 0.f;
          pt[kr * PT + qr] = p;
          dst[kr * PT + qr] = p * (dp[i][j] - s_delta[qr]);
        }
      }
      __syncthreads();   // P^T and dS^T are complete
      acc_product<D, DS, kKB>(acc_v, pt, PT, dos, kQT);
      acc_product<D, DS, kKB>(acc_k, dst, PT, qs, kQT);
    }
  }
  store_acc<T, D, kKB>(acc_v, dv, b, S, Hk, hk, k0, 1.f);
  store_acc<T, D, kKB>(acc_k, dk, b, S, Hk, hk, k0, sqrt_d);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (wgmma m64n64k16: bf16 products, float32 sums)
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;      // rows of every tile: query rows of a dq
                                 // CTA, keys of a dkv CTA, and the streamed
                                 // key (dq) or query (dkv) tiles
constexpr int kWgStages = 2;     // the ring of streamed tiles
constexpr uint32_t kBlk = kWgRows * 128;   // bytes of a tile's 64-feature block
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WgDims {
  static constexpr uint32_t TILE = kWgRows * BfTile<D>::DP * 2;   // bytes
  // + 1024: the kernels align the base to the swizzle's 1024-byte period
  static constexpr size_t DQ_BYTES = (2 + 2 * kWgStages) * TILE + 1024;
  static constexpr size_t P_BYTES = kWgRows * kWgRows * 4;         // P^T
  static constexpr size_t LD_BYTES = 2 * kWgRows * 4;   // a stage's lse, delta
  static constexpr size_t DKV_BYTES =
      (2 + 2 * kWgStages) * TILE + P_BYTES + kWgStages * LD_BYTES + 1024;
};

// 4 bytes global -> shared, or 4 zero bytes where !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}

// a 64 x 64 accumulator tile as the bf16 A operand of its four k16 steps,
// each value rounded once: slice n (8 columns) is step n / 2's registers
// 2 (n % 2) (row lane / 4) and 2 (n % 2) + 1 (row + 8)
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    a[n >> 1][(n & 1) * 2] = bits(__floats2bfloat162_rn(x[4 * n], x[4 * n + 1]));
    a[n >> 1][(n & 1) * 2 + 1] =
        bits(__floats2bfloat162_rn(x[4 * n + 2], x[4 * n + 3]));
  }
}

__device__ __forceinline__ bool pair_valid(int key, int row, int k_hi, int S,
                                           int window) {
  return key < k_hi && row < S && key <= row && row - key < window;
}

// sum of the products of two 8-element bf16 vectors, in float32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 fx = __bfloat1622float2(x[j]);
    const float2 fy = __bfloat1622float2(y[j]);
    acc = fmaf(fx.x, fy.x, acc);
    acc = fmaf(fx.y, fy.y, acc);
  }
  return acc;
}

// d (64 x 64) = A B^T over the D features: A and B 64-row tiles at a, b
template <int D>
__device__ __forceinline__ void tile_abt(float (&d)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks >> 2) * kBlk + (ks & 3) * 32;
    wgmma_qk(d, gmma_desc(a + off), gmma_desc(b + off));
  }
}

// acc (64 x D) += A B: A the four k16 steps in registers, B the 64-row
// tile at b (rows the k axis)
template <int NB>
__device__ __forceinline__ void tile_ab(float (&acc)[NB][32],
                                        const uint32_t (&a)[4][4],
                                        uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      wgmma_pv(acc[n], a[ks], gmma_desc(b + n * kBlk + ks * 2048));
    }
  }
}

// out[(b, row, head)] = acc / scale for the thread's accumulator rows
// row_a and row_a + 8, rows at or past S skipped
template <int D>
__device__ __forceinline__ void store_wg(const float (&acc)[BfTile<D>::NB][32],
                                         bf16* out, int b, int S, int NH,
                                         int head, int row_a, float scale) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= S) continue;
    bf16* op = out + ((static_cast<long long>(b) * S + row) * NH + head) * D;
#pragma unroll
    for (int n = 0; n < BfTile<D>::NB; ++n) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(op + 64 * n + 8 * j + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[n][4 * j + 2 * i] / scale,
                                  acc[n][4 * j + 2 * i + 1] / scale);
      }
    }
  }
}

template <int NB>
__device__ __forceinline__ void fence_acc(float (&acc)[NB][32]) {
#pragma unroll
  for (int n = 0; n < NB; ++n) fence_regs(acc[n]);
}

// dq: a CTA per (64 query rows, b, h), one warpgroup; the key tiles of
// the band [q0 - window + 1, q0 + 63] through the ring
template <int D>
__global__ void __launch_bounds__(128, 1)
dq_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ o,
             const bf16* __restrict__ dout, bf16* __restrict__ dq,
             const float* __restrict__ lse, float* __restrict__ delta_out,
             int S, int H, int G, int window, long long qsb, long long qss,
             long long qsh, long long ksb, long long kss, long long ksh,
             long long vsb, long long vss, long long vsh, long long osb,
             long long oss, long long osh, long long gsb, long long gss,
             long long gsh) {
  constexpr int NB = BfTile<D>::NB;
  constexpr int STAGES = kWgStages;
  constexpr uint32_t TILE = WgDims<D>::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t s_g = s_q + TILE;                 // dO
  const uint32_t s_kv = s_g + TILE;                // stage i: K, then V

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / G;
  const int q0 = blockIdx.x * kWgRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_a = q0 + 16 * warp + (lane >> 2);
  const int row_b = row_a + 8;
  const int k_lo = max(0, q0 - window + 1);
  const int k_hi = min(S, q0 + kWgRows);
  const int n_tiles = (k_hi - k_lo + kWgRows - 1) / kWgRows;
  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;
  // p = 2^(s c - lse log2(e)) on raw scores s
  const float c = kLog2e / sqrtf(static_cast<float>(D));

  stage_bf16<D, kWgRows, 128>(s_q, q + b * qsb + h * qsh, qss, q0, S);
  stage_bf16<D, kWgRows, 128>(s_g, dout + b * gsb + h * gsh, gss, q0, S);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) {
      stage_bf16<D, kWgRows, 128>(s_kv + 2 * i * TILE, kb, kss,
                                  k_lo + i * kWgRows, k_hi);
      stage_bf16<D, kWgRows, 128>(s_kv + (2 * i + 1) * TILE, vb, vss,
                                  k_lo + i * kWgRows, k_hi);
    }
    cp_async_commit();
  }
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? row_b : row_a;
    lse2[i] = row < S ? lse[static_cast<long long>(bh) * S + row] * kLog2e
                      : 0.f;
  }
  cp_async_wait<STAGES - 1>();   // Q and dO have landed
  __syncthreads();

  // delta of the warp's 16 rows (its accumulator rows), lanes over the
  // rows' 16-byte chunks
  float delta[2] = {0.f, 0.f};
  {
    const unsigned char* g_tile = smem + (s_g - smem_addr(smem));
    for (int rr = 0; rr < 16; ++rr) {
      const int r = 16 * warp + rr;
      const int row = q0 + r;
      float acc = 0.f;
      if (row < S) {
        const bf16* orow = o + b * osb + row * oss + h * osh;
        for (int ch = lane; ch < D / 8; ch += 32) {
          acc += dot8(*reinterpret_cast<const uint4*>(
                          g_tile + BfTile<D>::template at<kWgRows>(r, ch)),
                      *reinterpret_cast<const uint4*>(orow + ch * 8));
        }
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (rr == (lane >> 2)) delta[0] = acc;
      if (rr == (lane >> 2) + 8) delta[1] = acc;
      if (lane == 0 && row < S) {
        delta_out[static_cast<long long>(bh) * S + row] = acc;
      }
    }
  }

  float acc[NB][32];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  }
  for (int it = 0; it < n_tiles; ++it) {
    {
      const int nx = it + STAGES - 1;
      if (nx < n_tiles) {
        const int st = nx % STAGES;
        stage_bf16<D, kWgRows, 128>(s_kv + 2 * st * TILE, kb, kss,
                                    k_lo + nx * kWgRows, k_hi);
        stage_bf16<D, kWgRows, 128>(s_kv + (2 * st + 1) * TILE, vb, vss,
                                    k_lo + nx * kWgRows, k_hi);
      }
      cp_async_commit();
    }
    cp_async_wait<STAGES - 1>();
    fence_proxy_async();   // the copies are visible to wgmma's reads
    __syncthreads();

    const int t0 = k_lo + it * kWgRows;
    const uint32_t s_k = s_kv + 2 * (it % STAGES) * TILE;
    const uint32_t s_v = s_k + TILE;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wg_arrive();
    tile_abt<D>(s, s_q, s_k);     // S = Q K^T
    tile_abt<D>(dp, s_g, s_v);    // dP = dO V^T
    wg_commit();
    wg_wait0();
    fence_regs(s);
    fence_regs(dp);

    const bool full = t0 + kWgRows <= k_hi && t0 + kWgRows - 1 <= q0 &&
                      q0 + kWgRows - 1 - t0 < window && q0 + kWgRows <= S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int sel = (i >> 1) & 1;
      const int key = t0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const bool ok =
          full || pair_valid(key, sel ? row_b : row_a, k_hi, S, window);
      const float p = ok ? ex2(fmaf(s[i], c, -lse2[sel])) : 0.f;
      s[i] = p * (dp[i] - delta[sel]);   // dS
    }
    uint32_t a[4][4];
    pack_a(s, a);
    fence_acc(acc);
    wg_arrive();
    tile_ab(acc, a, s_k);         // dQ += dS K
    wg_commit();
    wg_wait0();
    fence_acc(acc);
    __syncthreads();              // the stage is free
  }
  cp_async_wait<0>();
  store_wg<D>(acc, dq, b, S, H, h, row_a, sqrtf(static_cast<float>(D)));
}

// dk / dv: a CTA per (64 keys, b, KV head), warpgroup 0 the P^T side (dV),
// warpgroup 1 the dS^T side (dK); the G query heads and their 64-row
// query tiles in [k0, k0 + 64 + window - 1) through the ring
template <int D>
__global__ void __launch_bounds__(256, 1)
dkv_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dk,
              bf16* __restrict__ dv, int S, int H, int Hk, int G, int window,
              long long qsb, long long qss, long long qsh, long long ksb,
              long long kss, long long ksh, long long vsb, long long vss,
              long long vsh, long long gsb, long long gss, long long gsh) {
  using W = WgDims<D>;
  constexpr int NB = BfTile<D>::NB;
  constexpr int STAGES = kWgStages;
  constexpr uint32_t TILE = W::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_addr(smem);
  const uint32_t s_k = (s0 + 1023u) & ~1023u;
  const uint32_t s_v = s_k + TILE;
  const uint32_t s_qg = s_v + TILE;                // stage i: Q, then dO
  const uint32_t s_p = s_qg + 2 * STAGES * TILE;   // P^T, (32, 128) floats
  const uint32_t s_ld = s_p + W::P_BYTES;          // stage i: lse, delta

  const int bk = blockIdx.y;
  const int b = bk / Hk;
  const int hk = bk - b * Hk;
  const int k0 = blockIdx.x * kWgRows;
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int key_a = k0 + 16 * (tid >> 5) + (lane >> 2);
  const int key_b = key_a + 8;
  const int q_hi = static_cast<int>(min(
      static_cast<long long>(S), static_cast<long long>(k0) + kWgRows + window - 1));
  const int n_tiles = (q_hi - k0 + kWgRows - 1) / kWgRows;
  const int total = G * n_tiles;
  const float c = kLog2e / sqrtf(static_cast<float>(D));

  // the query tile of flat step j (head j / n_tiles) into stage st
  auto stage_q = [&](int j, int st) {
    const int hh = j / n_tiles;
    const int t0 = k0 + (j - hh * n_tiles) * kWgRows;
    const int h = hk * G + hh;
    stage_bf16<D, kWgRows, 256>(s_qg + 2 * st * TILE, q + b * qsb + h * qsh,
                                qss, t0, S);
    stage_bf16<D, kWgRows, 256>(s_qg + (2 * st + 1) * TILE,
                                dout + b * gsb + h * gsh, gss, t0, S);
    if (threadIdx.x < 2 * kWgRows) {
      const int r = threadIdx.x & (kWgRows - 1);
      const float* src = (threadIdx.x < kWgRows ? lse : delta) +
                         (static_cast<long long>(b) * H + h) * S;
      const bool ok = t0 + r < S;
      cp_async4(s_ld + st * W::LD_BYTES + threadIdx.x * 4,
                ok ? src + t0 + r : src, ok);
    }
  };

  stage_bf16<D, kWgRows, 256>(s_k, k + b * ksb + hk * ksh, kss, k0, S);
  stage_bf16<D, kWgRows, 256>(s_v, v + b * vsb + hk * vsh, vss, k0, S);
  stage_q(0, 0);
  cp_async_commit();

  float acc[NB][32];   // warpgroup 0: dV; warpgroup 1: dK
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  }
  float2* pt = reinterpret_cast<float2*>(smem + (s_p - s0)) + tid;
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) stage_q(it + 1, (it + 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    fence_proxy_async();   // the copies are visible to wgmma's reads
    __syncthreads();

    const int st = it % STAGES;
    const int t0 = k0 + (it % n_tiles) * kWgRows;
    const uint32_t s_qt = s_qg + 2 * st * TILE;
    const uint32_t s_gt = s_qt + TILE;
    const float* ld =
        reinterpret_cast<const float*>(smem + (s_ld - s0) + st * W::LD_BYTES);
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    fence_regs(x);
    wg_arrive();
    // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T
    tile_abt<D>(x, wg ? s_v : s_k, wg ? s_gt : s_qt);
    wg_commit();
    wg_wait0();
    fence_regs(x);

    if (wg == 0) {
      const bool full = k0 + kWgRows <= S && t0 + kWgRows <= S &&
                        t0 >= k0 + kWgRows - 1 &&
                        t0 + kWgRows - 1 - k0 < window;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int key = (i & 2) ? key_b : key_a;
        const bool ok = full || pair_valid(key, t0 + col, S, S, window);
        x[i] = ok ? ex2(fmaf(x[i], c, -ld[col] * kLog2e)) : 0.f;   // P^T
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) pt[i * 128] = make_float2(x[2 * i], x[2 * i + 1]);
      __threadfence_block();
      asm volatile("bar.arrive 1, 256;\n" ::: "memory");   // P^T is written
    } else {
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 p = pt[i * 128];
        const int col = 8 * (i >> 1) + 2 * (lane & 3);
        x[2 * i] = p.x * (x[2 * i] - ld[kWgRows + col]);            // dS^T
        x[2 * i + 1] = p.y * (x[2 * i + 1] - ld[kWgRows + col + 1]);
      }
    }
    uint32_t a[4][4];
    pack_a(x, a);
    fence_acc(acc);
    wg_arrive();
    // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T Q
    tile_ab(acc, a, wg ? s_qt : s_gt);
    wg_commit();
    wg_wait0();
    fence_acc(acc);
    __syncthreads();   // the stage and P^T are free
  }
  cp_async_wait<0>();
  store_wg<D>(acc, wg ? dk : dv, b, S, Hk, hk, key_a,
              wg ? sqrtf(static_cast<float>(D)) : 1.f);
}

template <int D>
int launch_wg(const void* q, const void* k, const void* v, const void* o,
              const void* dout, void* dq, void* dk, void* dv, const float* lse,
              float* delta, int B, int S, int H, int Hk, int window,
              const long long* st, cudaStream_t stream) {
  using W = WgDims<D>;
  auto kq = dq_wg_kernel<D>;
  auto kkv = dkv_wg_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(W::DQ_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(W::DKV_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tg = static_cast<const bf16*>(dout);
  const int rows = (S + kWgRows - 1) / kWgRows;
  kq<<<dim3(rows, B * H), 128, W::DQ_BYTES, stream>>>(
      tq, tk, tv, static_cast<const bf16*>(o), tg, static_cast<bf16*>(dq), lse,
      delta, S, H, H / Hk, window, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kkv<<<dim3(rows, B * Hk), 256, W::DKV_BYTES, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      S, H, Hk, H / Hk, window, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[12], st[13], st[14]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, const float* lse,
           float* delta, int B, int S, int H, int Hk, int window,
           const long long* st, cudaStream_t stream) {
  using Dm = Dims<D>;
  const size_t smem_q = Dm::DQ_FLOATS * sizeof(float);
  const size_t smem_kv = Dm::DKV_FLOATS * sizeof(float);
  auto kq = dq_kernel<T, D>;
  auto kkv = dkv_kernel<T, D>;
  cudaError_t err;
  if (smem_q > 48 * 1024) {
    err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_q));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (smem_kv > 48 * 1024) {
    err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_kv));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(dout);
  const dim3 grid_q((S + kQ - 1) / kQ, B * H);
  kq<<<grid_q, kThreads, smem_q, stream>>>(
      tq, tk, tv, static_cast<const T*>(o), tg, static_cast<T*>(dq), lse,
      delta, S, H, H / Hk, window, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13],
      st[14]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((S + kKB - 1) / kKB, B * Hk);
  kkv<<<grid_kv, kThreads, smem_kv, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S,
      H, Hk, H / Hk, window, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[12], st[13], st[14]);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(bool bf, const void* q, const void* k, const void* v,
             const void* o, const void* dout, void* dq, void* dk, void* dv,
             const float* lse, float* delta, int B, int S, int H, int Hk,
             int window, const long long* st, cudaStream_t s) {
  if (!bf) {
    return launch<float, D>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H,
                            Hk, window, st, s);
  }
  if constexpr (D >= 64) {
    return launch_wg<D>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H, Hk,
                        window, st, s);
  } else {
    return launch<bf16, D>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H,
                           Hk, window, st, s);
  }
}

}  // namespace

// D in {8, 16, 32, 64, 128, 256} (others: cudaErrorInvalidValue, and the
// wrapper refuses them first).  strides: element strides (batch, seq,
// head) of q, k, v, o, then dout.  lse: the forward's float32 (B, H, S)
// log-sum-exp; delta: a float32 (B, H, S) workspace the first kernel
// fills and the second reads.
extern "C" int repro_local_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse,
    void* delta, int B, int S, int H, int Hk, int D, int window, int is_bf16,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long gsb, long long gss, long long gsh,
    void* stream) {
  const long long st[15] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                            vsh, osb, oss, osh, gsb, gss, gsh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define REPRO_BWD_CASE(DD)                                                   \
  case DD:                                                                   \
    return launch_d<DD>(bf, q, k, v, o, dout, dq, dk, dv, l, dl, B, S, H,    \
                        Hk, window, st, s);
  switch (D) {
    REPRO_BWD_CASE(8)
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(128)
    REPRO_BWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_BWD_CASE
}
