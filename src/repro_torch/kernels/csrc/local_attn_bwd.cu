// Backward of causal sliding-window (local) attention with grouped KV heads:
// q (B, S, H, D), k/v (B, S, Hk, D), the forward's output o and its
// gradient dO (B, S, H, D), any strides with the feature axis contiguous
// -> dq (B, S, H, D), dk/dv (B, S, Hk, D) contiguous, in the input type
// (float32 or bfloat16), every sum in float32.  Query row i of head h
// attends over the keys j of KV head h / (H / Hk) with j <= i and
// i - j < window; scores q.k / sqrt(D).
//
// Replaces: nothing in repro/kernels/.  The JAX package has no backward
// kernel: XLA derives the gradient of the banded path of
// repro/models/flash.py.  This is the gradient of local_attn.cu's
// function, the plain version's autograd (kernels/ref.py).
//
// Two kernels, one launch each, no atomics (the sums of every output
// element run in one thread in a fixed order, so the result is the same
// bits on every run):
//   dq kernel, a CTA per (64 query rows, b, h): stages Q and dO once;
//     delta_i = sum_d dO_id o_id (o as the forward stored it); pass 1
//     walks the band's 32-key tiles for each row's max and sum (lse = m +
//     log l); pass 2 walks them again: P = exp(s - lse), dP = dO V^T,
//     dS = P (dP - delta), dQ += dS K; dQ / sqrt(D) at the end.  It
//     writes lse and delta for the second kernel.
//   dkv kernel, a CTA per (a block of keys, b, KV head): stages K and V
//     once and walks the G query heads of the group and, for each, the
//     query tiles in [j0, j0 + keys + window - 1): P^T, dP^T = V dO^T and
//     dS^T from the stored lse and delta; dV += P^T dO, dK += dS^T Q.
//     The G heads' contributions sum in registers.
// bf16 at D >= 64 (training's path) runs on the tensor cores: mma.sync
// m16n8k16 with bf16 operands from ldmatrix and float32 sums.  The
// products with Q, K, V and dO are exact in float32; P and dS enter
// theirs as bf16 hi + lo pairs (hi = bf16(x), lo = bf16(x - hi)), so they
// keep ~2^-17 of their value where one bf16 operand would move each term
// by up to 2^-9.  The dq kernel gives each of 4 warps 16 rows; the dkv
// kernel takes 64 keys and 32-row query tiles, its 8 warps 16 keys and
// half the features each (both warps of a key group compute its scores).
// Tiles sit in shared memory as bf16 rows padded by 16 bytes (conflict-free
// ldmatrix); 99 KB a CTA at D = 256.  Softmax in base 2: the dq kernel's
// lse is stored in base-2 units of the scaled score.
// float32 (and D < 64) runs on CUDA cores: bf16 inputs are widened as they
// are staged, tiles of float32 rows padded by 4 floats; the dq kernel
// takes 64 rows and 32-key tiles, the dkv kernel 32 keys and 64-row query
// tiles; 204.5 and 212.5 KB of shared memory at D = 256.
//
// Bound on the H100: operations.  Per valid (query, key) pair of a head
// the backward does 5 products of length D (q.k again, dO.v, dS k, P dO,
// dS q): 10 D operations; at gemma3-12b's training shape (B = 2, S =
// 2048, H = 16, Hk = 8, D = 256, window 1024) the valid pairs are ~1.57 M
// a head, 10 * pairs * D = 129 GFLOP a call: 0.13 ms at the bf16
// tensor-core rate (989 TFLOP/s), 1.9 ms at the CUDA cores' 67 TFLOP/s.
// The tensor-core path issues 26 D operations a pair: the dq kernel's
// first pass, the dkv kernel's scores in both feature halves, and the
// products with P and dS twice (hi and lo).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "murmur.cuh"  // REPRO_DEFINE_ERROR_STRING

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kQ = 64;     // dq kernel: query rows a CTA
constexpr int kK = 32;     // dq kernel: keys a tile
constexpr int kKB = 32;    // dkv kernel: keys a CTA
constexpr int kQT = 64;    // dkv kernel: query rows a tile
using bf16 = __nv_bfloat16;

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
// dq kernel (and the rows' lse and delta)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const T* __restrict__ dout, T* __restrict__ dq,
          float* __restrict__ lse_out, float* __restrict__ delta_out, int S,
          int H, int G, int window, long long qsb, long long qss, long long qsh, long long ksb,
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

  // delta: a warp a row, lanes over the features
  for (int r = warp; r < kQ; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < S) {
      const T* orow = o + b * osb + row * oss + h * osh;
      for (int d = lane; d < D; d += 32) acc = fmaf(dos[r * DS + d], widen(orow[d]), acc);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) s_delta[r] = acc;
  }

  // score layout: warp w owns rows 8w .. 8w + 7; lane (rg, kg) = (lane /
  // 8, lane % 8) rows 8w + rg + 4i (i < 2) and keys kg + 8j (j < 4)
  const int rg = lane >> 3;
  const int kg = lane & 7;
  const int srow0 = warp * 8 + rg;

  // pass 1: each row's max and sum over the band
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = k_lo + it * kK;
    __syncthreads();   // the K tile is free
    stage<T, D, DS, kK>(ks, kb, kss, t0, k_hi);
    __syncthreads();
    float s[2][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[2], kv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) qa[i] = ld4(qs + (srow0 + 4 * i) * DS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ld4(ks + (kg + 8 * j) * DS + d);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kv[j].w, s[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + srow0 + 4 * i;
      float mt = kNegInf;
      bool valid[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t0 + kg + 8 * j;
        valid[j] = key < k_hi && key_valid(key, row, S, window);
        s[i][j] = valid[j] ? s[i][j] / sqrt_d : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[i], mt);
      l[i] *= expf(m[i] - m_new);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (valid[j]) l[i] += expf(s[i][j] - m_new);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
    const int r = srow0 + 4 * i;
    if (kg == 0) {
      const float lse = m[i] + logf(fmaxf(l[i], 1e-30f));
      s_lse[r] = lse;
      if (q0 + r < S) {
        const long long at = static_cast<long long>(bh) * S + q0 + r;
        lse_out[at] = lse;
        delta_out[at] = s_delta[r];
      }
    }
  }

  // pass 2: dS and dQ
  using A = AccTile<D, kQ>;
  float acc[A::R][A::C];
#pragma unroll
  for (int i = 0; i < A::R; ++i) {
#pragma unroll
    for (int c = 0; c < A::C; ++c) acc[i][c] = 0.f;
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = k_lo + it * kK;
    __syncthreads();   // the K/V tiles and dS are free; lse is visible
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
// bf16 on the tensor cores (mma.sync m16n8k16: bf16 products, float32 sums)
// ---------------------------------------------------------------------------

constexpr int kTcQ = 64;    // dq: query rows a CTA (4 warps x 16)
constexpr int kTcK = 32;    // dq: keys a tile
constexpr int kTcKB = 64;   // dkv: keys a CTA (4 warps x 16, two feature halves)
constexpr int kTcQT = 32;   // dkv: query rows a tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcDims {
  static constexpr int TS = D + 8;        // padded row (bf16): 16-byte rows,
                                          // conflict-free ldmatrix
  static constexpr int TB = TS * 2;       // its bytes
  static constexpr size_t DQ_BYTES =
      static_cast<size_t>(2 * kTcQ + 2 * kTcK) * TB + kTcQ * 4;
  static constexpr size_t DKV_BYTES =
      static_cast<size_t>(2 * kTcKB + 2 * kTcQT) * TB + 2 * kTcQT * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c (16 x 8) += a (16 x 16, row) * b (16 x 8, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
// (x, y) -> bf16 pairs hi = rn(x, y), lo = rn((x, y) - hi); x in the low
// half (the lower column)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bf2_bits(h);
  lo = bf2_bits(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// rows [p0, p0 + ROWS) of a (., D) bf16 view with row stride rs into a
// (ROWS, TS) bf16 tile, 16 bytes a thread a step; rows at or past lim
// are zero
template <int D, int ROWS, int NT>
__device__ __forceinline__ void stage_tc(bf16* dst, const bf16* g,
                                         long long rs, int p0, int lim) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += NT) {
    const int r = c / CH;
    const int ch = c - r * CH;
    const int p = p0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p < lim) val = *reinterpret_cast<const uint4*>(g + p * rs + ch * 8);
    *reinterpret_cast<uint4*>(dst + r * TcDims<D>::TS + ch * 8) = val;
  }
}

// acc[n] (16 x 8 n-tiles) += A (the warp's 16 rows at a_base) . B^T, B the
// 8 * NT rows at b_base, both (rows, D) tiles in shared memory
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], uint32_t a_base,
                                        uint32_t b_base) {
  constexpr int TB = TcDims<D>::TB;
  const int lane = threadIdx.x & 31;
  const int i = lane >> 3;
  const int r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_base + ((i & 1) * 8 + r) * TB + (kk * 16 + (i >> 1) * 8) * 2);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_base + (np * 16 + (i >> 1) * 8 + r) * TB +
                     (kk * 16 + (i & 1) * 8) * 2);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// A fragments (16 x 16 a k-step) of a C-layout tile, split into bf16 hi
// and lo parts: tile n-tiles 2j and 2j + 1 are k-step j
template <int NT>
__device__ __forceinline__ void to_a_split(const float (&c)[NT][4],
                                           uint32_t (&ah)[NT / 2][4],
                                           uint32_t (&al)[NT / 2][4]) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    split2(c[2 * j][0], c[2 * j][1], ah[j][0], al[j][0]);
    split2(c[2 * j][2], c[2 * j][3], ah[j][1], al[j][1]);
    split2(c[2 * j + 1][0], c[2 * j + 1][1], ah[j][2], al[j][2]);
    split2(c[2 * j + 1][2], c[2 * j + 1][3], ah[j][3], al[j][3]);
  }
}

// acc[n] (16 x NN n-tiles of 8 features from f0) += (ah + al) . B, B the
// 16 * KS rows at b_base of a (rows, D) tile: features f0 ..
template <int D, int KS, int NN>
__device__ __forceinline__ void mma_av(float (&acc)[NN][4],
                                       const uint32_t (&ah)[KS][4],
                                       const uint32_t (&al)[KS][4],
                                       uint32_t b_base, int f0) {
  constexpr int TB = TcDims<D>::TB;
  const int lane = threadIdx.x & 31;
  const int i = lane >> 3;
  const int r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int np = 0; np < NN / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, b_base + (ks * 16 + (i & 1) * 8 + r) * TB +
                       (f0 + np * 16 + (i >> 1) * 8) * 2);
      mma16816(acc[2 * np], ah[ks], b[0], b[1]);
      mma16816(acc[2 * np], al[ks], b[0], b[1]);
      mma16816(acc[2 * np + 1], ah[ks], b[2], b[3]);
      mma16816(acc[2 * np + 1], al[ks], b[2], b[3]);
    }
  }
}

// out[(b, row, head), f0 + feature] = acc / scale for the warp's rows
// row_a (C rows g) and row_a + 8; rows at or past S skipped
template <int D, int NN>
__device__ __forceinline__ void store_tc(const float (&acc)[NN][4], bf16* out,
                                         int b, int S, int NH, int head,
                                         int row_a, int f0, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    if (row >= S) continue;
    bf16* dst = out + ((static_cast<long long>(b) * S + row) * NH + head) * D +
                f0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
          acc[n][2 * half] / scale, acc[n][2 * half + 1] / scale);
    }
  }
}

// dq on the tensor cores: a CTA per (64 query rows, b, h), warp w rows
// 16w .. 16w + 15.  lse is written in base-2 units of the scaled score
// (the dkv kernel below reads it so).
template <int D>
__global__ void __launch_bounds__(128)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ o,
             const bf16* __restrict__ dout, bf16* __restrict__ dq,
             float* __restrict__ lse_out, float* __restrict__ delta_out,
             int S, int H, int G, int window, long long qsb, long long qss,
             long long qsh, long long ksb, long long kss, long long ksh,
             long long vsb, long long vss, long long vsh, long long osb,
             long long oss, long long osh, long long gsb, long long gss,
             long long gsh) {
  constexpr int TS = TcDims<D>::TS;
  constexpr int TB = TcDims<D>::TB;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // (kTcQ, TS)
  bf16* gs = qs + kTcQ * TS;                  // dO (kTcQ, TS)
  bf16* ks = gs + kTcQ * TS;                  // (kTcK, TS)
  bf16* vs = ks + kTcK * TS;                  // (kTcK, TS)
  float* s_delta = reinterpret_cast<float*>(vs + kTcK * TS);   // (kTcQ,)

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / G;
  const int q0 = blockIdx.x * kTcQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_a = q0 + 16 * warp + g;
  const int k_lo = max(0, q0 - window + 1);
  const int k_hi = min(S, q0 + kTcQ);
  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;
  const float c = kLog2e / sqrtf(static_cast<float>(D));

  stage_tc<D, kTcQ, 128>(qs, q + b * qsb + h * qsh, qss, q0, S);
  stage_tc<D, kTcQ, 128>(gs, dout + b * gsb + h * gsh, gss, q0, S);
  __syncthreads();
  // delta of the warp's 16 rows, lanes over the features
  for (int rr = 0; rr < 16; ++rr) {
    const int r = 16 * warp + rr;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < S) {
      const bf16* orow = o + b * osb + row * oss + h * osh;
      for (int d = lane; d < D; d += 32) {
        acc = fmaf(__bfloat162float(gs[r * TS + d]), __bfloat162float(orow[d]),
                   acc);
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) s_delta[r] = acc;
  }
  __syncwarp();
  const float delta[2] = {s_delta[16 * warp + g], s_delta[16 * warp + g + 8]};

  const uint32_t q_base = smem_u32(qs) + 16 * warp * TB;
  const uint32_t g_base = smem_u32(gs) + 16 * warp * TB;
  const uint32_t k_base = smem_u32(ks);
  const uint32_t v_base = smem_u32(vs);

  // pass 1: each row's max and sum (base 2, scaled scores)
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  for (int t0 = k_lo; t0 < k_hi; t0 += kTcK) {
    __syncthreads();   // the K tile is free
    stage_tc<D, kTcK, 128>(ks, kb, kss, t0, k_hi);
    __syncthreads();
    float s[4][4] = {};
    mma_abt<D, 4>(s, q_base, k_base);
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + 8 * n + 2 * t + (e & 1);
        const int row = row_a + 8 * (e >> 1);
        s[n][e] = key < k_hi && key_valid(key, row, S, window) ? s[n][e] * c
                                                                : kNegInf;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      l[i] *= exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (s[n][e] > 0.5f * kNegInf) l[e >> 1] += exp2f(s[n][e] - m[e >> 1]);
      }
    }
  }
  float lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lse[i] = m[i] + log2f(fmaxf(l[i], 1e-30f));
    const int row = row_a + 8 * i;
    if (t == 0 && row < S) {
      const long long at = static_cast<long long>(bh) * S + row;
      lse_out[at] = lse[i];
      delta_out[at] = delta[i];
    }
  }

  // pass 2: dS = P (dP - delta), dQ += dS K
  float acc[D / 8][4] = {};
  for (int t0 = k_lo; t0 < k_hi; t0 += kTcK) {
    __syncthreads();   // the K/V tiles are free
    stage_tc<D, kTcK, 128>(ks, kb, kss, t0, k_hi);
    stage_tc<D, kTcK, 128>(vs, vb, vss, t0, k_hi);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mma_abt<D, 4>(s, q_base, k_base);
    mma_abt<D, 4>(dp, g_base, v_base);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + 8 * n + 2 * t + (e & 1);
        const int i = e >> 1;
        const int row = row_a + 8 * i;
        const float p = key < k_hi && key_valid(key, row, S, window)
                            ? exp2f(fmaf(s[n][e], c, -lse[i]))
                            : 0.f;
        s[n][e] = p * (dp[n][e] - delta[i]);
      }
    }
    uint32_t ah[2][4], al[2][4];
    to_a_split<4>(s, ah, al);
    mma_av<D, 2, D / 8>(acc, ah, al, k_base, 0);
  }
  store_tc<D, D / 8>(acc, dq, b, S, H, h, row_a, 0, sqrtf(static_cast<float>(D)));
}

// dk / dv on the tensor cores: a CTA per (64 keys, b, KV head), 8 warps:
// warp w the keys 16 (w % 4) .. + 15 and the features of half w / 4 (the
// scores of a key group are computed by both of its warps); the G query
// heads and their 32-row query tiles in [j0, j0 + 64 + window - 1)
template <int D>
__global__ void __launch_bounds__(256)
dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse_in,
              const float* __restrict__ delta_in, bf16* __restrict__ dk,
              bf16* __restrict__ dv, int S, int H, int Hk, int G, int window,
              long long qsb, long long qss, long long qsh, long long ksb,
              long long kss, long long ksh, long long vsb, long long vss,
              long long vsh, long long gsb, long long gss, long long gsh) {
  constexpr int TS = TcDims<D>::TS;
  constexpr int TB = TcDims<D>::TB;
  constexpr int NN = D / 16;   // n-tiles of a feature half
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // (kTcKB, TS)
  bf16* vs = ks + kTcKB * TS;                 // (kTcKB, TS)
  bf16* qs = vs + kTcKB * TS;                 // (kTcQT, TS)
  bf16* gs = qs + kTcQT * TS;                 // dO (kTcQT, TS)
  float* s_lse = reinterpret_cast<float*>(gs + kTcQT * TS);   // (kTcQT,)
  float* s_delta = s_lse + kTcQT;                             // (kTcQT,)

  const int bk = blockIdx.y;
  const int b = bk / Hk;
  const int hk = bk - b * Hk;
  const int k0 = blockIdx.x * kTcKB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kgrp = warp & 3;
  const int f0 = (warp >> 2) * (D / 2);
  const int key_a = k0 + 16 * kgrp + g;
  const int q_hi = static_cast<int>(min(static_cast<long long>(S),
                                        static_cast<long long>(k0) + kTcKB +
                                            window - 1));
  const float c = kLog2e / sqrtf(static_cast<float>(D));

  stage_tc<D, kTcKB, 256>(ks, k + b * ksb + hk * ksh, kss, k0, S);
  stage_tc<D, kTcKB, 256>(vs, v + b * vsb + hk * vsh, vss, k0, S);
  const uint32_t k_base = smem_u32(ks) + 16 * kgrp * TB;
  const uint32_t v_base = smem_u32(vs) + 16 * kgrp * TB;
  const uint32_t q_base = smem_u32(qs);
  const uint32_t g_base = smem_u32(gs);

  float acc_k[NN][4] = {}, acc_v[NN][4] = {};
  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const bf16* qb = q + b * qsb + h * qsh;
    const bf16* gb = dout + b * gsb + h * gsh;
    const float* lse_b = lse_in + (static_cast<long long>(b) * H + h) * S;
    const float* delta_b = delta_in + (static_cast<long long>(b) * H + h) * S;
    for (int t0 = k0; t0 < q_hi; t0 += kTcQT) {
      __syncthreads();   // the Q/dO tiles are free
      stage_tc<D, kTcQT, 256>(qs, qb, qss, t0, S);
      stage_tc<D, kTcQT, 256>(gs, gb, gss, t0, S);
      for (int r = threadIdx.x; r < kTcQT; r += 256) {
        const bool in = t0 + r < S;
        s_lse[r] = in ? lse_b[t0 + r] : 0.f;
        s_delta[r] = in ? delta_b[t0 + r] : 0.f;
      }
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      mma_abt<D, 4>(s, k_base, q_base);    // S^T: keys x queries
      mma_abt<D, 4>(dp, v_base, g_base);   // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = 8 * n + 2 * t + (e & 1);
          const int key = key_a + 8 * (e >> 1);
          const float p = key < S && key_valid(key, t0 + qr, S, window)
                              ? exp2f(fmaf(s[n][e], c, -s_lse[qr]))
                              : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - s_delta[qr]);
        }
      }
      {
        uint32_t hi[2][4], lo[2][4];
        to_a_split<4>(s, hi, lo);
        mma_av<D, 2, NN>(acc_v, hi, lo, g_base, f0);   // dV += P^T dO
        to_a_split<4>(dp, hi, lo);
        mma_av<D, 2, NN>(acc_k, hi, lo, q_base, f0);   // dK += dS^T Q
      }
    }
  }
  store_tc<D, NN>(acc_v, dv, b, S, Hk, hk, key_a, f0, 1.f);
  store_tc<D, NN>(acc_k, dk, b, S, Hk, hk, key_a, f0,
                  sqrtf(static_cast<float>(D)));
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, void* dq, void* dk, void* dv, float* lse,
              float* delta, int B, int S, int H, int Hk, int window,
              const long long* st, cudaStream_t stream) {
  using Dm = TcDims<D>;
  auto kq = dq_tc_kernel<D>;
  auto kkv = dkv_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Dm::DQ_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Dm::DKV_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tg = static_cast<const bf16*>(dout);
  const dim3 grid_q((S + kTcQ - 1) / kTcQ, B * H);
  kq<<<grid_q, 128, Dm::DQ_BYTES, stream>>>(
      tq, tk, tv, static_cast<const bf16*>(o), tg, static_cast<bf16*>(dq), lse,
      delta, S, H, H / Hk, window, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((S + kTcKB - 1) / kTcKB, B * Hk);
  kkv<<<grid_kv, 256, Dm::DKV_BYTES, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      S, H, Hk, H / Hk, window, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[12], st[13], st[14]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
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
             float* lse, float* delta, int B, int S, int H, int Hk,
             int window, const long long* st, cudaStream_t s) {
  if (!bf) {
    return launch<float, D>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H,
                            Hk, window, st, s);
  }
  if constexpr (D >= 64) {
    return launch_tc<D>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H, Hk,
                        window, st, s);
  } else {
    return launch<bf16, D>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H,
                           Hk, window, st, s);
  }
}

}  // namespace

// D in {8, 16, 32, 64, 128, 256} (others: cudaErrorInvalidValue, and the
// wrapper refuses them first).  strides: element strides (batch, seq,
// head) of q, k, v, o, then dout.  lse and delta: float32 (B, H, S)
// workspaces the first kernel fills and the second reads.
extern "C" int repro_local_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int S, int H, int Hk, int D, int window, int is_bf16,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long gsb, long long gss, long long gsh,
    void* stream) {
  const long long st[15] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                            vsh, osb, oss, osh, gsb, gss, gsh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  float* l = static_cast<float*>(lse);
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
