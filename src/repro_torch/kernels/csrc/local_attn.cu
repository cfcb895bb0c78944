// Causal sliding-window (local) attention with grouped KV heads:
// q (B, S, H, D), k/v (B, S, Hk, D), any strides with the feature axis
// contiguous and 16-byte aligned rows -> out (B, S, H, D) contiguous, in
// the input type (float32 or bfloat16).  Query row i of head h attends
// over the keys j of KV head h / (H / Hk) with j <= i and i - j < window;
// scores q.k / sqrt(D), softmax and the product with V all in float32.
// Where the caller passes a float32 (B, H, S) buffer (training's forward;
// serving passes null), each row's log-sum-exp of its scaled scores goes
// there too, in natural-log units: max + log(sum), from the softmax's own
// running max and sum, so local_attn_bwd.cu needs no pass of its own for
// it.  The write is 4 bytes a row (262 KB at gemma3-12b's training shape).
//
// Replaces: repro/kernels/local_attn_kernel.py local_attention_pallas
// (_kernel), which computes the same function per (batch * head) on
// K/V repeated per query group, for S a multiple of its tiles only.
//
// Bound on the H100: operations.  On the gemma3-12b prefill shape (B = 2,
// S = 4096, H = 16, Hk = 8, D = 256, window 1024, bf16) the valid
// (query, key) pairs are ~3.67 M per head, 4 * pairs * D = 120 GFLOP a
// call: 0.12 ms at the bf16 tensor-core rate (989 TFLOP/s), against
// 201 MB of Q, K, V and O, 0.06 ms at 3.35 TB/s.  In float32 the same
// work is 1.8 ms at the CUDA cores' 67 TFLOP/s.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W) at that
// shape: bf16 0.532 ms (4.4x the bound; SDPA with a band mask 2.29 ms),
// float32 4.97 ms (2.8x its bound; SDPA 14.68 ms).
//
// Both paths walk the Pallas grid's sequential band axis inside one CTA:
// a CTA owns a tile of query rows of one (b, h) and visits the keys
// max(0, q_start - window + 1) .. q_start + rows - 1 once each, in key
// tiles (no clamped duplicate tiles).  Masked keys get p = 0, so a tile
// with no valid key adds nothing, and the end divides by max(l, 1e-30).
// K/V tiles are staged with 16-byte cp.async copies into a two-stage ring,
// so the next tile is in flight while one is computed; rows past S and the
// zero padding of small D are zero-filled by the copy itself.
//
// bf16 path (the prefill; wgmma on the tensor cores, bf16 in, float32
// sums).  128 query rows per CTA in two warpgroups of 64, 64-key tiles;
// at D = 256 64 KB of Q and 2 x 64 KB of K/V, one CTA per SM.  Every
// tile is held as 64-wide feature blocks of 128-byte rows with the
// 128-byte swizzle, the layout wgmma's shared-memory descriptors read
// (the staging, descriptors and wgmma forms are in wgmma.cuh, shared with
// the backward).
//   q.k: wgmma m64n64k16, A (Q) and B (K) both from shared memory; Q is
//   re-read per tile, so the 64 x 256 float32 output accumulator (128
//   registers a thread) fits.  The products are exact in float32.
//   p.v: the score accumulators are re-packed in registers as the A
//   operand (the wgmma C layout of two 8-key slices is its A layout for
//   16 keys), with P split as P_hi = bf16(P), P_lo = bf16(P - P_hi), and
//   both products with V (B from shared memory, feature-major) summed into
//   the same float32 accumulator: the split leaves ~2^-17 of P, where one
//   bf16 product would move each term by up to 2^-9 (V is bf16 already).
//   Softmax on raw scores: p = 2^(s c - m c) with c = log2(e) / sqrt(D) in
//   one FMA and one MUFU ex2; the accumulator is rescaled only when a
//   row's max moved, and masked only in a tile that the band cuts.  A
//   warpgroup skips a tile none of its rows can see.
// float32 path (lm-decode's forward, lm-parity; CUDA cores, since tensor
// cores would change its precision).  64 query rows per CTA, 256 threads,
// 32-key tiles, rows padded by 4 floats (conflict-free float4 reads).
//   q.k: a lane owns 2 rows x 4 keys of the 64 x 32 score tile and reads
//   float4s of Q and K, each reused 4 and 2 times in registers; a row's
//   max and sum reduce over the 8 lanes that share it.  P and the rows'
//   rescale factors go through shared memory.
//   p.v: a lane owns R rows x 8 features of the output (D = 256: 8 x 8),
//   so each staged V value feeds R rows and each P value 8 features.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "murmur.cuh"  // REPRO_DEFINE_ERROR_STRING
#include "wgmma.cuh"

REPRO_DEFINE_ERROR_STRING()

namespace {

using namespace repro;

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ bool key_valid(int key, int row, int k_hi,
                                          int window) {
  return key < k_hi && key <= row && row - key < window;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

// (x, y) -> bf16 pairs hi = rn(x, y) and lo = rn((x, y) - hi); x in the
// low half, as the mma operands order the lower column first
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

constexpr int kBfBQ = 128;              // query rows per CTA: 2 warpgroups
constexpr int kBfBK = 64;               // keys per staged tile
constexpr int kBfStages = 2;

template <int D>
__global__ void __launch_bounds__(256, 1)
attn_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int G, int window, long long qsb, long long qss,
                 long long qsh, long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh) {
  using T = BfTile<D>;
  constexpr int NB = T::NB;
  constexpr int BK = kBfBK;
  constexpr int STAGES = kBfStages;
  constexpr uint32_t TILE = BK * T::DP * 2;

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t s_kv = s_q + kBfBQ * T::DP * 2;   // stage i: K, then V

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / G;
  const int q_start = blockIdx.x * kBfBQ;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int r0 = q_start + 64 * wg;              // the warpgroup's first row
  const int row_a = r0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int row_b = row_a + 8;
  const int k_lo = max(0, q_start - window + 1);
  const int k_hi = min(S, q_start + kBfBQ);
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;
  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;

  stage_bf16<D, kBfBQ, 256>(s_q, q + b * qsb + h * qsh, qss, q_start, S);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) {
      stage_bf16<D, BK, 256>(s_kv + 2 * i * TILE, kb, kss, k_lo + i * BK, k_hi);
      stage_bf16<D, BK, 256>(s_kv + (2 * i + 1) * TILE, vb, vss, k_lo + i * BK,
                        k_hi);
    }
    cp_async_commit();
  }

  float acc[NB][32];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  // p = 2^((s - m) * c) on raw scores s: c folds 1 / sqrt(D) and log2(e)
  const float c = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const uint32_t q_wg = s_q + wg * 64 * 128;

  for (int it = 0; it < n_tiles; ++it) {
    {
      const int nx = it + STAGES - 1;
      if (nx < n_tiles) {
        const int st = nx % STAGES;
        stage_bf16<D, BK, 256>(s_kv + 2 * st * TILE, kb, kss, k_lo + nx * BK,
                          k_hi);
        stage_bf16<D, BK, 256>(s_kv + (2 * st + 1) * TILE, vb, vss,
                          k_lo + nx * BK, k_hi);
      }
      cp_async_commit();
    }
    cp_async_wait<STAGES - 1>();
    fence_proxy_async();   // the copies are visible to wgmma's reads
    __syncthreads();

    const int t0 = k_lo + it * BK;
    const uint32_t s_k = s_kv + 2 * (it % STAGES) * TILE;
    const uint32_t s_v = s_k + TILE;
    const bool live = r0 < S && t0 <= r0 + 63 && t0 + BK - 1 > r0 - window;
    const bool full = t0 + BK <= k_hi && t0 + BK - 1 <= r0 &&
                      r0 + 63 - t0 < window;
    if (live) {
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wg_arrive();
#pragma unroll
      for (int ks = 0; ks < T::DP / 16; ++ks) {
        const uint32_t off = (ks & 3) * 32;
        wgmma_qk(s, gmma_desc(q_wg + (ks >> 2) * (kBfBQ * 128) + off),
                 gmma_desc(s_k + (ks >> 2) * (BK * 128) + off));
      }
      wg_commit();
      wg_wait0();
      fence_regs(s);

      float mt[2] = {kNegInf, kNegInf};
      uint32_t ok = 0xffffffffu;
      if (!full) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = t0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (!key_valid(key, (i & 2) ? row_b : row_a, k_hi, window)) {
            s[i] = kNegInf;
            ok &= ~(1u << i);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
        const float m_new = fmaxf(m[i], mt[i]);
        alpha[i] = ex2((m[i] - m_new) * c);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
      // the running max rarely moves after the first tiles
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NB; ++n) {
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[n][i] *= alpha[(i >> 1) & 1];
        }
      }
      const float mc[2] = {m[0] * c, m[1] * c};
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fmaf(s[4 * n + e], c, -mc[e >> 1]);
          p[e] = (ok >> (4 * n + e)) & 1u ? ex2(x) : 0.f;
          l[e >> 1] += p[e];
        }
        split2(p[0], p[1], ph[n >> 1][(n & 1) * 2], pl[n >> 1][(n & 1) * 2]);
        split2(p[2], p[3], ph[n >> 1][(n & 1) * 2 + 1],
               pl[n >> 1][(n & 1) * 2 + 1]);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) fence_regs(acc[n]);
      wg_arrive();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const uint64_t dv = gmma_desc(s_v + n * (BK * 128) + ks * 2048);
          wgmma_pv(acc[n], ph[ks], dv);
          wgmma_pv(acc[n], pl[ks], dv);
        }
      }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int n = 0; n < NB; ++n) fence_regs(acc[n]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? row_b : row_a;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && (lane & 3) == 0) {
      // natural log of the scaled scores' sum: (m c + log2 l) ln 2
      lse[static_cast<long long>(bh) * S + row] =
          fmaf(m[i], c, log2f(denom)) * kLn2;
    }
    bf16* op = out + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * n + 8 * j + 2 * (lane & 3);
        if (d < D) {
          *reinterpret_cast<__nv_bfloat162*>(op + d) = __floats2bfloat162_rn(
              acc[n][4 * j + 2 * i] / denom, acc[n][4 * j + 2 * i + 1] / denom);
        }
      }
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int S, int H, int Hk, int window,
                const long long* st, cudaStream_t stream) {
  using T = BfTile<D>;
  // + 1024: the kernel aligns the base to the swizzle's 1024-byte period
  const size_t smem =
      static_cast<size_t>(kBfBQ + 2 * kBfStages * kBfBK) * T::DP * 2 + 1024;
  auto kernel = attn_bf16_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + kBfBQ - 1) / kBfBQ, B * H);
  kernel<<<grid, 256, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, H,
      H / Hk, window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32BQ = 64;              // query rows per CTA
constexpr int kF32Stages = 2;
constexpr int kF32BK = 32;              // keys per staged tile
constexpr int kPS = kF32BK + 4;         // row stride of the P tile

template <int D>
struct F32Tile {
  static constexpr int DS = D + 4;                // padded row stride
  static constexpr int CH = D / 4;                // 16-byte chunks a row
  // p.v: a lane owns R rows x C features, in chunks of V
  static constexpr int C = D / 4 < 8 ? D / 4 : 8;
  static constexpr int V = C < 4 ? C : 4;
  static constexpr int NCG = D / C;               // feature groups
  static constexpr int NRG = kF32Threads / NCG;   // row groups
  static constexpr int R = kF32BQ / NRG;
  static_assert(R >= 1 && NRG * R == kF32BQ, "p.v lane layout");
  static constexpr int SMEM_FLOATS =
      (kF32BQ + 2 * kF32Stages * kF32BK) * DS + kF32BQ * kPS + 2 * kF32BQ;
};

template <int D, int ROWS>
__device__ __forceinline__ void stage_f32(float* dst, const float* g,
                                          long long rs, int p0, int lim) {
  using T = F32Tile<D>;
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * T::CH; c += kF32Threads) {
    const int r = c / T::CH;
    const int ch = c % T::CH;
    const bool ok = p0 + r < lim;
    const float* src = ok ? g + (p0 + r) * rs + ch * 4 : g;
    cp_async16(smem_addr(dst + r * T::DS + ch * 4), src, ok);
  }
}

template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float (&o)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
    o[0] = *p;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                float* __restrict__ lse, int S, int H, int G, int window, long long qsb, long long qss,
                long long qsh, long long ksb, long long kss, long long ksh,
                long long vsb, long long vss, long long vsh) {
  using T = F32Tile<D>;
  constexpr int DS = T::DS;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);       // (kF32BQ, DS)
  float* kvs = qs + kF32BQ * DS;                     // stage i: K, then V
  float* ps = kvs + 2 * kF32Stages * kF32BK * DS;       // (kF32BQ, kPS)
  float* s_alpha = ps + kF32BQ * kPS;                // (kF32BQ,)
  float* s_l = s_alpha + kF32BQ;                     // (kF32BQ,)

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / G;
  const int q_start = blockIdx.x * kF32BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int k_lo = max(0, q_start - window + 1);
  const int k_hi = min(S, q_start + kF32BQ);
  const int n_tiles = (k_hi - k_lo + kF32BK - 1) / kF32BK;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  stage_f32<D, kF32BQ>(qs, q + b * qsb + h * qsh, qss, q_start, S);
  stage_f32<D, kF32BK>(kvs, kb, kss, k_lo, k_hi);
  stage_f32<D, kF32BK>(kvs + kF32BK * DS, vb, vss, k_lo, k_hi);
  cp_async_commit();

  // q.k layout: warp w owns rows 8w .. 8w + 7; lane (rg, kg) = (lane / 8,
  // lane % 8) rows 8w + rg + 4i (i < 2) and keys kg + 8j (j < 4)
  const int rg = lane >> 3;
  const int kg = lane & 7;
  const int srow0 = (tid >> 5) * 8 + rg;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};               // this lane's share of each row sum
  // p.v layout: feature group cg, row group og; rows og + NRG * i,
  // features (cg + NCG * c) * V + e
  const int cg = tid % T::NCG;
  const int og = tid / T::NCG;
  float acc[T::R][T::C];
#pragma unroll
  for (int i = 0; i < T::R; ++i) {
#pragma unroll
    for (int c = 0; c < T::C; ++c) acc[i][c] = 0.f;
  }
  const float sqrt_d = sqrtf(static_cast<float>(D));

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {              // into the stage freed last time
      float* nk = kvs + 2 * ((it + 1) % kF32Stages) * kF32BK * DS;
      stage_f32<D, kF32BK>(nk, kb, kss, k_lo + (it + 1) * kF32BK, k_hi);
      stage_f32<D, kF32BK>(nk + kF32BK * DS, vb, vss,
                           k_lo + (it + 1) * kF32BK, k_hi);
    }
    cp_async_commit();
    cp_async_wait<kF32Stages - 1>();
    __syncthreads();

    const int t0 = k_lo + it * kF32BK;
    const float* ks = kvs + 2 * (it % kF32Stages) * kF32BK * DS;
    const float* vs = ks + kF32BK * DS;
    {
      float s[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float qa[2][4], kv[4][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ld_vec<4>(qs + (srow0 + 4 * i) * DS + d, qa[i]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ld_vec<4>(ks + (kg + 8 * j) * DS + d, kv[j]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[i][j] = fmaf(qa[i][e], kv[j][e], s[i][j]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = srow0 + 4 * i;
        const int qpos = q_start + row;
        bool valid[4];
        float mt = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          valid[j] = key_valid(t0 + kg + 8 * j, qpos, k_hi, window);
          s[i][j] = valid[j] ? s[i][j] / sqrt_d : kNegInf;
          mt = fmaxf(mt, s[i][j]);
        }
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
        const float m_new = fmaxf(m[i], mt);
        const float alpha = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
          l[i] += p;
          ps[row * kPS + kg + 8 * j] = p;
        }
        if (kg == 0) s_alpha[row] = alpha;
      }
    }
    __syncthreads();   // P and the rescale factors are in shared memory

#pragma unroll
    for (int i = 0; i < T::R; ++i) {
      const float a = s_alpha[og + T::NRG * i];
#pragma unroll
      for (int c = 0; c < T::C; ++c) acc[i][c] *= a;
    }
#pragma unroll 2
    for (int kk = 0; kk < kF32BK; kk += 4) {
      float p[T::R][4];
#pragma unroll
      for (int i = 0; i < T::R; ++i) {
        ld_vec<4>(ps + (og + T::NRG * i) * kPS + kk, p[i]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vs + (kk + e) * DS;
#pragma unroll
        for (int c = 0; c < T::C / T::V; ++c) {
          float vv[T::V];
          ld_vec<T::V>(vrow + (cg + T::NCG * c) * T::V, vv);
#pragma unroll
          for (int i = 0; i < T::R; ++i) {
#pragma unroll
            for (int x = 0; x < T::V; ++x) {
              acc[i][c * T::V + x] = fmaf(p[i][e], vv[x], acc[i][c * T::V + x]);
            }
          }
        }
      }
    }
    __syncthreads();   // the stage, P and the factors are free again
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
    if (kg == 0) {
      s_l[srow0 + 4 * i] = l[i];
      const int qpos = q_start + srow0 + 4 * i;
      if (lse != nullptr && qpos < S) {
        lse[static_cast<long long>(bh) * S + qpos] =
            m[i] + logf(fmaxf(l[i], 1e-30f));
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::R; ++i) {
    const int row = og + T::NRG * i;
    const int qpos = q_start + row;
    if (qpos >= S) continue;
    const float denom = fmaxf(s_l[row], 1e-30f);
    float* op = out + ((static_cast<long long>(b) * S + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < T::C / T::V; ++c) {
      float* dst = op + (cg + T::NCG * c) * T::V;
      if constexpr (T::V == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            acc[i][4 * c] / denom, acc[i][4 * c + 1] / denom,
            acc[i][4 * c + 2] / denom, acc[i][4 * c + 3] / denom);
      } else {
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[i][2 * c] / denom, acc[i][2 * c + 1] / denom);
      }
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int H, int Hk, int window,
               const long long* st, cudaStream_t stream) {
  const size_t smem = F32Tile<D>::SMEM_FLOATS * sizeof(float);
  auto kernel = attn_f32_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + kF32BQ - 1) / kF32BQ, B * H);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, H,
      H / Hk, window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(bool is_bf16, const void* q, const void* k, const void* v,
           void* out, float* lse, int B, int S, int H, int Hk, int window,
           const long long* st, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(q, k, v, out, lse, B, S, H, Hk, window, st,
                                  stream)
                 : launch_f32<D>(q, k, v, out, lse, B, S, H, Hk, window, st,
                                 stream);
}

}  // namespace

// D in {8, 16, 32, 64, 128, 256} (others: cudaErrorInvalidValue, and the
// wrapper refuses them first).  strides: element strides (batch, seq,
// head) of q, then k, then v; every row must start 16-byte aligned (the
// wrapper copies a view that does not).  lse: null, or a float32 (B, H, S)
// buffer that receives each row's log-sum-exp of its scaled scores.
extern "C" int repro_local_attention(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int H, int Hk, int D, int window, int is_bf16, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 8: return launch<8>(bf, q, k, v, out, l, B, S, H, Hk, window, st, s);
    case 16: return launch<16>(bf, q, k, v, out, l, B, S, H, Hk, window, st, s);
    case 32: return launch<32>(bf, q, k, v, out, l, B, S, H, Hk, window, st, s);
    case 64: return launch<64>(bf, q, k, v, out, l, B, S, H, Hk, window, st, s);
    case 128: return launch<128>(bf, q, k, v, out, l, B, S, H, Hk, window, st, s);
    case 256: return launch<256>(bf, q, k, v, out, l, B, S, H, Hk, window, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
