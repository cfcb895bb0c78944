// Causal sliding-window (local) attention with grouped KV heads:
// q (B, S, H, D), k/v (B, S, Hk, D), any strides with the feature axis
// contiguous -> out (B, S, H, D) contiguous, in the input type (float32 or
// bfloat16).  Query row i of head h attends over the keys j of KV head
// h / (H / Hk) with j <= i and i - j < window; scores q.k / sqrt(D),
// softmax and the product with V all in float32.
//
// Replaces: repro/kernels/local_attn_kernel.py local_attention_pallas
// (_kernel), which computes the same function per (batch * head) on
// K/V repeated per query group, for S a multiple of its tiles only.
//
// Bound on the H100: operations.  On the gemma3-12b prefill shape (B = 2,
// S = 4096, H = 16, Hk = 8, D = 256, window 1024, bf16) the valid
// (query, key) pairs are ~3.67 M per head, 4 * pairs * D = 120 GFLOP a
// call: 0.12 ms at the bf16 tensor-core rate (989 TFLOP/s), against
// 201 MB of Q, K, V and O, 0.06 ms at 3.35 TB/s.  This kernel runs on the
// CUDA cores in float32 (67 TFLOP/s), so it cannot come near that bound;
// wgmma tiles are the next step.
//
// Design.  The Pallas grid (bh, query block, band tile), which carries
// the softmax state m/l/acc in VMEM across the sequential band axis,
// becomes one CTA per (query tile of kBQ rows, b * h) that walks its own
// band: keys max(0, q_start - window + 1) .. q_start + kBQ - 1, each key
// once (no clamped duplicate tiles to mask).  Each query row is split over
// a group of kTPR = 8 lanes, each holding D / 8 features of q and of the
// float32 accumulator in registers (D = 256: 32 + 32 values).  K and V
// tiles of kBK keys are staged in shared memory as float32 (2 * kBK * D *
// 4 bytes: 64 KB at D = 256, above the 48 KB default, so the launcher
// raises the limit); a lane reads its features as float4 at a 32-byte
// stride of the group, one 128-byte wavefront for the 8 lanes, broadcast
// to the 4 rows of the warp.  A dot product is reduced across the group
// with three xor shuffles.  Per tile the online softmax rescales once:
// m_new = max(m, valid scores), acc *= exp(m - m_new), p = exp(s - m_new)
// for valid keys and 0 for masked ones (so a tile with no valid key adds
// nothing, where the reference adds exp(0) and wipes it later), and the
// end divides by max(l, 1e-30).  Masked scores hold NEG_INF = -1e30.
//
// What sets its time: every (row, key) pair reads the key's D floats of
// K and of V from shared memory, and the 4 rows of a warp read the same
// ones, so shared-memory wavefronts, not FMAs, are the likely limit (an
// estimate from counts, not a trace: ~8 ms of wavefronts against ~2 ms
// of FMAs; measured 16.0 ms on the prefill shape on an H100 SXM at 700 W,
// chip_smoke.py; 32 separate FMA chains per lane in place of one changed
// nothing).  Reusing each
// loaded K/V value across rows, in register tiles or tensor-core
// products, is the next design.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "murmur.cuh"  // REPRO_DEFINE_ERROR_STRING

REPRO_DEFINE_ERROR_STRING()

namespace {

constexpr int kTPR = 8;                 // lanes per query row
constexpr int kBQ = 32;                 // query rows per CTA
constexpr int kBK = 32;                 // keys per shared-memory tile
constexpr int kThreads = kTPR * kBQ;    // 256
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// VEC consecutive floats of shared memory (16-, 8- or 4-byte aligned).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
local_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int S, int H,
                  int G, int window, long long qsb, long long qss,
                  long long qsh, long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh) {
  // each lane owns NCH chunks of VEC features: chunk c of the lane is
  // features [(lane + kTPR * c) * VEC, +VEC)
  constexpr int VEC = (D / kTPR) >= 4 ? 4 : (D / kTPR);
  constexpr int NCH = D / (kTPR * VEC);
  static_assert(NCH * kTPR * VEC == D, "D must be 8 * VEC * NCH");

  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // (kBK, D)
  float* vs = ks + kBK * D;                      // (kBK, D)

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / G;
  const int q_start = blockIdx.x * kBQ;
  const int row = threadIdx.x / kTPR;
  const int lane = threadIdx.x % kTPR;
  const int qpos = q_start + row;
  const bool row_ok = qpos < S;

  float qr[NCH][VEC];
  float acc[NCH][VEC];
  {
    const T* qp = q + b * qsb + static_cast<long long>(row_ok ? qpos : 0) * qss +
                  h * qsh;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qr[c][e] = to_f32(qp[(lane + kTPR * c) * VEC + e]);
        acc[c][e] = 0.f;
      }
    }
  }
  float m = kNegInf;
  float l = 0.f;
  const float sqrt_d = sqrtf(static_cast<float>(D));

  const int k_lo = max(0, q_start - window + 1);
  const int k_hi = min(S, q_start + kBQ);  // exclusive
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int t0 = k_lo; t0 < k_hi; t0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int kk = i / D;
      const int d = i - kk * D;
      const int kpos = t0 + kk;
      float kx = 0.f, vx = 0.f;
      if (kpos < k_hi) {
        kx = to_f32(kb[kpos * kss + d]);
        vx = to_f32(vb[kpos * vss + d]);
      }
      ks[i] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    float s[kBK];
    float m_tile = kNegInf;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float* krow = ks + kk * D;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float kv[VEC];
        load_vec<VEC>(krow + (lane + kTPR * c) * VEC, kv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qr[c][e], kv[e], dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      const int kpos = t0 + kk;
      const bool valid = row_ok && kpos < k_hi && kpos <= qpos &&
                         qpos - kpos < window;
      s[kk] = valid ? dot / sqrt_d : kNegInf;
      m_tile = fmaxf(m_tile, s[kk]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[c][e] *= alpha;
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const int kpos = t0 + kk;
      const bool valid = row_ok && kpos < k_hi && kpos <= qpos &&
                         qpos - kpos < window;
      const float p = valid ? expf(s[kk] - m_new) : 0.f;
      l += p;
      const float* vrow = vs + kk * D;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float vv[VEC];
        load_vec<VEC>(vrow + (lane + kTPR * c) * VEC, vv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[c][e] = fmaf(p, vv[e], acc[c][e]);
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = out + ((static_cast<long long>(b) * S + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        store_out(op + (lane + kTPR * c) * VEC + e, acc[c][e] / denom);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hk, int window, const long long* st,
           cudaStream_t stream) {
  const size_t smem = 2 * kBK * D * sizeof(float);
  auto kernel = local_attn_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, H / Hk, window,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
               int B, int S, int H, int Hk, int window, const long long* st,
               cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, out, B, S, H, Hk, window, st, stream);
    case 16: return launch<T, 16>(q, k, v, out, B, S, H, Hk, window, st, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, Hk, window, st, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, Hk, window, st, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, Hk, window, st, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, S, H, Hk, window, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// D in {8, 16, 32, 64, 128, 256} (others: cudaErrorInvalidValue, and the
// wrapper refuses them first).  strides: element strides (batch, seq,
// head) of q, then k, then v.
extern "C" int repro_local_attention(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int Hk, int D, int window, int is_bf16, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, S, H, Hk, window, st, s);
  }
  return dispatch_d<float>(D, q, k, v, out, B, S, H, Hk, window, st, s);
}
