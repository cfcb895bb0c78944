// Hopper tensor-core helpers shared by the attention kernels
// (local_attn.cu's bf16 forward and local_attn_bwd.cu's bf16 backward):
// cp.async staging into the 128-byte-swizzled tiles that wgmma's
// shared-memory descriptors read, the descriptors themselves and the two
// wgmma forms both kernels issue.
//
// Tile layout: a (ROWS, D) bf16 tile is held as DP / 64 blocks of
// (ROWS, 64), DP = max(D, 64): 128-byte rows, the eight 16-byte chunks of
// row r XOR-swizzled by r % 8.  Every block starts on a 1024-byte
// boundary (the swizzle's period), so a tile's base must too.
//
// The m64n64k16 accumulator (C) layout over a warpgroup's 128 threads:
// thread (warp w of the group, lane) holds d[i], i < 32, at row
// 16 w + lane / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (lane % 4)
// + i % 2.  Two neighbouring 8-column slices of it are, packed to bf16
// pairs, the register A operand of one k16 step (wgmma_pv's a).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !ok (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D>
struct BfTile {
  static constexpr int DP = D < 64 ? 64 : D;   // padded to whole 64-blocks
  static constexpr int NB = DP / 64;           // 64-wide feature blocks
  // byte offset of chunk ch (16 bytes) of row r in a (ROWS, DP) tile
  template <int ROWS>
  static __device__ __forceinline__ uint32_t at(int r, int ch) {
    return (ch >> 3) * (ROWS * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
  }
};

// rows [p0, p0 + ROWS) of a (., D) bf16 view with row stride rs into the
// swizzled tile at dst, by the block's NT threads; rows at or past lim and
// the zero padding of D < 64 are zero-filled by the copy itself
template <int D, int ROWS, int NT>
__device__ __forceinline__ void stage_bf16(uint32_t dst, const bf16* g,
                                           long long rs, int p0, int lim) {
  using T = BfTile<D>;
  constexpr int NCH = T::DP / 8;
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * NCH; c += NT) {
    const int r = c / NCH;
    const int ch = c % NCH;
    const bool ok = p0 + r < lim && ch * 8 < D;
    const bf16* src = ok ? g + (p0 + r) * rs + ch * 8 : g;
    cp_async16(dst + T::template at<ROWS>(r, ch), src, ok);
  }
}

// shared-memory matrix descriptor, 128-byte swizzle; 8-row groups 1024
// bytes apart (both offsets: only one is read for a 64-wide operand)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving register reads or writes across a
// wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x (MUFU, relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 64) += A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major): both operands rows of a swizzled tile, the k16 step's 32 bytes
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, N-major):
// B is 16 rows (the k axis) of a swizzled tile's 64-feature block
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// a bf16 pair as one 32-bit register of an A operand
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

}  // namespace repro
